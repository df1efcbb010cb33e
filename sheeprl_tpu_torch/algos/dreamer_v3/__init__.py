"""DreamerV3: the agent and its player (which DreamerV2 shares), the training run and serving."""
