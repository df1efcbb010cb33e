"""DreamerV1: the agent, its losses, the training run and its evaluation."""
