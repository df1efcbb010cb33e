"""DreamerV2: the agent's serving path."""
