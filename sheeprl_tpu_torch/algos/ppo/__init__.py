"""PPO: the agent, its losses, the on-policy training run and its evaluation."""
