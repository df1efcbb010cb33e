"""A2C: PPO's agent and loop with the unclipped policy gradient."""
