"""Recurrent PPO: an LSTM policy trained on sequence chunks of the rollout."""
