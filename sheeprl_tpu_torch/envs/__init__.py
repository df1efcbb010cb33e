"""Environments (counterpart of ``sheeprl_tpu/envs``): spaces, the dummy envs, wrappers and the sync vector env, with no gymnasium on the card path."""
