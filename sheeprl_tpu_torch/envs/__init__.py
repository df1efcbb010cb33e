"""Environments (counterpart of ``sheeprl_tpu/envs``): spaces, the dummy envs, wrappers, the vector envs (serial and
the shared-memory worker pool) and the device envs, with no gymnasium on the card path."""
