"""DroQ helpers (counterpart of ``sheeprl_tpu/algos/droq/utils.py``): SAC's metric allow-list."""

from sheeprl_tpu_torch.algos.sac.utils import AGGREGATOR_KEYS

__all__ = ["AGGREGATOR_KEYS"]
