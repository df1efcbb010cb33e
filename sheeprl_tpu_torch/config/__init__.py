"""Config composition (counterpart of ``sheeprl_tpu/config``): the
mini-Hydra engine over the port's YAML tree, ``_target_`` instantiation,
and the YAML subset both read and write through."""

from sheeprl_tpu_torch.config.engine import (
    MISSING,
    SEARCH_PATH_ENV_VAR,
    available_options,
    build_search_path,
    compose,
    to_yaml,
    yaml_load,
)

__all__ = [
    "MISSING",
    "SEARCH_PATH_ENV_VAR",
    "available_options",
    "build_search_path",
    "compose",
    "to_yaml",
    "yaml_load",
]
