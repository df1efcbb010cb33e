"""sheeprl_tpu_torch: the PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

The JAX package ``sheeprl_tpu`` is the reference; this package imports
neither it nor JAX. It trains DreamerV1, DreamerV2 and DreamerV3 and
Plan2Explore on each (exploration, then finetuning; discrete or continuous
actions, float32) from its CLI (``python -m sheeprl_tpu_torch exp=dreamer_v3
...``: config engine and YAML tree, sync vector envs, replay, manifest
checkpoints), evaluates checkpoints (``cli.evaluation``, the model registry
in ``evals/``) and serves any of their policies (``cli.serve``,
``serve/``). The LayerNorm-GRU step of DreamerV2 and V3 is a hand-written
CUDA kernel (``kernels/csrc/hafner_gru.cu``); DreamerV1's flax GRU cell is
PyTorch operations, as in the JAX package, which has no kernel for it. Entry points run on ``cuda`` unless the
caller asks for the CPU (``device="cpu"``, ``fabric.accelerator=cpu``).

Importing the package loads no torch (``resolve_device`` is loaded on first
use), so a spawned serve client that imports the ring transport stays light.
"""

__all__ = ["register_algorithms", "resolve_device"]

#: the modules whose entrypoints ``register_algorithms`` registers: training, then evaluation
ALGORITHM_MODULES = (
    "sheeprl_tpu_torch.algos.dreamer_v1.dreamer_v1",
    "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2",
    "sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv2.p2e_dv2_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv3.p2e_dv3_finetuning",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_exploration",
    "sheeprl_tpu_torch.algos.p2e_dv1.p2e_dv1_finetuning",
    "sheeprl_tpu_torch.algos.dreamer_v1.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v2.evaluate",
    "sheeprl_tpu_torch.algos.dreamer_v3.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv2.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv3.evaluate",
    "sheeprl_tpu_torch.algos.p2e_dv1.evaluate",
)


def register_algorithms() -> None:
    """Import the ported entrypoints so that they register (idempotent)."""
    import importlib

    for module in ALGORITHM_MODULES:
        importlib.import_module(module)


def __getattr__(name):
    if name == "resolve_device":
        from sheeprl_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
