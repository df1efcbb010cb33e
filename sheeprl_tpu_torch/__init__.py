"""sheeprl_tpu_torch: the PyTorch/CUDA port of sheeprl_tpu for NVIDIA Hopper.

The JAX package ``sheeprl_tpu`` is the reference; this package imports
neither it nor JAX. Today it serves a DreamerV2 policy: ``ServeGateway`` →
``RequestBatcher`` → ``GatewayModel`` → the DV2 player step, whose
LayerNorm-GRU step is a hand-written CUDA kernel
(``kernels/csrc/hafner_gru.cu``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from sheeprl_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
