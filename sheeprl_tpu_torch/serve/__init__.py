"""Policy serving: the request batcher, in-process and ring clients, the
shared-memory ring, servable models and the gateway.

The names below load on first use, so a spawned ring client that imports
``serve.rings`` and ``serve.client`` loads no torch.
"""

import importlib

_EXPORTS = {
    "ActSlabRing": "sheeprl_tpu_torch.serve.rings",
    "GatewayModel": "sheeprl_tpu_torch.serve.model",
    "LocalServeClient": "sheeprl_tpu_torch.serve.client",
    "PolicySwapper": "sheeprl_tpu_torch.serve.model",
    "RequestBatcher": "sheeprl_tpu_torch.serve.batcher",
    "RingServeClient": "sheeprl_tpu_torch.serve.client",
    "ServeClosed": "sheeprl_tpu_torch.serve.batcher",
    "ServeGateway": "sheeprl_tpu_torch.serve.gateway",
    "ServeRequestError": "sheeprl_tpu_torch.serve.batcher",
    "rescore_through_gateway": "sheeprl_tpu_torch.serve.gateway",
    "run_serve_entrypoint": "sheeprl_tpu_torch.serve.gateway",
    "serve_settings": "sheeprl_tpu_torch.serve.gateway",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
