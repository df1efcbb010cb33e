"""The policy-serving gateway: one model behind one request batcher
(counterpart of ``ServeGateway`` in ``sheeprl_tpu/serve/gateway.py``).

Hot-swap watching, the shared-memory ring transport and the ops surface
(tracing, SLO engine, ``/metrics``) are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from sheeprl_tpu_torch.serve.batcher import RequestBatcher
from sheeprl_tpu_torch.serve.client import LocalServeClient

__all__ = ["ServeGateway"]


class ServeGateway:
    """One serving endpoint: coalesced batched inference over one model."""

    def __init__(self, model, max_batch: int = 64, deadline_s: float = 0.010, seed: int = 42):
        self.batcher = RequestBatcher(model, max_batch=max_batch, deadline_s=deadline_s, seed=seed)

    def client(self, client_id: Optional[str] = None) -> LocalServeClient:
        """An in-process serve client."""
        return LocalServeClient(self.batcher, client_id=client_id)

    def status(self) -> Dict[str, Any]:
        model = self.batcher.model
        return {
            "algo": model.algo,
            "env": model.env_id,
            "device": str(model.device),
            "model_version": int(model.version),
            **self.batcher.stats(),
        }

    def drain(self, timeout: float = 30.0) -> bool:
        """Finish in-flight requests, then stop; later requests raise
        :class:`~sheeprl_tpu_torch.serve.batcher.ServeClosed`."""
        return self.batcher.drain(timeout=timeout)

    def close(self) -> None:
        self.batcher.close()
