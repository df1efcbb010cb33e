"""Servable models (counterpart of ``GatewayModel`` in
``sheeprl_tpu/serve/model.py``).

A :class:`GatewayModel` wraps one :class:`~sheeprl_tpu_torch.evals.service.EvalPolicy`
with what serving adds: a version stamped on every response, a per-row state
contract for the batcher's server-side recurrent state, and the device the
batcher draws its noise on. Loading from a checkpoint or a registry ref
(``load_gateway_model``) waits for the checkpoint and config-engine port.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import torch

from sheeprl_tpu_torch.device import resolve_device

__all__ = ["GatewayModel"]


class GatewayModel:
    """One servable policy: ``act`` + ``init_state_rows`` + ``version``."""

    def __init__(self, policy, version: int, algo: str, env_id: str, device=None):
        self.policy = policy
        self.version = int(version)
        self.algo = str(algo)
        self.env_id = str(env_id)
        self.device = resolve_device(device)

    @classmethod
    def from_params(
        cls,
        params: Dict[str, Mapping[str, Any]],
        cfg,
        observation_space: Mapping[str, Any],
        actions_dim: Sequence[int],
        is_continuous: bool,
        *,
        device=None,
        version: int = 0,
        plain_cell: bool = False,
    ) -> "GatewayModel":
        """A DreamerV2 policy from the port's state dicts
        ``{"world_model": ..., "actor": ...}`` (``convert.py`` turns the JAX
        package's param trees into them)."""
        from sheeprl_tpu_torch.algos.dreamer_v2.evaluate import dreamer_v2_eval_policy

        if str(cfg.algo.name) != "dreamer_v2":
            raise NotImplementedError(f"only dreamer_v2 is served by the port, not {cfg.algo.name}")
        dev = resolve_device(device)
        policy = dreamer_v2_eval_policy(
            cfg, params, observation_space, actions_dim, is_continuous, device=dev, plain_cell=plain_cell
        )
        return cls(policy, version=version, algo="dreamer_v2", env_id=str(cfg.env.id), device=dev)

    def act(self, obs, state, generator: torch.Generator):
        """Batched obs/state in, ``(actions, new_state)`` out."""
        return self.policy.act(obs, state, generator)

    def init_state_rows(self, n: int):
        """Fresh recurrent state for ``n`` rows (None: stateless family)."""
        if self.policy.init_state is None:
            return None
        return self.policy.init_state(int(n))
