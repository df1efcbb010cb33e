"""Servable models (counterpart of ``GatewayModel`` in
``sheeprl_tpu/serve/model.py``).

A :class:`GatewayModel` wraps one DreamerV2 or DreamerV3 :class:`~sheeprl_tpu_torch.evals.service.EvalPolicy`
with what serving adds: a version stamped on every response, a per-row state
contract for the batcher's server-side recurrent state, and the device the
batcher draws its noise on.

:func:`load_gateway_model` builds one from a checkpoint directory written
by the port or by the JAX package (``load_gateway_model`` in
``sheeprl_tpu/serve/model.py``). Registry refs and the swap watcher are not
ported (ROADMAP queue A item 6c).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

from sheeprl_tpu_torch.device import resolve_device

__all__ = ["GatewayModel", "load_gateway_model"]

#: parts of the port's training world model that a serving build has not
_TRAINING_ONLY = ("cnn_decoder.", "mlp_decoder.", "reward_model.", "continue_model.")


class GatewayModel:
    """One servable policy: ``act`` + ``init_state_rows`` + ``version``."""

    def __init__(self, policy, version: int, algo: str, env_id: str, device=None, checkpoint=None):
        self.policy = policy
        self.version = int(version)
        self.algo = str(algo)
        self.env_id = str(env_id)
        self.device = resolve_device(device)
        self.checkpoint = checkpoint

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
        """A DreamerV2 or DreamerV3 policy (``cfg.algo.name``) from the
        port's state dicts ``{"world_model": ..., "actor": ...}``
        (``convert.py`` turns the JAX package's param trees into them)."""
        algo = str(cfg.algo.name)
        if algo == "dreamer_v2":
            from sheeprl_tpu_torch.algos.dreamer_v2.evaluate import dreamer_v2_eval_policy as build
        elif algo == "dreamer_v3":
            from sheeprl_tpu_torch.algos.dreamer_v3.evaluate import dreamer_v3_eval_policy as build
        else:
            raise NotImplementedError(f"only dreamer_v2 and dreamer_v3 are served by the port, not {algo}")
        dev = resolve_device(device)
        policy = build(cfg, params, observation_space, actions_dim, is_continuous, device=dev, plain_cell=plain_cell)
        return cls(policy, version=version, algo=algo, env_id=str(cfg.env.id), device=dev)

    def act(self, obs, state, generator: torch.Generator):
        """Batched obs/state in, ``(actions, new_state)`` out."""
        return self.policy.act(obs, state, generator)

    def init_state_rows(self, n: int):
        """Fresh recurrent state for ``n`` rows (None: stateless family)."""
        if self.policy.init_state is None:
            return None
        return self.policy.init_state(int(n))


def _serving_params(state: Dict[str, Any], framework: Any, algo: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"world_model", "actor"}`` state dicts of a serving build from a
    checkpoint's tree: the port's own layout (``framework == "torch"``), or
    the JAX package's ``agent.params`` through ``convert_dreamer_v2`` or
    ``convert_dreamer_v3`` (``algo``)."""
    if framework == "torch":
        agent = state["agent"]
        return {
            "world_model": {
                k: torch.as_tensor(v) for k, v in agent["world_model"].items() if not k.startswith(_TRAINING_ONLY)
            },
            "actor": {k: torch.as_tensor(v) for k, v in agent["actor"].items()},
        }
    if framework is not None:
        raise ValueError(f"checkpoint written by an unknown framework {framework!r}")
    from sheeprl_tpu_torch.convert import convert_dreamer_v2, convert_dreamer_v3

    convert = convert_dreamer_v3 if algo == "dreamer_v3" else convert_dreamer_v2
    params, _skipped = convert(state["agent"]["params"])
    return params


def load_gateway_model(checkpoint_path: str, device=None, plain_cell: bool = False) -> Tuple[GatewayModel, Any, Any, Any]:
    """A servable DreamerV2 or DreamerV3 model from a checkpoint directory, on ``device``
    (``cuda`` when None). Every array of the model state is checksummed
    against the manifest (a replay buffer saved beside it is not read);
    the architecture comes from the run's persisted ``.hydra/config.yaml``,
    the spaces from one probe env, the version from the manifest's step.
    Returns ``(model, cfg, observation_space, action_space)``."""
    from sheeprl_tpu_torch.ckpt import read_checkpoint, read_manifest
    from sheeprl_tpu_torch.cli import load_run_config
    from sheeprl_tpu_torch.evals.builders import actions_dim_of
    from sheeprl_tpu_torch.evals.service import policy_version_of, probe_spaces

    dev = resolve_device(device)
    if str(checkpoint_path).startswith("registry:"):
        raise NotImplementedError("registry refs are not ported yet (ROADMAP queue A item 6c)")
    manifest = read_manifest(checkpoint_path)
    cfg, _log_dir = load_run_config(checkpoint_path)
    cfg.env.capture_video = False
    state = read_checkpoint(checkpoint_path, with_rb=False)
    observation_space, action_space = probe_spaces(cfg)
    actions_dim, is_continuous = actions_dim_of(action_space)
    model = GatewayModel.from_params(
        _serving_params(state, manifest.get("framework"), str(cfg.algo.name)),
        cfg,
        observation_space.spaces,
        actions_dim,
        is_continuous,
        device=dev,
        version=policy_version_of(checkpoint_path) or 0,
        plain_cell=plain_cell,
    )
    model.checkpoint = os.path.abspath(checkpoint_path)
    return model, cfg, observation_space, action_space
