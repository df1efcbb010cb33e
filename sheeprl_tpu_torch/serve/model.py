"""Servable models (counterpart of ``GatewayModel`` in
``sheeprl_tpu/serve/model.py``).

A :class:`GatewayModel` wraps one DreamerV1, V2 or V3 (or Plan2Explore task
actor), SAC, DroQ, SAC-AE, PPO, A2C or PPO-recurrent
:class:`~sheeprl_tpu_torch.evals.service.EvalPolicy`
with what serving adds: a version stamped on every response, a per-row state
contract for the batcher's server-side recurrent state, and the device the
batcher draws its noise on.

:func:`load_gateway_model` builds one from a checkpoint directory written
by the port or by the JAX package, or from a ``registry:best:`` ref;
:class:`PolicySwapper` rebuilds one from each new version of a policy
publication channel and swaps it in (``load_gateway_model`` and
``PolicySwapper`` in ``sheeprl_tpu/serve/model.py``).
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Any, Callable, Dict, Mapping, Sequence, Tuple

import torch

from sheeprl_tpu_torch.device import resolve_device

__all__ = ["BUILDER_ALGOS", "STATELESS_ALGOS", "GatewayModel", "PolicySwapper", "load_gateway_model"]

#: the families served without a recurrent state, built by their registered eval builder (the action bounds
#: come from the action space, which ``GatewayModel.from_params`` does not take)
STATELESS_ALGOS = ("sac", "sac_decoupled", "droq", "sac_ae", "ppo", "ppo_decoupled", "a2c")
#: the families a checkpoint is served through their registered eval builder: the stateless ones and
#: PPO-recurrent, whose LSTM state (``c``, ``h``, the previous actions, ``is_first``) the batcher keeps per row
BUILDER_ALGOS = STATELESS_ALGOS + ("ppo_recurrent",)


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
        """A DreamerV1, V2 or V3 policy (``cfg.algo.name``'s family:
        Plan2Explore's phases serve their family's player) from the port's
        state dicts ``{"world_model": ..., "actor": ...}`` (``convert.py``
        turns the JAX package's param trees into them)."""
        import importlib

        from sheeprl_tpu_torch.evals.builders import family_of

        algo = str(cfg.algo.name)
        family = family_of(algo)
        build = getattr(importlib.import_module(f"sheeprl_tpu_torch.algos.{family}.evaluate"), f"{family}_eval_policy")
        dev = resolve_device(device)
        policy = build(cfg, params, observation_space, actions_dim, is_continuous, device=dev, plain_cell=plain_cell)
        return cls(policy, version=version, algo=algo, env_id=str(cfg.env.id), device=dev)

    def act(self, obs, state, generator: torch.Generator):
        """Batched obs/state in, ``(actions, new_state)`` out."""
        return self.policy.act(obs, state, generator)

    def init_state_rows(self, n: int):
        """Fresh recurrent state for ``n`` rows (None: stateless family), one
        row repeated as the eval service builds it."""
        if self.policy.init_state is None:
            return None
        from sheeprl_tpu_torch.evals.service import fresh_state

        return fresh_state(self.policy.init_state, int(n))


def load_gateway_model(
    checkpoint_ref: str, device=None, plain_cell: bool = False, registry_dir: str = "logs/registry"
) -> Tuple[GatewayModel, Any, Any, Any]:
    """A servable DreamerV1, V2, V3, SAC, DroQ, SAC-AE, PPO, A2C or PPO-recurrent model from a checkpoint directory or
    a ``registry:best:<algo>:<env id>`` ref (resolved in ``registry_dir``),
    on ``device`` (``cuda`` when None). Every array of the model state is
    checksummed against the manifest (a replay buffer saved beside it is not
    read); the architecture, and its compute dtype (``fabric.precision``: a
    ``bf16-mixed`` run serves in bf16 on its f32 parameters), come from the
    run's persisted ``.hydra/config.yaml``, the spaces from one probe env, the version from
    the manifest's step. Returns ``(model, cfg, observation_space,
    action_space)``: the rest is what a swap rebuilds against."""
    from sheeprl_tpu_torch.ckpt import read_checkpoint, read_manifest
    from sheeprl_tpu_torch.cli import load_run_config
    from sheeprl_tpu_torch.evals.builders import actions_dim_of, serving_params
    from sheeprl_tpu_torch.evals.registry import resolve_checkpoint_ref
    from sheeprl_tpu_torch.evals.service import policy_version_of, probe_spaces

    dev = resolve_device(device)
    checkpoint_path, _record = resolve_checkpoint_ref(checkpoint_ref, registry_dir)
    framework = read_manifest(checkpoint_path).get("framework")
    if framework not in (None, "torch"):
        raise ValueError(f"checkpoint written by an unknown framework {framework!r}")
    cfg, _log_dir = load_run_config(checkpoint_path)
    cfg.env.capture_video = False
    state = read_checkpoint(checkpoint_path, with_rb=False)
    observation_space, action_space = probe_spaces(cfg)
    algo, version = str(cfg.algo.name), policy_version_of(checkpoint_path) or 0
    if algo in BUILDER_ALGOS:
        from sheeprl_tpu_torch.evals.service import _builder_for

        policy = _builder_for(algo)(None, cfg, state, observation_space, action_space, device=dev)
        model = GatewayModel(policy, version=version, algo=algo, env_id=str(cfg.env.id), device=dev)
    else:
        actions_dim, is_continuous = actions_dim_of(action_space)
        model = GatewayModel.from_params(
            serving_params(state, algo),
            cfg,
            observation_space.spaces,
            actions_dim,
            is_continuous,
            device=dev,
            version=version,
            plain_cell=plain_cell,
        )
    model.checkpoint = os.path.abspath(checkpoint_path)
    return model, cfg, observation_space, action_space


class PolicySwapper:
    """Watcher thread: newly published policy versions → swaps.

    Polls a :class:`~sheeprl_tpu_torch.plane.publish.PolicyPoller` channel
    for versions past the serving model's, rebuilds the policy with the
    family's eval builder on the serving model's device, and calls
    ``swap_fn(new_model)``. The rebuild runs on this thread, off the
    dispatch path; the batcher takes the new model at its next batch, and a
    batch in flight keeps its own reference to the old one until its actions
    are on the host. A torn or bad publication is skipped and the old model
    keeps serving (it is tried again at each poll); ``swaps`` counts the swaps
    made, ``refused`` holds the versions refused.
    """

    def __init__(
        self,
        policy_root: str,
        cfg,
        observation_space,
        action_space,
        swap_fn: Callable[[GatewayModel], Any],
        base_model: GatewayModel,
        poll_interval_s: float = 0.2,
    ):
        from sheeprl_tpu_torch.evals.service import _builder_for
        from sheeprl_tpu_torch.plane.publish import PolicyPoller

        self._poller = PolicyPoller(str(policy_root), poll_interval_s=poll_interval_s)
        self._cfg = cfg
        self._obs_space = observation_space
        self._act_space = action_space
        self._swap_fn = swap_fn
        self._builder = _builder_for(cfg.algo.name)
        self._algo = base_model.algo
        self._env_id = base_model.env_id
        self._device = base_model.device
        self._last_version = int(base_model.version)
        self._stop = threading.Event()
        self.swaps = 0
        self.refused: set = set()
        self._thread = threading.Thread(target=self._run, name="serve-policy-swapper", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._poller.poll_interval_s):
            self.poll_once()

    def poll_once(self) -> bool:
        """One poll (also the tests' hook): swap in a newer valid version.
        Returns True on a swap."""
        latest = self._poller.latest_version()
        if latest is None or latest <= self._last_version:
            return False
        state = self._poller.load(latest)
        try:
            if state is None:
                raise ValueError(f"publication {latest} is torn or fails its checksums")
            policy = self._builder(None, self._cfg, state, self._obs_space, self._act_space, device=self._device)
        except Exception as exc:  # a bad publication never takes serving down
            if latest not in self.refused:
                self.refused.add(int(latest))
                warnings.warn(f"policy swap to version {latest} refused; the serving model stays: {exc}")
            return False
        model = GatewayModel(policy, version=latest, algo=self._algo, env_id=self._env_id, device=self._device)
        self._swap_fn(model)
        self._last_version = int(latest)
        self.swaps += 1
        return True

    def close(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout=timeout)
