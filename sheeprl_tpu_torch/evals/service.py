"""The frozen-policy evaluation service (counterpart of
``sheeprl_tpu/evals/service.py``).

- A per-family *builder* (:func:`register_eval_builder`) turns checkpoint
  state into one batched :class:`EvalPolicy`.
- ``n`` episodes run in parallel, one env per episode seeded ``seed0 + i``,
  stepped as one sync vector pool with one batched ``policy.act`` a step.
  Each episode's return freezes at its first ``terminated | truncated``;
  a finished row keeps stepping (autoreset) from a fresh recurrent state.
- Every act draws its noise from one ``torch.Generator`` seeded ``seed0`` on
  the policy's device, one draw a pool step (the JAX runner splits a
  ``PRNGKey(seed0)`` once a step). The serving batcher draws from a
  generator of the same seed in the same way, so
  :func:`~sheeprl_tpu_torch.serve.gateway.rescore_through_gateway` gives
  these returns bit for bit.
- Artifacts: a versioned ``eval.json`` with the JAX package's keys, and an
  append to the model registry (:mod:`sheeprl_tpu_torch.evals.registry`).
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sheeprl_tpu_torch.utils import dotdict

__all__ = [
    "EVAL_SCHEMA",
    "EvalPolicy",
    "EvalService",
    "eval_settings",
    "evaluate_checkpoint",
    "find_eval_builder",
    "fresh_state",
    "iqm",
    "make_eval_pool",
    "policy_version_of",
    "probe_spaces",
    "register_eval_builder",
    "registered_eval_builders",
    "run_eval_entrypoint",
    "run_parallel_episodes",
]

#: schema tag stamped on every eval.json: the JAX package's
EVAL_SCHEMA = "sheeprl_tpu/eval/v1"

#: shipped defaults of the ``eval`` config group, also the fallbacks for a run config without the group
_EVAL_DEFAULTS: Dict[str, Any] = {
    "episodes": 10,
    "seed0": 1000,
    "vectorization": None,  # None: the run's env.vectorization / env.sync_env
    "max_steps": 0,  # 0: the env's own time limit
    "every_n_steps": 0,  # 0: in-run eval off
    "inrun_episodes": 2,
    "write_json": True,
    "write_registry": True,
    "registry_dir": "logs/registry",
}

_EVAL_BUILDERS: Dict[str, Callable] = {}


def register_eval_builder(algorithms: Sequence[str]):
    """Decorator: register an eval-policy builder for algorithm names. A
    builder is ``(fabric, cfg, state, observation_space, action_space,
    device=None) -> EvalPolicy``; ``device`` overrides ``fabric.device``."""

    def decorator(fn: Callable) -> Callable:
        for name in algorithms:
            _EVAL_BUILDERS[str(name)] = fn
        return fn

    return decorator


def find_eval_builder(algo_name: str) -> Optional[Callable]:
    return _EVAL_BUILDERS.get(str(algo_name))


def registered_eval_builders() -> List[str]:
    return sorted(_EVAL_BUILDERS)


def _builder_for(algo_name: str) -> Callable:
    """The registered builder (the entrypoints registered first), or raise."""
    import sheeprl_tpu_torch

    sheeprl_tpu_torch.register_algorithms()
    builder = find_eval_builder(algo_name)
    if builder is None:
        raise RuntimeError(
            f"No eval-policy builder registered for '{algo_name}'. Registered: {registered_eval_builders()}"
        )
    return builder


@dataclass
class EvalPolicy:
    """A frozen agent as the service and the gateway see it.

    ``act(obs, state, generator) -> (real_actions, new_state)``: ``obs`` a
    batched dict of numpy arrays (leading axis = rows), ``real_actions`` a
    numpy array, ``state`` the family's recurrent state (a dict of tensors
    with the rows on axis 0, or None) and ``generator`` the
    ``torch.Generator`` the step draws its noise from. ``init_state(n)``
    builds fresh state for ``n`` rows (None for stateless families).
    ``device`` is where the policy runs and where its generator lives.
    """

    act: Callable[[Dict[str, np.ndarray], Any, Any], Tuple[np.ndarray, Any]]
    init_state: Optional[Callable[[int], Any]] = None
    device: Optional[torch.device] = None


def eval_settings(cfg) -> dotdict:
    """The run's ``eval`` knobs with the shipped defaults filled in."""
    merged = dict(_EVAL_DEFAULTS)
    try:
        user = cfg.get("eval", {}) or {}
    except AttributeError:
        user = {}
    merged.update(dict(user))
    return dotdict(merged)


def iqm(values: Sequence[float]) -> float:
    """Interquartile mean: the mean of the middle half of the returns
    (``floor(n / 4)`` trimmed at each end)."""
    x = np.sort(np.asarray(values, dtype=np.float64))
    n = x.size
    if n == 0:
        return float("nan")
    k = int(np.floor(n * 0.25))
    trimmed = x[k : n - k] if n - 2 * k > 0 else x
    return float(trimmed.mean())


def probe_spaces(cfg):
    """``(observation_space, action_space)`` of one throwaway env built as
    training builds them (no log dir: the probe never records video)."""
    from sheeprl_tpu_torch.envs.vector import make_eval_env

    env = make_eval_env(cfg, None)
    try:
        return env.observation_space, env.action_space
    finally:
        env.close()


def policy_version_of(checkpoint: Optional[str]) -> Optional[int]:
    """The checkpoint's training step from its manifest, if resolvable."""
    if not checkpoint:
        return None
    from sheeprl_tpu_torch.ckpt.manifest import CheckpointCorruptedError, read_manifest

    try:
        step = read_manifest(str(checkpoint)).get("step")
    except (OSError, CheckpointCorruptedError):
        return None
    return int(step) if step is not None else None


# ---------------------------------------------------------------------------
# the episode runner
# ---------------------------------------------------------------------------


def fresh_state(init_state: Callable[[int], Any], n: int):
    """Fresh state for ``n`` rows as the serving batcher builds it: one row
    from ``init_state(1)``, repeated. A family whose fresh state goes through
    its models (DreamerV3's prior) then gives every row the same bits,
    whatever the batch."""
    row = init_state(1)
    if row is None:
        return None
    return {k: v.expand(n, *v.shape[1:]).clone() for k, v in row.items()}


def _reset_rows(state, init_state: Callable[[int], Any], keep: np.ndarray):
    """Rows where ``keep`` is False get fresh state; the others keep theirs."""
    n = keep.shape[0]
    fresh = fresh_state(init_state, n)
    out = {}
    for k, cur in state.items():
        mask = torch.as_tensor(keep, device=cur.device).reshape((n,) + (1,) * (cur.dim() - 1))
        out[k] = torch.where(mask, cur, fresh[k])
    return out


def run_parallel_episodes(
    policy: EvalPolicy,
    pool,
    seeds: Sequence[int],
    generator: torch.Generator,
    single_action_shape: Tuple[int, ...],
    max_steps: int = 0,
    dry_run: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Step the whole episode batch until every episode has ended once.
    Returns ``(returns, lengths)`` (float64 and int64, one entry an episode).
    Episode i's return accumulates only while it is alive."""
    n = len(seeds)
    obs, _ = pool.reset(seed=[int(s) for s in seeds])
    state = fresh_state(policy.init_state, n) if policy.init_state is not None else None
    returns = np.zeros(n, dtype=np.float64)
    lengths = np.zeros(n, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    steps = 0
    while alive.any():
        real_actions, state = policy.act(obs, state, generator)
        real_actions = np.asarray(real_actions).reshape((n,) + tuple(single_action_shape))
        obs, rewards, terminated, truncated, _ = pool.step(real_actions)
        done = np.logical_or(np.asarray(terminated).reshape(n), np.asarray(truncated).reshape(n))
        returns += np.asarray(rewards, dtype=np.float64).reshape(n) * alive
        lengths += alive.astype(np.int64)
        alive &= ~done
        steps += 1
        if dry_run or (max_steps and steps >= max_steps):
            break
        if done.any() and alive.any() and state is not None:
            # a finished row re-enters through the pool's autoreset: its rewards no longer count, but a
            # stale state would make the batch depend on which rows ended first
            state = _reset_rows(state, policy.init_state, ~done)
    return returns, lengths


def make_eval_pool(cfg, log_dir: Optional[str], n: int, seed0: int, prefix: str = "test"):
    """One env per episode, wrapped as the train-time factory wraps its
    envs, seeded ``seed0 + i``, in the configured vector env
    (``eval.vectorization`` overrides the run's vectorization for this pool
    only)."""
    from sheeprl_tpu_torch.envs.vector import vectorize_thunks
    from sheeprl_tpu_torch.utils.env import make_env

    settings = eval_settings(cfg)
    pool_cfg = cfg
    if settings.vectorization is not None:
        pool_cfg = dotdict(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
        pool_cfg.env.vectorization = settings.vectorization
    seeds = [int(seed0) + i for i in range(int(n))]
    thunks = [
        make_env(pool_cfg, seeds[i], 0, log_dir if i == 0 else None, prefix, vector_env_idx=i) for i in range(int(n))
    ]
    return vectorize_thunks(thunks, pool_cfg, env_seeds_list=seeds), seeds


def _config_hash_of(cfg, checkpoint: Optional[str]) -> Optional[str]:
    """The manifest's hash where the checkpoint has one (the eval-time config
    has another run name and fabric, and a JAX run's targets were renamed:
    it would hash differently), else the hash of the config in hand."""
    from sheeprl_tpu_torch.evals.registry import manifest_config_hash, registry_config_hash

    if checkpoint:
        found = manifest_config_hash(str(checkpoint))
        if found:
            return found
    return registry_config_hash(cfg)


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------


class EvalService:
    """Run the frozen-greedy protocol for one policy and write its artifacts."""

    def __init__(self, cfg, log_dir: Optional[str] = None, fabric=None):
        self.cfg = cfg
        self.log_dir = log_dir
        self.fabric = fabric
        self.settings = eval_settings(cfg)

    def run(
        self,
        policy: EvalPolicy,
        checkpoint: Optional[str] = None,
        episodes: Optional[int] = None,
        seed0: Optional[int] = None,
        prefix: str = "test",
        write_json: Optional[bool] = None,
        write_registry: Optional[bool] = None,
        policy_version: Optional[int] = None,
    ) -> Dict[str, Any]:
        cfg, settings = self.cfg, self.settings
        n = int(episodes if episodes is not None else settings.episodes)
        if n < 1:
            raise ValueError(f"eval.episodes must be >= 1, got {n}")
        seed0 = int(seed0 if seed0 is not None else settings.seed0)
        generator = torch.Generator(device=policy.device or "cpu").manual_seed(seed0)
        pool, seeds = make_eval_pool(cfg, self.log_dir, n, seed0, prefix=prefix)
        try:
            shape = tuple(pool.single_action_space.shape)
            returns, lengths = run_parallel_episodes(
                policy,
                pool,
                seeds,
                generator,
                shape,
                max_steps=int(settings.max_steps or 0),
                dry_run=bool(cfg.get("dry_run", False)),
            )
        finally:
            pool.close()

        if policy_version is None:
            policy_version = policy_version_of(checkpoint)
        result: Dict[str, Any] = {
            "schema": EVAL_SCHEMA,
            "algo": str(cfg.algo.name),
            "env": str(cfg.env.id),
            "run": str(cfg.get("run_name", "")),
            "checkpoint": os.path.abspath(str(checkpoint)) if checkpoint else None,
            "config_hash": _config_hash_of(cfg, checkpoint),
            "policy_version": policy_version,
            "protocol": "frozen-greedy",
            "n": n,
            "seed0": seed0,
            "seeds": [int(s) for s in seeds],
            "returns": [float(r) for r in returns],
            "lengths": [int(x) for x in lengths],
            "mean": float(np.mean(returns)),
            "std": float(np.std(returns)),
            "iqm": iqm(returns),
            "min": float(np.min(returns)),
            "max": float(np.max(returns)),
        }
        if write_json is None:
            write_json = bool(settings.write_json)
        if write_json and self.log_dir:
            result["path"] = self._write_json(result)
        if write_registry is None:
            write_registry = bool(settings.write_registry)
        if write_registry and result["checkpoint"]:
            self._append_registry(result)
        return result

    def _write_json(self, result: Dict[str, Any]) -> str:
        """An atomic ``eval.json`` that never overwrites (then ``eval_<k>.json``)."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "eval.json")
        k = 1
        while os.path.exists(path):
            path = os.path.join(self.log_dir, f"eval_{k}.json")
            k += 1
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(result, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path

    def _append_registry(self, result: Dict[str, Any]) -> None:
        from sheeprl_tpu_torch.evals.registry import ModelRegistry, RegistryError

        record = {
            "run": result["run"] or os.path.basename(os.path.dirname(result["checkpoint"])),
            "checkpoint": result["checkpoint"],
            "env": result["env"],
            "algo": result["algo"],
            "config_hash": result["config_hash"],
            "policy_version": result["policy_version"],
            "protocol": result["protocol"],
            "seed0": result["seed0"],
            "metrics": {"mean": result["mean"], "std": result["std"], "iqm": result["iqm"], "n": result["n"]},
        }
        try:
            ModelRegistry(str(self.settings.registry_dir)).append(record)
        except (RegistryError, OSError) as exc:  # the registry is an artifact, not a gate
            warnings.warn(f"model-registry append failed: {exc}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def run_eval_entrypoint(fabric, cfg, state: Dict[str, Any]) -> Dict[str, Any]:
    """The body of every ``algos/*/evaluate.py`` entrypoint: logger, space
    probe, builder, service run, metric logging. Returns the result."""
    from sheeprl_tpu_torch.utils.logger import create_tensorboard_logger

    logger, log_dir = create_tensorboard_logger(cfg)
    fabric.logger = logger
    if logger is not None:
        logger.log_hyperparams(cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg))
    builder = _builder_for(cfg.algo.name)
    observation_space, action_space = probe_spaces(cfg)
    policy = builder(fabric, cfg, state, observation_space, action_space)
    result = EvalService(cfg, log_dir=log_dir, fabric=fabric).run(policy, checkpoint=cfg.get("checkpoint_path"))
    fabric.print(
        f"Test - {result['n']} episodes: mean={result['mean']:.2f} std={result['std']:.2f} iqm={result['iqm']:.2f}"
    )
    if logger is not None:
        if cfg.metric.log_level > 0:
            logger.log_metrics({"Test/cumulative_reward": result["mean"]}, 0)
        logger.close()
    return result


def single_device_fabric_cfg(cfg, accelerator: str = "auto") -> dotdict:
    """The fabric an evaluation or a server runs on: one device, the run's precision."""
    run_fabric = cfg.get("fabric", {}) or {}
    return dotdict(
        {
            "_target_": "sheeprl_tpu_torch.fabric.Fabric",
            "devices": 1,
            "num_nodes": 1,
            "strategy": "auto",
            "accelerator": accelerator,
            "precision": run_fabric.get("precision", "32-true"),
            "callbacks": [],
        }
    )


def evaluate_checkpoint(
    checkpoint_path: str,
    episodes: Optional[int] = None,
    seed0: Optional[int] = None,
    write_json: bool = False,
    write_registry: Optional[bool] = None,
    registry_dir: Optional[str] = None,
    capture_video: bool = False,
    vectorization: Optional[str] = None,
    state: Optional[Dict[str, Any]] = None,
    device=None,
) -> Dict[str, Any]:
    """A checkpoint directory in, an eval result out: the run's persisted
    config supplies the agent, on one device (``cuda`` unless ``device``
    says otherwise). ``state`` replaces the checkpoint's (a publication)."""
    from sheeprl_tpu_torch.cli import load_run_config
    from sheeprl_tpu_torch.config.instantiate import instantiate
    from sheeprl_tpu_torch.device import resolve_device

    cfg, log_dir = load_run_config(checkpoint_path)
    cfg.env.capture_video = bool(capture_video)
    settings = eval_settings(cfg)
    if vectorization is not None:
        settings.vectorization = vectorization
    if registry_dir is not None:
        settings.registry_dir = registry_dir
    cfg["eval"] = settings
    cfg.fabric = single_device_fabric_cfg(cfg, resolve_device(device).type)
    fabric = instantiate(cfg.fabric)
    if state is None:
        from sheeprl_tpu_torch.ckpt.resume import read_checkpoint

        state = read_checkpoint(checkpoint_path, with_rb=False)
    builder = _builder_for(cfg.algo.name)
    observation_space, action_space = probe_spaces(cfg)
    policy = builder(fabric, cfg, state, observation_space, action_space)
    service = EvalService(cfg, log_dir=log_dir if write_json else None, fabric=fabric)
    return service.run(
        policy,
        checkpoint=checkpoint_path,
        episodes=episodes,
        seed0=seed0,
        write_json=write_json,
        write_registry=write_registry,
    )
