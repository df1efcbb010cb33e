"""Command-line entry points (counterpart of ``sheeprl_tpu/cli.py``).

    python -m sheeprl_tpu_torch exp=dreamer_v2 env=dummy fabric.accelerator=cpu ...
    sheeprl-tpu-torch-eval checkpoint_path=<ckpt dir | registry:best:<algo>:<env id>>
    sheeprl-tpu-torch-serve checkpoint_path=<ckpt dir | registry:best:...> serve.duration_s=60
    sheeprl-tpu-torch-model-manager checkpoint_path=<ckpt dir> model_name=<name>

``run`` composes the config from the port's YAML tree, resolves
``checkpoint.resume_from`` (``latest``, a run dir or a ``ckpt_*`` dir) and
merges the checkpointed run's config, builds the
:class:`~sheeprl_tpu_torch.fabric.Fabric` and calls the registered
entrypoint; ``-m`` runs a sweep's jobs one after another in the process.
``evaluation`` scores a checkpoint with the eval service, ``serve`` serves
it through the gateway, ``registration`` copies it into the filesystem
model registry. ``fabric.accelerator=auto`` means ``cuda``; the CPU runs
only when ``fabric.accelerator=cpu`` asks for it.
"""

from __future__ import annotations

import importlib
import os
import sys
import warnings
from typing import Any, Optional, Sequence, Tuple

from sheeprl_tpu_torch.config.engine import compose, expand_multirun, yaml_load
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.config.yamlite import load as yaml_read
from sheeprl_tpu_torch.utils import dotdict
from sheeprl_tpu_torch.utils.metric import MetricAggregator
from sheeprl_tpu_torch.utils.registry import find_algorithm, find_evaluation, registered_algorithm_names
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import print_config

__all__ = [
    "check_configs",
    "eval_algorithm",
    "evaluation",
    "load_exploration_cfg",
    "load_run_config",
    "registration",
    "resume_from_checkpoint",
    "run",
    "run_algorithm",
    "serve",
]

_JAX_PREFIX, _PORT_PREFIX = "sheeprl_tpu.", "sheeprl_tpu_torch."


def _port_targets(node: Any) -> Any:
    """``_target_: sheeprl_tpu.X`` and ``cls: sheeprl_tpu.X`` (a JAX run's
    config) → ``sheeprl_tpu_torch.X``."""
    if isinstance(node, dict):
        return {
            k: (_PORT_PREFIX + v[len(_JAX_PREFIX):])
            if k in ("_target_", "cls") and isinstance(v, str) and v.startswith(_JAX_PREFIX)
            else _port_targets(v)
            for k, v in node.items()
        }
    if isinstance(node, list):
        return [_port_targets(v) for v in node]
    return node


def load_run_config(ckpt_path: str) -> Tuple[dotdict, str]:
    """The persisted config of the run that wrote a checkpoint
    (``<log_dir>/checkpoint/ckpt_*`` with ``<log_dir>/.hydra/config.yaml``,
    or a ``config.yaml`` beside the checkpoint), read with the port's YAML
    reader, targets moved to the port. Returns ``(cfg, log_dir)``."""
    ckpt_abs = os.path.abspath(ckpt_path)
    log_dir = os.path.dirname(os.path.dirname(ckpt_abs))
    candidates = [
        (os.path.join(log_dir, ".hydra", "config.yaml"), log_dir),
        (os.path.join(os.path.dirname(ckpt_abs), "config.yaml"), os.path.dirname(ckpt_abs)),
    ]
    for cfg_path, base in candidates:
        if os.path.isfile(cfg_path):
            with open(cfg_path) as f:
                return dotdict(_port_targets(yaml_read(f.read()))), base
    raise RuntimeError(
        f"Cannot use checkpoint {ckpt_path}: missing persisted config at any of {[c for c, _ in candidates]}"
    )


def _set_existing_path(cfg, key: str, value, allow_new: bool = False) -> bool:
    """Set dotted ``key`` only where its parent exists (and the key too,
    unless ``allow_new``); never invents intermediate nodes."""
    node = cfg
    parts = key.split(".")
    for p in parts[:-1]:
        if not isinstance(node, dict) or p not in node or not isinstance(node[p], dict):
            return False
        node = node[p]
    if not isinstance(node, dict) or (parts[-1] not in node and not allow_new):
        return False
    node[parts[-1]] = value
    return True


def resume_from_checkpoint(cfg, overrides: Optional[Sequence[str]] = None) -> Any:
    """The checkpointed run's config, with the runtime keys (``root_dir``,
    ``run_name``, ``fabric``, ``checkpoint.resume_from``) of this one and
    every explicit ``key=value`` override of this command re-applied; an
    override naming a key the stored config lacks raises."""
    ckpt_path = cfg.checkpoint.resume_from
    old_cfg, _ = load_run_config(ckpt_path)
    if old_cfg.env.id != cfg.env.id:
        raise ValueError(
            f"This experiment is run with a different environment from the one of the checkpoint: "
            f"got {cfg.env.id}, the checkpoint was trained on {old_cfg.env.id}"
        )
    if old_cfg.algo.name != cfg.algo.name:
        raise ValueError(
            f"This experiment is run with a different algorithm from the one of the checkpoint: "
            f"got {cfg.algo.name}, the checkpoint was trained with {old_cfg.algo.name}"
        )
    old_cfg.checkpoint.resume_from = ckpt_path
    old_cfg.root_dir = cfg.root_dir
    old_cfg.run_name = cfg.run_name
    old_cfg.fabric = cfg.fabric
    reapplied, ignored, dropped = [], [], []
    for o in overrides or []:
        if o.startswith("~") or "=" not in o:
            ignored.append(o)
            continue
        key, value = o.split("=", 1)
        added = key.startswith("+")
        key = key.lstrip("+")
        if key in ("checkpoint.resume_from", "root_dir", "run_name") or key.startswith("fabric"):
            continue
        if key == "exp" or ("." not in key and isinstance(old_cfg.get(key, None), dict)):
            ignored.append(o)
            continue
        if not _set_existing_path(old_cfg, key, yaml_load(value), allow_new=added):
            dropped.append(o)
            continue
        reapplied.append(o)
    if reapplied or ignored:
        warnings.warn(
            "resume_from_checkpoint: the restored config defines the experiment; "
            f"re-applied {reapplied}, ignored {ignored} (deletions and group selections cannot be re-applied)"
        )
    if dropped:
        raise ValueError(
            f"resume_from_checkpoint: these overrides name keys absent from the checkpointed config: {dropped}"
        )
    return old_cfg


def check_configs(cfg) -> None:
    """The algorithm is registered; the strategy, devices and precision are
    the port's (checked again by the Fabric)."""
    algo_name = cfg.algo.name
    entry = find_algorithm(algo_name)
    if entry is None:
        raise RuntimeError(
            f"Given the algorithm named '{algo_name}', no algorithm has been found to be imported. "
            f"Available algorithms: {registered_algorithm_names()}"
        )
    if entry["decoupled"]:
        raise NotImplementedError(f"{algo_name}: the decoupled entrypoints are ROADMAP queue A item 5")
    model_axis = int((cfg.get("parallel", None) or {}).get("model_axis", 1) or 1)
    if model_axis > 1:
        raise NotImplementedError(f"parallel.model_axis={model_axis}: parameter sharding is ROADMAP queue A item 7")
    if int((cfg.get("plane", None) or {}).get("num_players", 0) or 0) > 0:
        raise NotImplementedError("plane.num_players>0: the actor–learner plane is ROADMAP queue A item 6f")


def _prune_metric_keys(cfg, algo_module: str) -> None:
    """Drop the aggregator keys the algorithm never updates (its utils
    module's ``AGGREGATOR_KEYS``)."""
    try:
        keys = getattr(importlib.import_module(f"{algo_module.rsplit('.', 1)[0]}.utils"), "AGGREGATOR_KEYS", None)
    except ModuleNotFoundError:
        keys = None
    if keys is None:
        return
    metrics_cfg = cfg.metric.get("aggregator", {}).get("metrics", {})
    for name in list(metrics_cfg.keys()):
        if name not in keys:
            metrics_cfg.pop(name)


#: the env keys a P2E finetuning run takes from its exploration run
EXPLORATION_ENV_KEYS = ("frame_stack", "screen_size", "action_repeat", "grayscale", "clip_rewards",
                        "frame_stack_dilation", "max_episode_steps", "reward_as_observation")


def load_exploration_cfg(cfg) -> dotdict:
    """P2E finetuning: the persisted config of the exploration run that wrote
    ``checkpoint.exploration_ckpt_path`` (the port's or the JAX package's);
    its env keys (EXPLORATION_ENV_KEYS) are copied into ``cfg``. A different
    ``env.id`` raises."""
    ckpt_path = cfg.checkpoint.get("exploration_ckpt_path", None)
    if _missing(ckpt_path):
        raise ValueError(
            "P2E finetuning requires checkpoint.exploration_ckpt_path pointing at an exploration-phase checkpoint"
        )
    exploration_cfg, _ = load_run_config(ckpt_path)
    if exploration_cfg.env.id != cfg.env.id:
        raise ValueError(
            "This experiment is run with a different environment from the one of the exploration you want to "
            f"finetune. Got '{cfg.env.id}', but the environment used during exploration was "
            f"{exploration_cfg.env.id}. Set properly the environment for finetuning the experiment."
        )
    for k in EXPLORATION_ENV_KEYS:
        if k in exploration_cfg.env:
            cfg.env[k] = exploration_cfg.env[k]
    return exploration_cfg


def run_algorithm(cfg) -> Any:
    """Registry lookup → Fabric → entrypoint (a P2E finetuning entrypoint also
    gets its exploration run's config, ``load_exploration_cfg``); the
    checkpoint subsystem is set up before and drained after; the metric aggregator's and the
    timer's on/off switches follow ``metric.log_level`` for the run and are
    put back after it. Returns the entrypoint's result, a dict result with
    the run's checkpoint stats (bytes, write and blocked time) added as
    ``checkpoint_stats``."""
    from sheeprl_tpu_torch.ckpt import setup_checkpoint, teardown_checkpoint

    entry = find_algorithm(cfg.algo.name)
    module = importlib.import_module(entry["module"])
    entrypoint = getattr(module, entry["entrypoint"])
    kwargs = {}
    if "finetuning" in cfg.algo.name and "p2e" in entry["module"]:
        kwargs["exploration_cfg"] = load_exploration_cfg(cfg)
    fabric = instantiate(cfg.fabric)
    _prune_metric_keys(cfg, entry["module"])
    switches = MetricAggregator.disabled, timer.disabled
    MetricAggregator.disabled = cfg.metric.log_level == 0 or len(
        cfg.metric.get("aggregator", {}).get("metrics", {})
    ) == 0
    timer.disabled = cfg.metric.log_level == 0 or cfg.metric.get("disable_timer", False)
    setup_checkpoint(cfg)
    try:
        result = fabric.launch(entrypoint, cfg, **kwargs)
    finally:
        stats = teardown_checkpoint()
        MetricAggregator.disabled, timer.disabled = switches
    if isinstance(result, dict):
        result["checkpoint_stats"] = stats
    return result


def run(args: Optional[Sequence[str]] = None) -> Any:
    """Train entrypoint: compose, resume merge, checks, run. With ``-m`` (or
    ``--multirun``) comma-separated override values expand to their
    cartesian product (``config.engine.expand_multirun``) and the jobs run
    one after another in this process; their results come back as a list."""
    import sheeprl_tpu_torch

    overrides = list(args) if args is not None else sys.argv[1:]
    if "-m" in overrides or "--multirun" in overrides:
        overrides = [o for o in overrides if o not in ("-m", "--multirun")]
        jobs = expand_multirun(overrides)
        if len(jobs) > 1:
            results = []
            for i, job in enumerate(jobs):
                print(f"[multirun] job {i + 1}/{len(jobs)}: {' '.join(job)}", flush=True)
                results.append(run(job))
            return results
    cfg = compose("config", overrides=overrides)
    sheeprl_tpu_torch.register_algorithms()
    if cfg.checkpoint.resume_from:
        from sheeprl_tpu_torch.ckpt import resolve_resume_from

        cfg.checkpoint.resume_from = resolve_resume_from(cfg)
        cfg = resume_from_checkpoint(cfg, overrides)
    if cfg.metric.log_level > 0:
        print_config(cfg)
    check_configs(cfg)
    return run_algorithm(cfg)


def _missing(value) -> bool:
    return not value or value == "???"


def eval_algorithm(cfg) -> Any:
    """Read the checkpoint (every array checksummed; no replay buffer) and
    call the algorithm's registered evaluation on a one-device Fabric."""
    from sheeprl_tpu_torch.ckpt.resume import read_checkpoint

    entry = find_evaluation(cfg.algo.name)
    if entry is None:
        raise RuntimeError(f"Given the algorithm named '{cfg.algo.name}', no evaluation function has been found")
    entrypoint = getattr(importlib.import_module(entry["module"]), entry["entrypoint"])
    cfg.fabric.devices = 1
    fabric = instantiate(cfg.fabric)
    state = read_checkpoint(cfg.checkpoint_path, with_rb=False)
    return fabric.launch(entrypoint, cfg, state)


def evaluation(args: Optional[Sequence[str]] = None) -> Any:
    """Eval entrypoint: compose ``eval_config`` (``checkpoint_path`` a
    checkpoint directory or ``registry:best:<algo>:<env id>``), re-read the
    run's persisted config, force one env and one device, keep the run's
    seed, and score the checkpoint with the eval service (``eval.*``: the
    composed group, shipped defaults for missing keys). Returns the result."""
    import numpy as np

    import sheeprl_tpu_torch
    from sheeprl_tpu_torch.evals.registry import resolve_checkpoint_ref
    from sheeprl_tpu_torch.evals.service import eval_settings, single_device_fabric_cfg

    sheeprl_tpu_torch.register_algorithms()
    overrides = list(args) if args is not None else sys.argv[1:]
    eval_cfg = compose("eval_config", overrides=overrides, allow_missing=("checkpoint_path",))
    ckpt_path = eval_cfg.get("checkpoint_path")
    if _missing(ckpt_path):
        raise ValueError("You must specify the checkpoint path: checkpoint_path=/path/to/ckpt")
    settings = eval_settings(eval_cfg)
    ckpt_path, record = resolve_checkpoint_ref(ckpt_path, str(settings.registry_dir))
    if record is not None:
        print(
            f"[registry] best {record.get('algo')} on {record.get('env')}: {ckpt_path} "
            f"(mean {record.get('metrics', {}).get('mean')})"
        )
    cfg, log_dir = load_run_config(ckpt_path)
    cfg["eval"] = settings
    cfg.run_name = os.path.join(os.path.basename(log_dir), f"evaluation_{np.random.randint(0, 2**16)}")
    cfg.env.num_envs = 1
    capture = bool((eval_cfg.get("env", None) or {}).get("capture_video", False))
    if capture and not any(o.split("=", 1)[0].lstrip("+") == "env.capture_video" for o in overrides):
        # eval_config's default asks for a video of episode 0, which the port cannot record (it needs moviepy);
        # asked for on the command line, the env factory raises instead
        warnings.warn("env.capture_video: the port records no video; the evaluation runs without it")
        capture = False
    cfg.env.capture_video = capture
    cfg.fabric = single_device_fabric_cfg(cfg, (eval_cfg.get("fabric", None) or {}).get("accelerator", "auto"))
    cfg.checkpoint_path = ckpt_path
    return eval_algorithm(cfg)


def serve(args: Optional[Sequence[str]] = None) -> Any:
    """Serving entrypoint: compose ``serve_config`` and serve the checkpoint
    (or ``registry:best:`` ref) through the gateway, with request
    coalescing, the shared-memory ring, hot-swap and a SIGTERM drain
    (``serve.gateway.run_serve_entrypoint``). Returns the final status."""
    import sheeprl_tpu_torch
    from sheeprl_tpu_torch.serve.gateway import run_serve_entrypoint

    sheeprl_tpu_torch.register_algorithms()
    overrides = list(args) if args is not None else sys.argv[1:]
    serve_cfg = compose("serve_config", overrides=overrides, allow_missing=("checkpoint_path",))
    if _missing(serve_cfg.get("checkpoint_path")):
        raise ValueError("You must specify the checkpoint path: checkpoint_path=/path/to/ckpt")
    return run_serve_entrypoint(serve_cfg)


def registration(args: Optional[Sequence[str]] = None) -> int:
    """Model-registration entrypoint: copy a training checkpoint into the
    filesystem model registry (``utils.model_manager``) as the next version
    of ``model_name``. Returns the version."""
    from sheeprl_tpu_torch.utils.model_manager import ModelManager

    overrides = list(args) if args is not None else sys.argv[1:]
    cfg = compose("model_manager_config", overrides=overrides, allow_missing=("checkpoint_path", "model_name"))
    if _missing(cfg.get("checkpoint_path")):
        raise ValueError("You must specify the checkpoint path: checkpoint_path=/path/to/ckpt")
    if _missing(cfg.get("model_name")):
        raise ValueError("You must specify the model name: model_name=my_agent")
    manager = ModelManager(cfg.get("registry_dir", "models"))
    version = manager.register_model(cfg.model_name, cfg.checkpoint_path, description=cfg.get("description", ""))
    print(f"Registered '{cfg.model_name}' v{version} in {manager.registry_dir}")
    return version
