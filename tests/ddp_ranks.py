"""The rank functions of the data-parallel tests: what each spawned rank
runs (``sheeprl_tpu_torch.parallel.spawn``). The ranks are fresh
interpreters that import this module, so it imports neither JAX nor the
JAX package: the tests compute the JAX side in their own process and hand
the ranks numpy inputs. Each function takes the rank's Fabric first and
returns numpy results (they cross a pipe)."""

from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np
import torch

torch.set_num_threads(1)

MODULES = ("world_model", "actor", "critic", "target_critic")


def foreign_modules() -> List[str]:
    """The JAX-side modules this process has loaded (none, for a rank)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu"))


def _numpy(sd) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def collectives(fabric, trees: List[Dict[str, Any]], grads: List[List[np.ndarray]]) -> Dict[str, Any]:
    """The Fabric's four collectives and the in-step ones on this rank's
    tree (``trees[rank]``, ``grads[rank]``)."""
    from sheeprl_tpu_torch.obs.dist import comms

    r, n = fabric.global_rank, fabric.world_size
    tree = trees[r]
    floats = {k: v for k, v in tree.items() if np.asarray(v).dtype.kind == "f"}
    out = {
        "world": (fabric.world_size, fabric.global_rank, fabric.local_rank, fabric.node_rank, fabric.is_global_zero,
                  fabric.data_parallel_size, fabric.backend),
        "all_gather": fabric.all_gather(tree),
        "broadcast": fabric.broadcast(tree, src=0),
        "broadcast_last": fabric.broadcast(tree, src=n - 1),
        "sum": fabric.all_reduce(floats, "sum"),
        "mean": fabric.all_reduce(floats, "mean"),
        "ints_sum": fabric.all_reduce({"i": tree["i"]}, "sum"),
    }
    fabric.barrier()
    x = torch.from_numpy(np.ascontiguousarray(tree["x"]))
    out["pmean"] = comms.pmean(x).numpy()
    out["psum"] = comms.psum({"x": x, "s": torch.tensor(float(r + 1))})
    out["psum"] = {k: v.numpy() for k, v in out["psum"].items()}
    out["gathered"] = comms.all_gather(x).numpy()
    g = [torch.from_numpy(a.copy()) for a in grads[r]]
    comms.pmean_(g)
    out["pmean_"] = [t.numpy() for t in g]
    out["modules"] = foreign_modules()
    return out


def _dv_modules(family: str, small: Dict[str, Any], actions, state_dicts):
    if family == "dreamer_v3":
        from sheeprl_tpu_torch.algos.dreamer_v3.agent import build_agent
        from sheeprl_tpu_torch.algos.dreamer_v3.dreamer_v3 import build_optimizers_and_state, build_train_fn
        from sheeprl_tpu_torch.configs import dreamer_v3_config as make_cfg
    else:
        from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
        from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import build_optimizers_and_state, build_train_fn
        from sheeprl_tpu_torch.configs import dreamer_v2_config as make_cfg
    cfg = make_cfg(**small)
    modules = build_agent(cfg, tuple(actions), False, {"rgb": (3, 64, 64)}, device="cpu", training=True)
    for name, module in zip(MODULES, modules):
        module.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dicts[name].items()})
    return cfg, modules, build_optimizers_and_state, build_train_fn


def _snapshot(state, metrics) -> Dict[str, Any]:
    out = {
        "params": {name: _numpy(state[name].state_dict()) for name in MODULES},
        "exp_avg": {
            name: {pn: state["opt"][name].state[p]["exp_avg"].numpy().copy()
                   for pn, p in state[name].named_parameters()}
            for name in MODULES[:3]
        },
        "metrics": {k: float(v) for k, v in metrics.items()},
    }
    if "moments" in state:
        out["moments"] = {k: float(v) for k, v in state["moments"].items()}
    return out


def _noise(n: Dict[str, Any]) -> Dict[str, Any]:
    return {"posterior": torch.from_numpy(n["posterior"]), "prior": torch.from_numpy(n["prior"]),
            "actions": [torch.from_numpy(a) for a in n["actions"]]}


def dreamer_steps(fabric, family: str, small: Dict[str, Any], actions, state_dicts, batches, noises,
                  taus, independent: bool = False) -> Dict[str, Any]:
    """DreamerV3 or DreamerV2 gradient steps on this rank's half of each
    batch and noise (``batches[i][rank]``, ``noises[i][rank]``): one eager
    step a batch (the state after each), then, from the same start, all of
    them as one burst (the state after it). ``independent``: each step
    from the starting weights, and no burst."""
    from sheeprl_tpu_torch.train.burst import run_train_burst

    r = fabric.global_rank
    out: Dict[str, Any] = {"steps": []}
    runs = [(False, [i]) for i in range(len(batches))] if independent else [(False, list(range(len(batches)))),
                                                                            (True, None)]
    for burst, which in runs:
        cfg, modules, build_state, build_train_fn = _dv_modules(family, small, actions, state_dicts)
        fabric.sync_modules(*modules)
        state = build_state(cfg, *modules)
        program = build_train_fn(cfg, tuple(actions), False)
        if burst:
            stack = {k: torch.from_numpy(np.stack([b[r][k] for b in batches])) for k in batches[0][r]}
            metrics = run_train_burst(program, state, stack, taus, noise=[_noise(n[r]) for n in noises])
            out["burst"] = _snapshot(state, metrics)
            out["burst_eager_calls"] = program.step.eager_calls
        else:
            for i in which:
                batch, noise, tau = batches[i], noises[i], taus[i]
                metrics = program(state, {k: torch.from_numpy(v) for k, v in batch[r].items()}, _noise(noise[r]),
                                  tau=tau)
                out["steps"].append(_snapshot(state, metrics))
    out["modules"] = foreign_modules()
    return out


def ppo_update(fabric, overrides: List[str], agent_args: tuple, widths: Dict[str, int], state_dict, data_by_rank,
               perms, share_data: bool, n_local: int, batch_size: int, epochs: int) -> Dict[str, Any]:
    """One PPO update on this rank's rollout rows (gathered from every rank
    with ``share_data``) at the given permutations (``perms[rank]``, or the
    global ones with ``share_data``)."""
    from sheeprl_tpu_torch.algos.ppo.agent import PPOAgent
    from sheeprl_tpu_torch.algos.ppo.ppo import UpdateProgram, build_optimizer, gather_rows, ppo_loss, select_rows
    from sheeprl_tpu_torch.config import compose

    r = fabric.global_rank
    cfg = compose(overrides=["exp=ppo"] + list(overrides))
    actions_dim, is_continuous, cnn_keys, mlp_keys, channels, state_dim = agent_args
    agent = PPOAgent(actions_dim, is_continuous, cnn_keys, mlp_keys, channels, state_dim, **widths)
    agent.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in state_dict.items()})
    fabric.sync_modules(agent)
    optimizer = build_optimizer(cfg, agent)
    program = UpdateProgram(ppo_loss(cfg, list(cnn_keys), list(mlp_keys) + list(cnn_keys), actions_dim,
                                     is_continuous),
                            select_rows, agent, optimizer, max_grad_norm=float(cfg.algo.max_grad_norm or 0.0),
                            epochs=epochs, n_samples=n_local, batch_size=batch_size, n_metrics=3, n_scalars=2,
                            generator=None, device="cpu", share_data=share_data, rank=r,
                            world_size=fabric.world_size)
    data = gather_rows(data_by_rank[r], "cpu") if share_data else data_by_rank[r]
    metrics = program.update(data, [0.2, 0.01], perms=perms if share_data else perms[r])
    opt = [{k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v) for k, v in optimizer.state[p].items()}
           for _n, p in agent.named_parameters()]
    return {"params": _numpy(agent.state_dict()), "opt": opt, "metrics": metrics.numpy(),
            "rows": {k: v.shape[0] for k, v in data.items()}, "modules": foreign_modules()}


def aggregate(fabric, values_by_rank: List[List[float]]) -> Dict[str, float]:
    """This rank's episodes (``values_by_rank[rank]``) into an aggregator,
    synced over the world at a log boundary; what it computes then."""
    from sheeprl_tpu_torch.utils.metric import MeanMetric, MetricAggregator, SumMetric

    agg = MetricAggregator({"Rewards/rew_avg": MeanMetric(), "Game/ep_len_avg": MeanMetric(), "sum": SumMetric(),
                            "never": MeanMetric()})
    for v in values_by_rank[fabric.global_rank]:
        agg.update("Rewards/rew_avg", v)
        agg.update("Game/ep_len_avg", 2 * v)
        agg.update("sum", v)
    agg.sync(fabric)
    return agg.compute()


def fail_on(fabric, rank: int) -> int:
    """Raise on rank ``rank``; the others return their rank."""
    if fabric.global_rank == rank:
        raise ValueError(f"rank {rank} fails")
    return fabric.global_rank
