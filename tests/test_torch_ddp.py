"""The port's data-parallel world (``sheeprl_tpu_torch.parallel``), its
collectives (the Fabric's and ``obs.dist.comms``) and its refusals, on the
CPU over gloo.

- The collectives: the Fabric's ``all_gather``, ``broadcast`` and
  ``all_reduce`` and ``barrier``, and the in-step ``comms.pmean``,
  ``psum``, ``all_gather`` and ``pmean_``, on one rank (outside a world
  and in a world of one) give exactly the JAX Fabric's and JAX's in-step
  collectives' results on the same trees; on two spawned ranks, exactly
  what the JAX collectives give over two participants (the in-step ones
  run on two of the conftest's virtual devices, ``shard_map`` over the
  ``data`` axis; the host ones stack, broadcast, sum and mean the ranks'
  trees as ``multihost_utils`` does).
- The world: a Fabric of two devices before its launch, the refusals
  (more cards than the machine has, ``num_nodes>1`` without an external
  launcher), a launch through ``env://`` as ``torchrun`` starts one.
- Every entrypoint outside the slice refuses ``fabric.devices=2`` from the
  CLI naming ROADMAP queue A item 7b, before anything is spawned.
- The spawned ranks load no JAX, flax, optax or JAX package module, and
  no module of the port but ``obs/dist/comms.py`` calls a
  ``torch.distributed`` collective (the gradient syncs' chokepoint, as the
  JAX package's ``tools/lint_telemetry.py`` holds for ``lax`` collectives).

Every comparison is exact: the collectives move and add the same floats.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import cpu_threads  # noqa: F401  (one CPU thread a process)
import ddp_ranks
from sheeprl_tpu.fabric import Fabric as JaxFabric
from sheeprl_tpu.obs.dist import comms as jax_comms
from sheeprl_tpu.utils.jax_compat import shard_map
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.fabric import Fabric
from sheeprl_tpu_torch.obs.dist import comms
from sheeprl_tpu_torch.parallel import current_world, spawn

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def restore_prng_impl():
    """The JAX Fabric switches JAX's default key implementation for the
    whole process: put it back after the module."""
    saved = jax.config.jax_default_prng_impl
    yield
    jax.config.update("jax_default_prng_impl", saved)


def _trees(n):
    out = []
    for r in range(n):
        rng = np.random.RandomState(10 + r)
        out.append({
            "x": rng.randn(3, 4).astype(np.float32),
            "d": {"y": rng.randn(5).astype(np.float64), "z": np.float32(r + 0.5)},
            "i": rng.randint(-9, 9, (2, 2)).astype(np.int32),
            "b": rng.rand(3) > 0.5,
        })
    return out


def _grads(n):
    return [[np.asarray(np.random.RandomState(20 + r).randn(*s), np.float32) for s in ((4, 3), (7,), ())]
            for r in range(n)]


def _floats(tree):
    return {k: v for k, v in tree.items() if np.asarray(v).dtype.kind == "f"}


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype, want.dtype, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _jax_in_step(xs, grads):
    """JAX's in-step collectives over ``len(xs)`` devices of the data axis:
    each device holds its rank's ``x`` and gradients."""
    n = len(xs)
    fabric = JaxFabric(devices=n, accelerator="cpu")

    def body(x, g0, g1, g2):
        return (jax_comms.pmean(x, "data"), jax_comms.psum(x, "data"), jax_comms.all_gather(x[0], "data"),
                jax_comms.pmean(g0, "data"), jax_comms.pmean(g1, "data"), jax_comms.pmean(g2, "data"))

    fn = jax.jit(shard_map(body, mesh=fabric.mesh, in_specs=(P("data"),) * 4, out_specs=(P("data"),) * 6,
                           check_vma=False))
    stacked = [jnp.asarray(np.stack(a)) for a in (xs, *zip(*grads))]
    outs = [np.asarray(o) for o in fn(*stacked)]
    pmean, psum = outs[0].reshape(n, *xs[0].shape)[0], outs[1].reshape(n, *xs[0].shape)[0]
    gathered = outs[2].reshape(n, n, *xs[0].shape)[0]
    g = [o.reshape(n, *np.shape(grads[0][i]))[0] for i, o in enumerate(outs[3:])]
    return pmean, psum, gathered, g


def test_one_rank_collectives_are_the_jax_fabric_s():
    """Outside a world and in a spawned world of one rank: the JAX Fabric's
    single-process results (a leading axis of 1; the tree itself; each
    leaf as an array) and JAX's one-device in-step collectives."""
    tree, grads = _trees(1)[0], _grads(1)
    jf = JaxFabric(devices=1, accelerator="cpu")
    want_gather = jf.all_gather(tree)
    want_sum, want_mean = jf.all_reduce(_floats(tree), "sum"), jf.all_reduce(_floats(tree), "mean")
    pmean, psum, gathered, g = _jax_in_step([tree["x"]], grads)

    fabric = Fabric(accelerator="cpu")
    assert current_world() is None and not fabric.is_distributed and fabric.backend is None
    _assert_tree_equal(fabric.all_gather(tree), want_gather)
    assert fabric.broadcast(tree) is tree
    _assert_tree_equal(fabric.all_reduce(_floats(tree), "sum"), want_sum)
    _assert_tree_equal(fabric.all_reduce(_floats(tree), "mean"), want_mean)
    fabric.barrier()
    x = torch.from_numpy(tree["x"])
    assert comms.pmean(x) is x and comms.psum(x) is x  # no collective and no copy
    assert comms.all_gather(x).data_ptr() == x.data_ptr()
    np.testing.assert_array_equal(comms.pmean(x).numpy(), pmean)
    np.testing.assert_array_equal(comms.psum(x).numpy(), psum)
    np.testing.assert_array_equal(comms.all_gather(x).numpy(), gathered)

    (out,) = spawn(ddp_ranks.collectives, 1, args=([tree], grads), fabric_kwargs={"accelerator": "cpu"})
    assert out["world"] == (1, 0, 0, 0, True, 1, "gloo")
    _assert_tree_equal(out["all_gather"], want_gather)
    _assert_tree_equal(out["broadcast"], {k: np.asarray(v) for k, v in tree.items()} | {"d": {
        k: np.asarray(v) for k, v in tree["d"].items()}})
    _assert_tree_equal(out["sum"], want_sum)
    _assert_tree_equal(out["mean"], want_mean)
    np.testing.assert_array_equal(out["pmean"], pmean)
    np.testing.assert_array_equal(out["psum"]["x"], psum)
    np.testing.assert_array_equal(out["gathered"], gathered)
    for a, b in zip(out["pmean_"], g):
        np.testing.assert_array_equal(a, b)
    assert out["modules"] == []


def test_two_rank_collectives_are_jax_s_over_two_participants():
    trees, grads = _trees(2), _grads(2)
    pmean, psum, gathered, g = _jax_in_step([t["x"] for t in trees], grads)
    outs = spawn(ddp_ranks.collectives, 2, args=(trees, grads), fabric_kwargs={"accelerator": "cpu"})

    def stack(*leaves):
        return np.stack([np.asarray(v) for v in leaves])

    want_gather = jax.tree_util.tree_map(stack, *trees)
    floats = [jax.tree_util.tree_map(np.asarray, _floats(t)) for t in trees]
    want_sum = jax.tree_util.tree_map(lambda a, b: a + b, *floats)
    want_mean = jax.tree_util.tree_map(lambda a, b: ((a + b) / np.float32(2)).astype(a.dtype), *floats)
    for r, out in enumerate(outs):
        assert out["world"] == (2, r, r, 0, r == 0, 2, "gloo")
        _assert_tree_equal(out["all_gather"], want_gather, f"rank {r} all_gather")
        _assert_tree_equal(out["broadcast"], jax.tree_util.tree_map(np.asarray, trees[0]), f"rank {r} broadcast")
        _assert_tree_equal(out["broadcast_last"], jax.tree_util.tree_map(np.asarray, trees[1]))
        _assert_tree_equal(out["sum"], want_sum, f"rank {r} sum")
        _assert_tree_equal(out["mean"], want_mean, f"rank {r} mean")
        # a non-float leaf is summed as float32, the JAX Fabric's cast
        np.testing.assert_array_equal(out["ints_sum"]["i"], (trees[0]["i"] + trees[1]["i"]).astype(np.float32))
        np.testing.assert_array_equal(out["pmean"], pmean)
        np.testing.assert_array_equal(out["psum"]["x"], psum)
        assert float(out["psum"]["s"]) == 3.0
        np.testing.assert_array_equal(out["gathered"], gathered)
        for a, b in zip(out["pmean_"], g):
            np.testing.assert_array_equal(a, b)
        assert out["modules"] == [], f"rank {r} loaded {out['modules']}"


def test_the_episode_metrics_are_every_rank_s():
    """At a log boundary the aggregator's state is summed over the ranks:
    rank 0 logs the mean over every rank's episodes (the JAX run's one
    process saw them all); a metric no rank updated stays out."""
    values = [[1.0, 2.0, 6.0], [11.0]]
    outs = spawn(ddp_ranks.aggregate, 2, args=(values,), fabric_kwargs={"accelerator": "cpu"})
    flat = [v for vs in values for v in vs]
    want = {"Rewards/rew_avg": float(np.mean(flat)), "Game/ep_len_avg": 2 * float(np.mean(flat)), "sum": sum(flat)}
    assert outs == [want, want]


def test_a_failing_rank_fails_the_launch():
    """A spawned rank's error fails the launch with its traceback; in the
    Fabric's local launch rank 0's own error is raised as it is."""
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        spawn(ddp_ranks.fail_on, 2, args=(1,), fabric_kwargs={"accelerator": "cpu"})
    with pytest.raises(ValueError, match="rank 0 fails"):
        Fabric(accelerator="cpu", devices=2).launch(ddp_ranks.fail_on, 0)
    assert current_world() is None
    assert Fabric(accelerator="cpu", devices=2).launch(ddp_ranks.fail_on, 5) == 0


def test_the_trace_parser_counts_nccl_kernels_as_comms():
    """NCCL's kernels (and a one-rank world's ``oneRankReduce``) are the
    trace's collective time, by kind; every other kernel is not."""
    from sheeprl_tpu_torch.obs.prof import trace

    device = [("kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.0, 250.0, 1,
               None),
              ("kernel", "ncclKernel_AllGather_RING_LL_Sum_int8_t(ncclDevComm*, unsigned long, ncclWork*)", 0.0, 50.0,
               1, None),
              ("kernel", "void oneRankReduce<FuncPreMulSum<float> >(void*, void*, unsigned long, unsigned long)", 0.0,
               10.0, 1, None),
              ("kernel", "hafner_gates_kernel", 0.0, 999.0, 1, None)]
    assert trace.comms_ms_by_kind(device) == {"all_reduce": 0.26, "all_gather": 0.05}
    assert trace.nccl_kind("hafner_gates_kernel") is None


def test_wire_bytes_and_link_peaks():
    for kind in comms.KINDS:
        for n in (1, 2, 4):
            assert comms.wire_bytes(kind, 1000, n) == jax_comms.wire_bytes(kind, 1000, n)
    assert comms.link_peak_gbps("NVIDIA H100 80GB HBM3") == 450.0
    assert comms.link_peak_gbps("NVIDIA H100 PCIe") == 64.0


def test_the_world_of_a_fabric_and_its_refusals(monkeypatch):
    fabric = Fabric(accelerator="cpu", devices=2)
    assert (fabric.world_size, fabric.global_rank, fabric.is_global_zero, fabric.data_parallel_size) == (2, 0, True, 2)
    assert not fabric.is_distributed
    assert fabric.rank_seed(5) == 5
    for strategy in ("ddp", "dp", "fsdp", "auto", "single_device"):
        assert Fabric(accelerator="cpu", devices=2, strategy=strategy).strategy == strategy
    with pytest.raises(ValueError, match="external launcher"):
        Fabric(accelerator="cpu", devices=2, num_nodes=2)
    with pytest.raises(ValueError, match="positive count"):
        Fabric(accelerator="cpu", devices=0)
    # more cards than the machine has raises: one rank a card, never two ranks on one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="only 1 are available"):
        Fabric(accelerator="cuda", devices=2)
    args = ["exp=ppo", "env=dummy", "fabric.devices=2", "fabric.accelerator=cuda", "dry_run=True"]
    with pytest.raises(ValueError, match="only 1 are available"):
        cli.run(args)
    with pytest.raises(ValueError, match="NCCL refuses two ranks"):
        spawn(ddp_ranks.collectives, 2, backend="nccl", device_of_rank="cuda:0", args=([], []))


EXTERNAL = """
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from sheeprl_tpu_torch.fabric import Fabric

def fn(fabric):
    total = fabric.all_reduce({{"v": np.float32(fabric.global_rank + 1)}})["v"]
    print(fabric.world_size, fabric.global_rank, fabric.local_rank, fabric.is_distributed, float(total))

Fabric(devices=2, accelerator="cpu").launch(fn)
"""


def test_an_external_launch_joins_through_env(tmp_path):
    """Two processes started as ``torchrun`` starts them (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) join
    one world instead of spawning."""
    from sheeprl_tpu_torch.parallel import free_port

    port = str(free_port())
    procs = []
    for r in range(2):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-c", EXTERNAL.format(repo=str(REPO))], env=env, cwd=tmp_path,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err
        assert out.split() == ["2", str(r), str(r), "True", "3.0"]


NOT_IN_SLICE = ["dreamer_v1", "p2e_dv1_exploration", "p2e_dv1_finetuning", "p2e_dv2_exploration",
                "p2e_dv2_finetuning", "p2e_dv3_exploration", "p2e_dv3_finetuning", "sac", "droq", "sac_ae", "a2c",
                "ppo_recurrent"]


@pytest.mark.parametrize("exp", NOT_IN_SLICE)
def test_an_entrypoint_outside_the_slice_refuses_two_devices(exp, monkeypatch, tmp_path):
    """``fabric.devices=2`` (and ``strategy=fsdp`` at one device) raises
    from the CLI naming item 7b, before any rank is spawned."""
    import sheeprl_tpu_torch.parallel.launch as launch

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(launch, "launch_local", lambda *a, **k: pytest.fail("a rank was spawned"))
    args = [f"exp={exp}", "env=dummy", "fabric.accelerator=cpu", "dry_run=True", "metric.log_level=0"]
    if "finetuning" in exp:
        args.append(f"checkpoint.exploration_ckpt_path={tmp_path}/ckpt_0_0")
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 7b"):
        cli.run(args + ["fabric.devices=2"])
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 7b"):
        cli.run(args + ["fabric.strategy=fsdp"])


COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce_scatter",
               "reduce_scatter_tensor", "barrier", "monitored_barrier", "reduce", "gather", "scatter", "all_to_all",
               "all_to_all_single", "send", "recv", "isend", "irecv", "broadcast_object_list", "all_gather_object"}


def test_every_collective_of_the_port_goes_through_comms():
    """No module of the port but ``obs/dist/comms.py`` calls a
    ``torch.distributed`` collective, and the three data-parallel
    entrypoints' steps sync through ``comms``: the gradients in
    ``dreamer_v2._step`` (DreamerV3's too) and PPO's update (``pmean_``),
    the metrics (``pmean``), DreamerV3's ``Moments`` (``all_gather``)."""
    port = REPO / "sheeprl_tpu_torch"
    offenders = []
    for path in sorted(port.rglob("*.py")):
        if path == port / "obs" / "dist" / "comms.py":
            continue
        tree = ast.parse(path.read_text())
        dist_names = {"dist", "torch.distributed"}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                dist_names |= {a.asname for a in node.names if a.name == "torch.distributed" and a.asname}
            elif isinstance(node, ast.ImportFrom) and node.module == "torch.distributed":
                offenders += [f"{path.name}:{node.lineno} from torch.distributed import {a.name}"
                              for a in node.names if a.name in COLLECTIVES]
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr in COLLECTIVES:
                owner = ast.unparse(node.func.value)
                if owner in dist_names:
                    offenders.append(f"{path.relative_to(REPO)}:{node.lineno} {owner}.{node.func.attr}")
    assert offenders == []

    def calls(rel):
        tree = ast.parse((port / rel).read_text())
        return {n.func.id for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}

    assert {"pmean_", "pmean"} <= calls("algos/dreamer_v2/dreamer_v2.py")
    assert "pmean" in calls("algos/dreamer_v3/dreamer_v3.py")
    assert "all_gather" in calls("algos/dreamer_v3/utils.py")
    assert {"pmean_", "pmean", "all_gather"} <= calls("algos/ppo/ppo.py")
