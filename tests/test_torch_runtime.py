"""The port's runtime pieces against the JAX package's: schedules, metrics,
the timer, the registry, ``_target_`` instantiation, the env seeding rules,
the single-device Fabric and the run loop's bookkeeping (counted on the CPU
at a tiny width)."""

import math
import warnings

import numpy as np
import pytest
import torch

from sheeprl_tpu.envs.vector.factory import env_seeds as jax_env_seeds
from sheeprl_tpu.envs.vector.factory import resolve_vectorization as jax_resolve_vectorization
from sheeprl_tpu.train.burst import tau_schedule as jax_tau_schedule
from sheeprl_tpu.utils import metric as jax_metric
from sheeprl_tpu.utils.utils import polynomial_decay as jax_polynomial_decay
from sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2 import tau_schedule
from sheeprl_tpu_torch.config import compose
from sheeprl_tpu_torch.config.instantiate import instantiate
from sheeprl_tpu_torch.envs.vector import env_seeds, resolve_vectorization
from sheeprl_tpu_torch.fabric import Fabric
from sheeprl_tpu_torch.utils import metric
from sheeprl_tpu_torch.utils.registry import find_algorithm, register_algorithm, registered_algorithm_names
from sheeprl_tpu_torch.utils.timer import timer
from sheeprl_tpu_torch.utils.utils import polynomial_decay


@pytest.mark.parametrize("step", [0, 1, 5, 49, 50, 51, 200])
@pytest.mark.parametrize("power", [1.0, 2.0])
def test_polynomial_decay_matches_jax(step, power):
    kw = dict(initial=0.4, final=0.05, max_decay_steps=50, power=power)
    assert polynomial_decay(step, **kw) == jax_polynomial_decay(step, **kw)


@pytest.mark.parametrize("start,n", [(0, 1), (0, 5), (99, 3), (100, 1), (150, 120)])
def test_tau_schedule_matches_jax(start, n):
    want = jax_tau_schedule(n, start, 100, tau=1.0, first_hard=False)
    np.testing.assert_array_equal(tau_schedule(n, start, 100), want)


def test_metrics_match_jax():
    values = [1.5, np.float32(2.0), torch.tensor(3.25), 0.5]
    for ours, theirs in ((metric.MeanMetric(), jax_metric.MeanMetric()), (metric.SumMetric(), jax_metric.SumMetric())):
        assert math.isnan(ours.compute()) == math.isnan(theirs.compute())
        for v in values:
            ours.update(v)
            theirs.update(v if not isinstance(v, torch.Tensor) else float(v))
        assert ours.compute() == theirs.compute()
    agg = metric.MetricAggregator({"a": metric.MeanMetric(), "b": metric.SumMetric()})
    agg.update("a", 2.0)
    agg.update("missing", 1.0)
    assert agg.compute() == {"a": 2.0, "b": 0.0} and "a" in agg
    with pytest.raises(KeyError):
        metric.MetricAggregator({}, raise_on_missing=True).update("x", 1.0)
    built = instantiate(compose(overrides=["exp=dreamer_v2"]).metric.aggregator)
    assert isinstance(built, metric.MetricAggregator) and "Loss/world_model_loss" in built


def test_timer_accumulates_and_resets():
    timer.reset()
    with timer("Time/x"):
        pass
    with timer("Time/x"):
        pass
    out = timer.compute()
    assert set(out) == {"Time/x"} and out["Time/x"] >= 0.0 and timer.compute() == {}


def test_registry_finds_the_ported_entrypoint():
    import sheeprl_tpu_torch

    sheeprl_tpu_torch.register_algorithms()
    entry = find_algorithm("dreamer_v2")
    assert entry["module"] == "sheeprl_tpu_torch.algos.dreamer_v2.dreamer_v2" and entry["entrypoint"] == "main"
    assert "dreamer_v2" in registered_algorithm_names() and find_algorithm("ppo") is None

    def main(fabric, cfg):
        return None

    main.__module__ = entry["module"]
    with pytest.raises(ValueError, match="already registered"):
        register_algorithm()(main)


@pytest.mark.parametrize(
    "target,match",
    [
        ("sheeprl_tpu_torch.envs.crafter.CrafterWrapper", "item 6"),
        ("sheeprl_tpu_torch.utils.optim.SGD", "item 5"),
        ("sheeprl_tpu_torch.not_a_module.X", "queue A"),
    ],
)
def test_targets_not_ported_raise_naming_their_item(target, match):
    with pytest.raises(NotImplementedError, match=match):
        instantiate({"_target_": target})


def test_env_seeding_and_backend_rules_match_jax():
    assert env_seeds(5, 1, 4) == jax_env_seeds(5, 1, 4)
    for overrides in ([], ["env.sync_env=False"], ["env.vectorization=async"], ["env.vectorization=sync", "env.sync_env=False"]):
        cfg = compose(overrides=["exp=dreamer_v2"] + overrides)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the JAX package warns when the two knobs disagree
            want = jax_resolve_vectorization(cfg)
        assert resolve_vectorization(cfg) == want


def test_fabric_save_and_load_round_trip(tmp_path):
    from sheeprl_tpu.ckpt import validate_checkpoint as jax_validate_checkpoint

    fabric = Fabric(accelerator="cpu")
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 4}
    fabric.save(str(tmp_path / "ckpt_4_0"), state)
    assert jax_validate_checkpoint(str(tmp_path / "ckpt_4_0"), deep=True)["framework"] == "torch"
    restored = fabric.load(str(tmp_path / "ckpt_4_0"))
    np.testing.assert_array_equal(restored["w"], state["w"].numpy())
    assert int(restored["step"]) == 4


def test_fabric_is_one_device_and_raises_for_the_rest(monkeypatch):
    fabric = instantiate(compose(overrides=["exp=dreamer_v2", "fabric.accelerator=cpu"]).fabric)
    assert isinstance(fabric, Fabric) and fabric.device == torch.device("cpu")
    assert (fabric.world_size, fabric.global_rank, fabric.is_global_zero) == (1, 0, True)
    torch_gen, np_gen = fabric.seed_everything(3)
    assert torch.equal(torch.rand(4, generator=torch_gen), torch.rand(4, generator=torch.Generator().manual_seed(3)))
    assert np_gen.integers(1 << 30) == np.random.default_rng(3).integers(1 << 30)
    for kwargs, match in (
        (dict(devices=2), "item 7"),
        (dict(strategy="ddp"), "item 7"),
    ):
        with pytest.raises(NotImplementedError, match=match):
            Fabric(accelerator="cpu", **kwargs)
    # bf16-mixed is the JAX package's: bf16 compute, f32 parameters; any other precision raises
    assert Fabric(accelerator="cpu", precision="bf16-mixed").compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="precision"):
        Fabric(accelerator="cpu", precision="16-mixed")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Fabric()


@pytest.mark.parametrize(
    "overrides,match",
    [
        (["metric.profiler=true"], "item 6h"),
        (["plane.num_players=1"], "item 6f"),
        (["env.act_burst=4"], "act_burst"),
        (["env.vectorization=async"], "sync vector env"),
        (["buffer.device_ring=True"], "device_ring"),
        (["env.backend=jax"], "item 6d"),
    ],
)
def test_the_run_raises_for_layers_not_ported(tmp_path, overrides, match):
    from sheeprl_tpu_torch import cli

    args = ["exp=dreamer_v2", "env=dummy", "env.sync_env=True", "dry_run=True", "metric.log_level=0",
            "fabric.accelerator=cpu", f"root_dir={tmp_path}", "run_name=x", "algo.dense_units=8",
            "algo.mlp_layers=1", "algo.world_model.encoder.cnn_channels_multiplier=2",
            "algo.world_model.recurrent_model.recurrent_state_size=8", "algo.world_model.stochastic_size=4",
            "algo.world_model.discrete_size=4"]
    with pytest.raises(NotImplementedError, match=match):
        cli.run(args + overrides)


def test_the_run_loop_fills_the_buffer_as_the_jax_loop_does(tmp_path, monkeypatch):
    """Both packages' DreamerV2 loops on the dummy env with every update in
    the random phase (``learning_starts`` past the run): the same seeded
    action stream, so the checkpointed replay buffers (the ``is_first`` rows,
    the real next observation of an ended episode, the reset rows, the ring's
    wrap, the forced last terminal) must be equal, and so must the loops'
    counters."""
    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.ckpt import read_checkpoint as jax_read_checkpoint
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.ckpt import read_checkpoint

    args = ["exp=dreamer_v2", "env=dummy", "env.id=discrete_dummy", "env.sync_env=True", "env.num_envs=2",
            "total_steps=64", "algo.learning_starts=1000", "buffer.size=40", "buffer.checkpoint=True",
            "buffer.memmap=False", "metric.log_level=0", "algo.dense_units=8", "algo.mlp_layers=1",
            "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
            "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
            "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "fabric.accelerator=cpu"]
    monkeypatch.chdir(tmp_path)
    jax_cli.run(args + [f"root_dir={tmp_path}/jax", "run_name=jax"])
    result = cli.run(args + [f"root_dir={tmp_path}/port", "run_name=port"])
    assert (result["updates"], result["random_steps"], result["player_steps"], result["gradient_steps"]) == (32, 32, 0, 0)
    (jax_ckpt,) = sorted((tmp_path / "jax").rglob("ckpt_*_0"))
    assert jax_ckpt.name == f"ckpt_{result['policy_steps']}_0" == result["checkpoint"].rsplit("/", 1)[1]
    theirs, ours = jax_read_checkpoint(str(jax_ckpt)), read_checkpoint(result["checkpoint"])
    for key in ("update", "last_checkpoint", "batch_size", "expl_decay_steps"):
        assert int(ours[key]) == int(theirs[key]), key
    assert len(ours["rb"]["buffers"]) == len(theirs["rb"]["buffers"]) == 2
    for sub, jax_sub in zip(ours["rb"]["buffers"], theirs["rb"]["buffers"]):
        assert (int(sub["pos"]), bool(sub["full"])) == (int(jax_sub["pos"]), bool(jax_sub["full"]))
        assert bool(sub["full"])  # 32 rows and the reset rows wrap a 20-row ring
        assert sub["buffer"].keys() == jax_sub["buffer"].keys()
        for k in sub["buffer"]:
            np.testing.assert_array_equal(sub["buffer"][k], jax_sub["buffer"][k], err_msg=k)
