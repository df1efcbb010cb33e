"""The port's eval service, model registry and model manager against the JAX
package's, on the CPU.

- ``registry.jsonl``: a file written by either package's ``ModelRegistry``
  resolves, ranks (``best``, ties too) and refuses a config-hash mismatch
  the same in the other; a torn last line is skipped. ``registry:`` refs
  that are malformed or unknown raise in both.
- ``ModelManager``: a model registered by either package is listed and
  loaded by the other.
- ``iqm`` equals JAX's on drawn arrays; ``eval_settings`` fills the same
  defaults.
- The eval service: a tiny DreamerV3 and a tiny DreamerV2 checkpoint written
  by the JAX CLI on gymnasium's CartPole-v1 (vector observations, so the
  returns follow the actions), scored by the JAX service and by the port's
  with the same posterior (and for DV3 action) noise injected on both sides
  at every step: returns, lengths and every step's actions equal;
  ``eval.json`` key sets equal.
- The CLI commands on the CPU: ``evaluation`` (eval.json, one registry
  line, a ``registry:best:`` re-score equal to the first), ``registration``,
  each raising on a missing ``checkpoint_path``, and ``run -m`` expanding a
  sweep as JAX's ``expand_multirun`` does.
"""

import glob
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import sheeprl_tpu
from sheeprl_tpu import cli as jax_cli
from sheeprl_tpu.config.engine import expand_multirun as jax_expand_multirun
from sheeprl_tpu.evals import registry as jax_registry
from sheeprl_tpu.evals import service as jax_service
from sheeprl_tpu.utils.model_manager import ModelManager as JaxModelManager
from sheeprl_tpu_torch import cli
from sheeprl_tpu_torch.evals import registry, service
from sheeprl_tpu_torch.utils.model_manager import ModelManager

S = D = 4  # the tiny runs' stochastic and discrete sizes
EPISODES, SEED0 = 4, 11


def cartpole_args(root, run_name, algo, extra=()):
    """A tiny run on CartPole-v1's 4-wide state: random actions only (the
    learning starts past the run), a checkpoint at its end."""
    return [
        f"exp={algo}", "env=gym", "env.id=CartPole-v1", "env.num_envs=1", "env.sync_env=True",
        "env.capture_video=False", "metric.log_level=0", "buffer.memmap=False", "per_rank_batch_size=2",
        "per_rank_sequence_length=2", "algo.horizon=2", "algo.dense_units=8", "algo.mlp_layers=1",
        "total_steps=8", "algo.learning_starts=100", "algo.run_test=False",
        "algo.world_model.recurrent_model.recurrent_state_size=8",
        "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
        f"algo.world_model.stochastic_size={S}", f"algo.world_model.discrete_size={D}",
        "mlp_keys.encoder=[state]", "cnn_keys.encoder=[]", "mlp_keys.decoder=[state]", "cnn_keys.decoder=[]",
        f"root_dir={root}", f"run_name={run_name}", *extra,
    ]


def _checkpoint(root):
    found = sorted(Path(root).rglob("ckpt_*_0"))
    assert len(found) == 1, found
    return str(found[0])


def _keep_switches():
    from sheeprl_tpu.utils.metric import MetricAggregator
    from sheeprl_tpu.utils.timer import timer

    return (MetricAggregator, timer), (MetricAggregator.disabled, timer.disabled)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One tiny JAX DreamerV3 and one DreamerV2 CLI run; their checkpoints."""
    root = tmp_path_factory.mktemp("jax_eval")
    cwd = os.getcwd()
    os.chdir(root)
    (agg, tmr), saved = _keep_switches()
    try:
        for algo in ("dreamer_v3", "dreamer_v2"):
            jax_cli.run(cartpole_args(root / "logs" / algo, "jax", algo, ["fabric.accelerator=cpu"]))
    finally:
        os.chdir(cwd)
        agg.disabled, tmr.disabled = saved
    return {algo: _checkpoint(root / "logs" / algo) for algo in ("dreamer_v3", "dreamer_v2")}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _manifest_dir(path, config_hash):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump({"config_hash": config_hash, "step": 7}, f)
    return str(path)


def _records(tmp_path):
    ck = [_manifest_dir(tmp_path / f"ckpt_{i}", f"h{i}") for i in range(4)]
    return [
        {"run": "a", "checkpoint": ck[0], "env": "E-v0", "algo": "dv3", "metrics": {"mean": 1.0, "n": 10}},
        {"run": "b", "checkpoint": ck[1], "env": "E-v0", "algo": "dv3", "metrics": {"mean": 3.0, "n": 10}},
        # a tie on the mean: more episodes win
        {"run": "c", "checkpoint": ck[2], "env": "E-v0", "algo": "dv3", "metrics": {"mean": 3.0, "n": 20}},
        # a tie on mean and n: the later append wins
        {"run": "d", "checkpoint": ck[3], "env": "E-v0", "algo": "dv3", "metrics": {"mean": 3.0, "n": 20}},
        {"run": "e", "checkpoint": ck[0], "env": "F-v0", "algo": "dv3", "metrics": {"mean": 9.0, "n": 10}},
    ]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_registry_written_by_either_package_reads_the_same_in_both(tmp_path, writer):
    Writer = jax_registry.ModelRegistry if writer == "jax" else registry.ModelRegistry
    reg_dir = str(tmp_path / "reg")
    for rec in _records(tmp_path):
        Writer(reg_dir).append(rec)
    with open(os.path.join(reg_dir, "registry.jsonl"), "a") as f:
        f.write('{"run": "torn", "checkpoint": "x", "env": "E-v0", "metr')  # a torn last line
    theirs, ours = jax_registry.ModelRegistry(reg_dir), registry.ModelRegistry(reg_dir)
    assert ours.scan() == theirs.scan() and len(ours.scan()) == 5
    assert ours.records(env="E-v0") == theirs.records(env="E-v0")
    best = ours.best("E-v0", "dv3")
    assert best == theirs.best("E-v0", "dv3") and best["run"] == "d"
    assert best["schema"] == registry.REGISTRY_SCHEMA == jax_registry.REGISTRY_SCHEMA
    assert best["config_hash"] == "h3"  # filled in from the manifest
    for ref in ("registry:best:dv3:E-v0", "registry:best:dv3:F-v0", "/a/plain/path"):
        assert registry.resolve_checkpoint_ref(ref, reg_dir) == jax_registry.resolve_checkpoint_ref(ref, reg_dir)


@pytest.mark.parametrize("Registry", [jax_registry.ModelRegistry, registry.ModelRegistry], ids=["jax", "port"])
def test_both_registries_refuse_a_config_hash_mismatch(tmp_path, Registry):
    ck = _manifest_dir(tmp_path / "ckpt", "abc")
    rec = {"run": "a", "checkpoint": ck, "env": "E", "algo": "x", "config_hash": "other", "metrics": {"mean": 1.0}}
    Error = jax_registry.RegistryError if Registry is jax_registry.ModelRegistry else registry.RegistryError
    with pytest.raises(Error, match="config_hash mismatch"):
        Registry(str(tmp_path / "reg")).append(rec)
    with pytest.raises(Error, match="missing fields"):
        Registry(str(tmp_path / "reg")).append({"run": "a", "metrics": {"mean": 1.0}})
    assert not os.path.exists(tmp_path / "reg" / "registry.jsonl")


def test_malformed_and_unknown_registry_refs_raise_as_in_jax(tmp_path):
    for resolve in (registry.resolve_checkpoint_ref, jax_registry.resolve_checkpoint_ref):
        with pytest.raises(ValueError, match="registry:best"):
            resolve("registry:best:dreamer_v3")
        with pytest.raises(ValueError, match="registry:best"):
            resolve("registry:worst:dreamer_v3:E-v0")
        with pytest.raises(ValueError, match="no registry record"):
            resolve("registry:best:dreamer_v3:NoSuchEnv-v0", registry_dir=str(tmp_path / "empty"))


def test_the_config_hash_recipe_is_the_checkpoint_managers():
    from sheeprl_tpu_torch.ckpt import setup_checkpoint, teardown_checkpoint
    from sheeprl_tpu_torch.config import compose

    cfg = compose(overrides=["exp=dreamer_v3"])
    manager = setup_checkpoint(cfg)
    try:
        assert manager.config_hash == registry.registry_config_hash(cfg) is not None
    finally:
        teardown_checkpoint()


# ---------------------------------------------------------------------------
# the model manager
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_model_registered_by_either_package_loads_in_the_other(tmp_path, writer):
    from sheeprl_tpu.ckpt import read_checkpoint as jax_read_checkpoint
    from sheeprl_tpu_torch.fabric import Fabric

    run = tmp_path / "run" / "version_0"
    (run / ".hydra").mkdir(parents=True)
    (run / ".hydra" / "config.yaml").write_text("algo:\n  name: dreamer_v3\n")
    ckpt = str(run / "checkpoint" / "ckpt_8_0")
    Fabric(accelerator="cpu").save(ckpt, {"w": torch.arange(6.0).reshape(2, 3), "step": 8})
    reg = str(tmp_path / "models")
    Writer, Reader = (JaxModelManager, ModelManager) if writer == "jax" else (ModelManager, JaxModelManager)
    assert Writer(reg).register_model("agent", ckpt, description="d") == 1
    assert Writer(reg).register_model("agent", ckpt) == 2
    listed = Reader(reg).list_models()
    assert [m["version"] for m in listed["agent"]] == [1, 2] and listed["agent"][0]["description"] == "d"
    assert listed == Writer(reg).list_models()
    assert os.path.isfile(os.path.join(reg, "agent", "v1", "config.yaml"))
    Reader(reg).transition_model("agent", 1, "production")
    assert Writer(reg).get_metadata("agent", 1)["stage"] == "production"
    path = Reader(reg).get_model("agent")
    assert path == Writer(reg).get_model("agent", 2)
    loaded = ModelManager(reg).load_model("agent", 1)
    np.testing.assert_array_equal(loaded["w"], np.arange(6.0).reshape(2, 3))
    np.testing.assert_array_equal(jax_read_checkpoint(path)["w"], loaded["w"])
    Reader(reg).delete_model("agent", 2)
    assert [m["version"] for m in Writer(reg).list_models()["agent"]] == [1]
    with pytest.raises(KeyError):
        Reader(reg).get_model("agent", 2)


# ---------------------------------------------------------------------------
# the service's arithmetic and settings
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6, allow_nan=False), min_size=0, max_size=40))
def test_iqm_equals_jax(values):
    ours, theirs = service.iqm(values), jax_service.iqm(values)
    assert (np.isnan(ours) and np.isnan(theirs)) or ours == theirs


@pytest.mark.parametrize("group", [{}, {"eval": {"episodes": 3, "registry_dir": "r"}}, {"eval": None}])
def test_eval_settings_fill_the_shipped_defaults(group):
    from sheeprl_tpu.utils.utils import dotdict as jax_dotdict
    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.utils import dotdict

    assert dict(service.eval_settings(dotdict(group))) == dict(jax_service.eval_settings(jax_dotdict(group)))
    shipped = compose("eval_config", overrides=["checkpoint_path=x"]).eval
    assert dict(service.eval_settings(dotdict({}))) == dict(shipped)


# ---------------------------------------------------------------------------
# the eval service against the JAX service on JAX checkpoints
# ---------------------------------------------------------------------------


def _record_port(monkeypatch, algo, noise, action_noise, seen):
    """Wrap the port's registered builder: each act gets the injected noise
    and records its actions."""
    import sheeprl_tpu_torch

    sheeprl_tpu_torch.register_algorithms()
    build = service.find_eval_builder(algo)

    def builder(*args, **kwargs):
        policy = build(*args, **kwargs)

        def act(obs, state, generator):
            kw = {"gumbel": torch.from_numpy(noise)}
            if action_noise is not None:
                kw["action_gumbels"] = [torch.from_numpy(action_noise)]
            actions, state = policy.act(obs, state, generator, **kw)
            seen.append(np.asarray(actions).copy())
            return actions, state

        return service.EvalPolicy(act=act, init_state=policy.init_state, device=policy.device)

    monkeypatch.setitem(service._EVAL_BUILDERS, algo, builder)


def _record_jax(monkeypatch, algo, noise, action_noise, seen):
    """Inject the same noise into the JAX player's samplers and record the
    JAX service's actions."""
    sheeprl_tpu.register_algorithms()
    if algo == "dreamer_v3":
        from sheeprl_tpu.algos.dreamer_v3 import agent as jax_agent

        sample_state, sample_actions = jax_agent.compute_stochastic_state, jax_agent.sample_actor_actions

        def injected_state(logits, discrete, key, sample=True, gumbel=None):
            if sample and logits.shape[0] == EPISODES:
                gumbel = jnp.asarray(noise)
            return sample_state(logits, discrete, key, sample, gumbel=gumbel)

        def injected_actions(dists, is_continuous, key, is_training=True):
            if not is_training:
                return sample_actions(dists, is_continuous, key, is_training)
            out = []
            for d in dists:
                one = jax.nn.one_hot(jnp.argmax(d.logits + jnp.asarray(action_noise), -1), d.logits.shape[-1])
                out.append(one + d.probs - jax.lax.stop_gradient(d.probs))
            return out

        monkeypatch.setattr(jax_agent, "compute_stochastic_state", injected_state)
        monkeypatch.setattr(jax_agent, "sample_actor_actions", injected_actions)
    else:
        from sheeprl_tpu.algos.dreamer_v2 import agent as jax_agent

        sample = jax_agent.compute_stochastic_state

        def injected(logits, discrete, key, sample_state=True, gumbel=None):
            if logits.shape[0] == EPISODES:
                gumbel = jnp.asarray(noise)
            return sample(logits, discrete, key, sample_state, gumbel=gumbel)

        monkeypatch.setattr(jax_agent, "compute_stochastic_state", injected)
    build = jax_service.find_eval_builder(algo)

    def builder(*args, **kwargs):
        policy = build(*args, **kwargs)

        def act(obs, state, key):
            actions, state = policy.act(obs, state, key)
            seen.append(np.asarray(actions).copy())
            return actions, state

        return jax_service.EvalPolicy(act=act, init_state=policy.init_state, reset=policy.reset)

    monkeypatch.setitem(jax_service._EVAL_BUILDERS, algo, builder)


@pytest.mark.parametrize("algo", ["dreamer_v3", "dreamer_v2"])
def test_the_port_service_scores_a_jax_checkpoint_as_the_jax_service(jax_runs, monkeypatch, tmp_path, algo):
    ckpt = jax_runs[algo]
    rng = np.random.RandomState(3)
    noise = rng.gumbel(size=(EPISODES, S, D)).astype(np.float32)
    action_noise = rng.gumbel(size=(EPISODES, 2)).astype(np.float32) if algo == "dreamer_v3" else None
    jax_seen, port_seen = [], []
    _record_jax(monkeypatch, algo, noise, action_noise, jax_seen)
    _record_port(monkeypatch, algo, noise, action_noise, port_seen)
    reg = str(tmp_path / "reg")
    theirs = jax_service.evaluate_checkpoint(ckpt, episodes=EPISODES, seed0=SEED0, write_json=True,
                                             write_registry=True, registry_dir=reg)
    ours = service.evaluate_checkpoint(ckpt, episodes=EPISODES, seed0=SEED0, write_json=True, write_registry=True,
                                       registry_dir=reg, device="cpu")
    assert ours["seeds"] == theirs["seeds"] == [SEED0 + i for i in range(EPISODES)]
    assert ours["lengths"] == theirs["lengths"] and max(ours["lengths"]) > 1
    assert ours["returns"] == theirs["returns"]
    assert len(port_seen) == len(jax_seen) == max(ours["lengths"])
    for step, (a, b) in enumerate(zip(port_seen, jax_seen)):
        np.testing.assert_array_equal(a.reshape(EPISODES), b.reshape(EPISODES), err_msg=f"step {step}")
    assert set(ours) == set(theirs)
    with open(ours["path"]) as f, open(theirs["path"]) as g:
        assert set(json.load(f)) == set(json.load(g))
    # the manifest's hash (the JAX run's) is the record's in both: the JAX package's own check passes
    assert ours["config_hash"] == theirs["config_hash"] == jax_registry._manifest_config_hash(ckpt)
    rows = jax_registry.ModelRegistry(reg).scan()
    assert len(rows) == 2 and rows[0]["metrics"] == rows[1]["metrics"]
    jax_registry.ModelRegistry(reg).append(rows[1])  # passes the JAX package's config-hash check


# ---------------------------------------------------------------------------
# the CLI commands
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tiny run of the port's DreamerV3 on CartPole; its checkpoint."""
    root = tmp_path_factory.mktemp("port_eval")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        result = cli.run(cartpole_args(root / "logs", "port", "dreamer_v3", ["fabric.accelerator=cpu"]))
    finally:
        os.chdir(cwd)
    return result["checkpoint"]


def test_the_evaluation_command_scores_registers_and_rescores_a_registry_ref(port_run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    reg = str(tmp_path / "reg")
    args = ["fabric.accelerator=cpu", "eval.episodes=3", f"eval.registry_dir={reg}"]
    first = cli.evaluation([f"checkpoint_path={port_run}", *args])
    assert first["n"] == 3 and first["policy_version"] == 8 and first["algo"] == "dreamer_v3"
    with open(first["path"]) as f:
        assert json.load(f)["returns"] == first["returns"]
    (row,) = registry.ModelRegistry(reg).scan()
    assert row["checkpoint"] == os.path.abspath(port_run) and row["metrics"]["n"] == 3
    assert row["config_hash"] == registry.manifest_config_hash(port_run)
    again = cli.evaluation(["checkpoint_path=registry:best:dreamer_v3:CartPole-v1", *args])
    assert again["returns"] == first["returns"] and again["checkpoint"] == first["checkpoint"]
    assert len(registry.ModelRegistry(reg).scan()) == 2


def test_the_registration_command_copies_the_checkpoint(port_run, tmp_path):
    reg = str(tmp_path / "models")
    assert cli.registration([f"checkpoint_path={port_run}", "model_name=cartpole", f"registry_dir={reg}"]) == 1
    assert cli.registration([f"checkpoint_path={port_run}", "model_name=cartpole", f"registry_dir={reg}"]) == 2
    assert JaxModelManager(reg).get_metadata("cartpole")["source_checkpoint"] == os.path.abspath(port_run)
    assert os.path.isfile(os.path.join(ModelManager(reg).get_model("cartpole", 1), "manifest.json"))


def test_evaluation_records_no_video(port_run, tmp_path, monkeypatch):
    """``eval_config``'s default asks for a video, which the port cannot
    record: it warns and evaluates without; asked for explicitly, it raises."""
    monkeypatch.chdir(tmp_path)
    args = [f"checkpoint_path={port_run}", "fabric.accelerator=cpu", "eval.episodes=1", "eval.write_registry=False"]
    with pytest.warns(UserWarning, match="no video"):
        assert cli.evaluation(args)["n"] == 1
    with pytest.raises(NotImplementedError, match="video"):
        cli.evaluation(args + ["env.capture_video=True"])


@pytest.mark.parametrize("command", ["evaluation", "serve", "registration"])
def test_each_command_raises_without_a_checkpoint_path(command):
    with pytest.raises(ValueError, match="checkpoint path"):
        getattr(cli, command)(["fabric.accelerator=cpu"] if command != "registration" else ["model_name=m"])


def test_registration_raises_without_a_model_name(port_run):
    with pytest.raises(ValueError, match="model name"):
        cli.registration([f"checkpoint_path={port_run}"])


def test_run_m_runs_the_jobs_jax_expand_multirun_expands(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    sweep = cartpole_args(tmp_path / "logs", "sweep", "dreamer_v3", ["fabric.accelerator=cpu", "seed=1,2"])
    jobs = jax_expand_multirun(sweep)
    assert len(jobs) == 2
    results = cli.run(["-m", *sweep])
    assert [r["checkpoint"] for r in results] == sorted(glob.glob(str(tmp_path / "logs" / "sweep" / "*" /
                                                                      "checkpoint" / "ckpt_8_0")))
    # each job's persisted config holds its own seed
    assert [cli.load_run_config(r["checkpoint"])[0].seed for r in results] == [1, 2]
    from sheeprl_tpu_torch.config.engine import expand_multirun

    assert expand_multirun(sweep) == jobs
