"""The port stands alone: no module of ``sheeprl_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, flax or the JAX package, and nothing moves to
the CPU without being asked."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import sheeprl_tpu_torch
from sheeprl_tpu_torch.device import resolve_device

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "sheeprl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sheeprl_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.relative_to(REPO)}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_forbidden_module():
    modules = [m.name for m in pkgutil.walk_packages(sheeprl_tpu_torch.__path__, "sheeprl_tpu_torch.")]
    for name in ("serve.gateway", "serve.rings", "serve.loadgen", "evals.inrun", "evals.registry", "plane.publish",
                 "obs.dist.aggregate", "utils.model_manager", "plane.worker", "plane.supervisor", "plane.slabs",
                 "envs.vector.async_env", "envs.vector.shmem", "replay.sharded", "replay.strategies", "replay.plane",
                 "algos.sac.sac_decoupled", "algos.sac.player", "algos.ppo.ppo_decoupled", "algos.ppo.player",
                 "obs.hist", "obs.spans", "obs.counters", "obs.health", "obs.live", "obs.perf", "obs.telemetry",
                 "obs.dist.staleness", "obs.prof.capture", "obs.prof.trace", "obs.prof.roofline", "obs.prof.harness",
                 "obs.learn.probes", "obs.learn.sentinel", "tools.roofline_report", "tools.run_report",
                 "obs.reqtrace", "obs.slo", "serve.ops", "tools.serve_report", "tools.trace_view", "tools.lint_serve",
                 *SIMULATOR_MODULES):
        assert f"sheeprl_tpu_torch.{name}" in modules
    # the real-simulator wrappers raise at import without their simulators: the stand-ins take their place
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        "import sim_stubs\n"
        "sim_stubs.install()\n"
        "before = set(sys.modules)\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        "new = sorted(set(sys.modules) - before)\n"
        f"bad = [m for m in new if any(m == f or m.startswith(f + '.') for f in {FORBIDDEN!r})]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SIMULATOR_MODULES = ("utils.imports", "envs.crafter", "envs.diambra", "envs.minerl",
                     "envs.minerl_envs.backend", "envs.minerl_envs.navigate", "envs.minerl_envs.obtain",
                     "envs.minedojo", "algos.dreamer_v3.minedojo_actor", "available_agents")


def test_the_simulator_wrappers_load_no_gymnasium_over_duck_typed_stand_ins():
    """On a machine without gymnasium (the card's) the stand-ins hand out duck-typed spaces, and the wrappers,
    the MineDojo actor and ``available_agents`` import and build envs without loading gymnasium or JAX."""
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        "import sim_stubs\n"
        "sim_stubs.install()\n"
        f"for name in {SIMULATOR_MODULES!r}: importlib.import_module('sheeprl_tpu_torch.' + name)\n"
        "from sheeprl_tpu_torch.envs.crafter import CrafterWrapper\n"
        "from sheeprl_tpu_torch.envs.diambra import DiambraWrapper\n"
        "from sheeprl_tpu_torch.envs.minerl import MineRLWrapper\n"
        "from sheeprl_tpu_torch.envs.minedojo import MineDojoWrapper\n"
        "envs = [CrafterWrapper('crafter_reward', 64, seed=0), DiambraWrapper('doapp', rank=0),\n"
        "        MineRLWrapper('custom_navigate', multihot_inventory=False), MineDojoWrapper('open-ended')]\n"
        "for env in envs: env.reset(seed=0)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('gymnasium', 'gym', 'jax', 'flax', 'sheeprl_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from sheeprl_tpu_torch.algos.dreamer_v2.agent import build_agent
    from sheeprl_tpu_torch.configs import dreamer_v2_config
    from sheeprl_tpu_torch.serve import GatewayModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_agent(dreamer_v2_config(), (9,), False, {"rgb": (3, 64, 64)})
    with pytest.raises(RuntimeError, match="CUDA"):
        GatewayModel(policy=None, version=0, algo="dreamer_v2", env_id="x")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without a card")
    env = dict(os.environ, PYTHONPATH="")
    for cwd in (REPO, tmp_path):
        script = REPO / "chip_smoke.py"
        if cwd == tmp_path:
            script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
        proc = subprocess.run(
            [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True, timeout=300
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


CARD_PATH_FORBIDDEN = ("yaml", "gymnasium", "cv2", "tensorboardX", "jax", "sheeprl_tpu")
TINY_RUN = [
    "exp=dreamer_v2", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "dry_run=True",
    "metric.log_level=1", "buffer.memmap=False", "per_rank_batch_size=2", "per_rank_sequence_length=2",
    "algo.horizon=2", "algo.dense_units=8", "algo.mlp_layers=1", "algo.per_rank_pretrain_steps=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "run_name=isolation",
]


def test_no_target_of_the_yaml_tree_names_the_jax_package():
    targets = [
        line.split("_target_:", 1)[1].strip()
        for path in sorted((PORT / "configs").rglob("*.yaml"))
        for line in path.read_text().splitlines()
        if "_target_:" in line
    ]
    assert len(targets) > 100
    assert not [t for t in targets if t.startswith("sheeprl_tpu.") or t.startswith("sheeprl.")]


def test_no_string_of_the_yaml_tree_names_the_jax_package():
    """No value anywhere in the port's configs (``_target_``, ``cls`` or any
    other) names a module of the JAX package."""
    from sheeprl_tpu_torch.config import yamlite

    def strings(node):
        if isinstance(node, dict):
            for v in node.values():
                yield from strings(v)
        elif isinstance(node, list):
            for v in node:
                yield from strings(v)
        elif isinstance(node, str):
            yield node

    found = [
        (str(path.relative_to(PORT)), value)
        for path in sorted((PORT / "configs").rglob("*.yaml"))
        for value in strings(yamlite.load(path.read_text()))
        if "sheeprl_tpu." in value or value.startswith("sheeprl.")
    ]
    assert not found


TINY_RUN_DV3 = [
    "exp=dreamer_v3", "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "dry_run=True",
    "metric.log_level=1", "buffer.memmap=False", "per_rank_batch_size=2", "per_rank_sequence_length=1",
    "algo.horizon=2", "algo.dense_units=8", "algo.mlp_layers=1", "algo.learning_starts=0",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "run_name=isolation_dv3",
]


def test_a_dreamer_v3_run_and_serving_load_none_of_the_card_path_exclusions(tmp_path):
    """The CLI's DreamerV3 run on the dummy env at ``metric.log_level=1``,
    then ``load_gateway_model`` on its checkpoint, in a fresh interpreter:
    PyYAML, gymnasium, OpenCV, tensorboardX, JAX and the JAX package are
    never imported."""
    code = (
        "import sys, glob\n"
        "from sheeprl_tpu_torch import cli\n"
        "from sheeprl_tpu_torch.serve.model import load_gateway_model\n"
        f"result = cli.run({TINY_RUN_DV3!r} + ['root_dir={tmp_path}', 'fabric.accelerator=cpu'])\n"
        "assert result['gradient_steps'] == 1 and result['event_file']\n"
        "model = load_gateway_model(result['checkpoint'], device='cpu')[0]\n"
        "assert model.algo == 'dreamer_v3'\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {CARD_PATH_FORBIDDEN!r}))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout


def test_a_training_run_and_serving_load_none_of_the_card_path_exclusions(tmp_path):
    """The CLI's DreamerV2 run on the dummy env at ``metric.log_level=1``
    (its TensorBoard event file written), then ``load_gateway_model`` on its
    checkpoint, in a fresh interpreter: PyYAML, gymnasium, OpenCV,
    tensorboardX, JAX and the JAX package are never imported."""
    code = (
        "import sys, glob\n"
        "from sheeprl_tpu_torch import cli\n"
        "from sheeprl_tpu_torch.serve.model import load_gateway_model\n"
        f"result = cli.run({TINY_RUN!r} + ['root_dir={tmp_path}', 'fabric.accelerator=cpu'])\n"
        "assert glob.glob(result['log_dir'] + '/events.out.tfevents.*') == [result['event_file']]\n"
        "load_gateway_model(result['checkpoint'], device='cpu')\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {CARD_PATH_FORBIDDEN!r}))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout


def test_the_cli_and_checkpoint_serving_raise_without_a_card(monkeypatch, tmp_path):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.serve.model import load_gateway_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for accelerator in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.run(TINY_RUN + [f"root_dir={tmp_path}", f"fabric.accelerator={accelerator}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_gateway_model(str(tmp_path / "ckpt_1_0"))
    assert not (tmp_path / "logs").exists()


def test_a_spawned_ring_client_loads_no_torch():
    """What a ring client process imports (the ring, the client, the gateway
    module that holds its entry point, the load generator) loads no torch."""
    code = (
        "import sys\n"
        "import sheeprl_tpu_torch.serve.gateway, sheeprl_tpu_torch.serve.client\n"
        "import sheeprl_tpu_torch.serve.rings, sheeprl_tpu_torch.serve.loadgen\n"
        "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


def test_a_ring_client_with_tracing_on_loads_no_torch():
    """A ring client on a ring that traces every request (what a client
    process of a gateway with ``serve.trace_sample_rate=1`` does) stamps its
    requests, and the gateway's side reads the stamps back, with no torch,
    JAX or JAX package loaded."""
    code = (
        "import sys, threading\n"
        "import numpy as np\n"
        "from sheeprl_tpu_torch.serve.rings import ActSlabRing\n"
        "from sheeprl_tpu_torch.serve.client import RingServeClient\n"
        "ring = ActSlabRing({'x': ((3,), np.float32)}, (1,), np.int64, 2)\n"
        "ring.trace_every = 1\n"
        "seen = []\n"
        "def serve():\n"
        "    for _ in range(2):\n"
        "        reqs = []\n"
        "        while not reqs: reqs = ring.next_requests(timeout=1.0)\n"
        "        for slot, seq, reset in reqs:\n"
        "            seen.append(ring.read_meta(slot))\n"
        "            ring.respond(slot, seq, np.array([seq]), 7)\n"
        "t = threading.Thread(target=serve); t.start()\n"
        "client = RingServeClient(ring, 1)\n"
        "answers = [client.act({'x': np.zeros(3, np.float32)}) for _ in range(2)]\n"
        "t.join(); ring.close()\n"
        "assert [int(a[0]) for a, _v in answers] == [1, 2] and [v for _a, v in answers] == [7, 7]\n"
        "assert [m.trace_id for m in seen] == [2_000_001, 2_000_002], [m and m.trace_id for m in seen]\n"
        "assert all(0 < m.t_start <= m.t_enqueue for m in seen)\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch',) + {FORBIDDEN!r}))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "[]", proc.stdout + proc.stderr


def test_the_eval_and_serve_commands_raise_without_a_card(monkeypatch, tmp_path):
    from sheeprl_tpu_torch import cli
    from sheeprl_tpu_torch.evals.service import evaluate_checkpoint
    from sheeprl_tpu_torch.serve import ServeGateway, rescore_through_gateway

    monkeypatch.chdir(tmp_path)
    ckpt = cli.run(TINY_RUN + [f"root_dir={tmp_path}", "fabric.accelerator=cpu", "metric.log_level=0"])["checkpoint"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for accelerator in ("auto", "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.evaluation([f"checkpoint_path={ckpt}", f"fabric.accelerator={accelerator}", "eval.write_registry=False"])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.serve([f"checkpoint_path={ckpt}", f"fabric.accelerator={accelerator}", "serve.duration_s=1"])
    for call in (evaluate_checkpoint, rescore_through_gateway, ServeGateway.from_checkpoint):
        with pytest.raises(RuntimeError, match="CUDA"):
            call(ckpt)


TINY_P2E = [
    "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "metric.log_level=1",
    "buffer.memmap=False", "per_rank_batch_size=2", "per_rank_sequence_length=2", "algo.horizon=2",
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.train_every=2", "algo.per_rank_pretrain_steps=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "algo.world_model.discrete_size=4", "algo.ensembles.n=2",
    "total_steps=8", "algo.learning_starts=4", "buffer.size=32",
]


@pytest.mark.parametrize("family", ["dv3", "dv2"])
def test_a_p2e_exploration_finetuning_and_serving_load_none_of_the_card_path_exclusions(tmp_path, family):
    """Plan2Explore through the CLI in a fresh interpreter: an exploration
    run, finetuning from its checkpoint, then ``load_gateway_model`` on the
    finetuning checkpoint: PyYAML, gymnasium, OpenCV, tensorboardX, JAX and
    the JAX package are never imported."""
    code = (
        "import sys\n"
        "from sheeprl_tpu_torch import cli\n"
        "from sheeprl_tpu_torch.serve.model import load_gateway_model\n"
        f"base = {TINY_P2E!r} + ['root_dir={tmp_path}', 'fabric.accelerator=cpu']\n"
        f"expl = cli.run(base + ['exp=p2e_{family}_exploration', 'run_name=expl'])\n"
        f"fntn = cli.run(base + ['exp=p2e_{family}_finetuning', 'run_name=fntn',\n"
        "                        'checkpoint.exploration_ckpt_path=' + expl['checkpoint']])\n"
        "assert fntn['actor_switched_at'] == 2, fntn\n"
        "model = load_gateway_model(fntn['checkpoint'], device='cpu')[0]\n"
        f"assert model.algo == 'p2e_{family}_finetuning'\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {CARD_PATH_FORBIDDEN!r}))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout


def test_the_p2e_builds_raise_without_a_card(monkeypatch):
    from sheeprl_tpu_torch.algos.p2e_dv2.agent import build_agent as build_p2e_dv2
    from sheeprl_tpu_torch.algos.p2e_dv3.agent import build_agent as build_p2e_dv3
    from sheeprl_tpu_torch.configs import dreamer_v2_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build, exp in ((build_p2e_dv3, "p2e_dv3_exploration"), (build_p2e_dv2, "p2e_dv2_exploration")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(dreamer_v2_config(exp), (9,), False, {"rgb": (3, 64, 64)})


TINY_DV1 = [
    "env=dummy", "env.id=discrete_dummy", "env.num_envs=2", "env.sync_env=True", "metric.log_level=1",
    "buffer.memmap=False", "per_rank_batch_size=2", "per_rank_sequence_length=2", "algo.horizon=2",
    "algo.dense_units=8", "algo.mlp_layers=1", "algo.train_every=2", "algo.per_rank_gradient_steps=1",
    "algo.world_model.encoder.cnn_channels_multiplier=2", "algo.world_model.recurrent_model.recurrent_state_size=8",
    "algo.world_model.transition_model.hidden_size=8", "algo.world_model.representation_model.hidden_size=8",
    "algo.world_model.stochastic_size=4", "total_steps=8", "algo.learning_starts=4", "buffer.size=32",
]


def test_dreamer_v1_and_p2e_dv1_runs_and_serving_load_none_of_the_card_path_exclusions(tmp_path):
    """DreamerV1 through the CLI at ``metric.log_level=1`` (its event file
    written), then P2E-DV1's exploration run, finetuning from its checkpoint
    and ``load_gateway_model`` on both runs' checkpoints, in a fresh
    interpreter: PyYAML, gymnasium, OpenCV, tensorboardX, JAX and the JAX
    package are never imported."""
    code = (
        "import glob, sys\n"
        "from sheeprl_tpu_torch import cli\n"
        "from sheeprl_tpu_torch.serve.model import load_gateway_model\n"
        f"base = {TINY_DV1!r} + ['root_dir={tmp_path}', 'fabric.accelerator=cpu']\n"
        "dv1 = cli.run(base + ['exp=dreamer_v1', 'run_name=dv1'])\n"
        "assert glob.glob(dv1['log_dir'] + '/events.out.tfevents.*') == [dv1['event_file']]\n"
        "assert load_gateway_model(dv1['checkpoint'], device='cpu')[0].algo == 'dreamer_v1'\n"
        "expl = cli.run(base + ['exp=p2e_dv1_exploration', 'algo.ensembles.n=2', 'run_name=expl'])\n"
        "fntn = cli.run(base + ['exp=p2e_dv1_finetuning', 'run_name=fntn',\n"
        "                       'checkpoint.exploration_ckpt_path=' + expl['checkpoint']])\n"
        "assert fntn['actor_switched_at'] == 2, fntn\n"
        "assert load_gateway_model(fntn['checkpoint'], device='cpu')[0].algo == 'p2e_dv1_finetuning'\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {CARD_PATH_FORBIDDEN!r}))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout


def test_the_dreamer_v1_builds_raise_without_a_card(monkeypatch):
    from sheeprl_tpu_torch.algos.dreamer_v1.agent import build_agent as build_dv1
    from sheeprl_tpu_torch.algos.p2e_dv1.agent import build_agent as build_p2e_dv1
    from sheeprl_tpu_torch.configs import dreamer_v2_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build, exp in ((build_dv1, "dreamer_v1"), (build_p2e_dv1, "p2e_dv1_exploration")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build(dreamer_v2_config(exp), (2,), False, {"rgb": (3, 64, 64)})


def test_a_bf16_p2e_run_on_the_doapp_stand_in_loads_none_of_the_card_path_exclusions(tmp_path):
    """P2E-DV3's L DIAMBRA exploration preset at its ``bf16-mixed`` through
    the port's DIAMBRA wrapper over the diambra stand-in
    (``tests/sim_stubs.py``), then finetuning from its checkpoint and serving
    it, in a fresh interpreter: PyYAML, gymnasium, OpenCV, tensorboardX, JAX
    and the JAX package are never imported, and the served model is built
    from the run's ``bf16-mixed``."""
    tiny = [a for a in TINY_P2E if not a.startswith(("env=", "env.id=", "env.num_envs=", "total_steps=",
                                                       "algo.learning_starts="))]
    tiny += ["env.capture_video=False", "env.num_envs=2", "total_steps=8", "algo.learning_starts=4",
             f"root_dir={tmp_path}", "fabric.accelerator=cpu"]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"sys.path.insert(0, {str(REPO / 'tests')!r})\n"
        "import sim_stubs\n"
        "sim_stubs.install('diambra')\n"
        "from sheeprl_tpu_torch import cli\n"
        "from sheeprl_tpu_torch.serve.model import load_gateway_model\n"
        f"base = {tiny!r}\n"
        "expl = cli.run(base + ['exp=p2e_dv3_expl_L_doapp_128px_gray_combo_discrete_15Mexpl_20Mstps', 'run_name=expl'])\n"
        "fntn = cli.run(base + ['exp=p2e_dv3_fntn_L_doapp_64px_gray_combo_discrete_5Mstps', 'run_name=fntn',\n"
        "                       'checkpoint.exploration_ckpt_path=' + expl['checkpoint']])\n"
        "model, cfg, *_ = load_gateway_model(fntn['checkpoint'], device='cpu')\n"
        "assert cfg.fabric.precision == 'bf16-mixed', cfg.fabric.precision\n"
        f"bad = sorted(m for m in sys.modules if any(m == f or m.startswith(f + '.') for f in {CARD_PATH_FORBIDDEN!r}))\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "loaded: []" in proc.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("x", torch.float16), ("x", torch.float64), ("h", torch.bfloat16),
                                        ("kernel", torch.bfloat16)])
def test_the_cell_raises_for_a_cuda_tensor_of_an_unsupported_dtype(name, dtype):
    """On a CUDA tensor the wrapper launches its kernel or raises: x may be
    f32 or bf16 (the bf16 operand path), h and the parameters f32 only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the check is on CUDA tensors")
    from sheeprl_tpu_torch.kernels import ops

    args = {"h": torch.zeros(2, 8, device="cuda"), "x": torch.zeros(2, 4, device="cuda"),
            "kernel": torch.zeros(12, 24, device="cuda")}
    args[name] = args[name].to(dtype)
    before = ops.hafner_cell_launches.count
    with pytest.raises(TypeError, match=name):
        ops.hafner_gru_cell(args["h"], args["x"], args["kernel"], None, None, None, eps=1e-3)
    assert ops.hafner_cell_launches.count == before


def _loaded_forbidden() -> list:
    return sorted(m for m in sys.modules if _forbidden(m))


def recording_pendulum(id="Pendulum-v1", render_mode=None, record_dir=None, **_):
    """An env worker's env (``env.wrapper._target_``): the card's Pendulum
    stand-in, after writing what the worker process has loaded."""
    import json

    import chip_smoke

    with open(os.path.join(record_dir, f"worker_{os.getpid()}.json"), "w") as f:
        json.dump({"forbidden": _loaded_forbidden(), "cuda_initialized": torch.cuda.is_initialized()}, f)
    return chip_smoke.pendulum_stand_in(id, render_mode=render_mode)


def recording_player(ctx):
    """A player process's loop: both player modules and this player's env
    pool, one step, one slab, then what the process has loaded."""
    import json

    import numpy as np

    import sheeprl_tpu_torch.algos.ppo.player  # noqa: F401
    from sheeprl_tpu_torch.algos.sac.player import player_envs

    envs = player_envs(ctx)
    try:
        envs.reset(seed=0)
        envs.step(np.zeros((ctx.n_envs, 1), np.float32))
        kind = type(envs).__name__
    finally:
        envs.close()
    token, views = ctx.acquire_slab()
    ctx.emit(token, views, ctx.start_update, 1, 0, [])
    with open(os.path.join(ctx.log_dir, f"player_{ctx.player_idx}.json"), "w") as f:
        json.dump({"forbidden": _loaded_forbidden(), "cuda_initialized": torch.cuda.is_initialized(), "envs": kind,
                   "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES")}, f)


def test_a_spawned_player_and_its_env_workers_load_no_jax_and_no_cuda(tmp_path):
    """A process plane's player (started as the decoupled learners start
    theirs) and the env workers of its async pool: no JAX, flax or JAX
    package in their ``sys.modules``, no CUDA initialised, the card hidden
    from the player."""
    import json

    import numpy as np

    from sheeprl_tpu_torch.config import compose
    from sheeprl_tpu_torch.plane import ProcessPlane, SlabSpec

    sys.path.insert(0, str(REPO))
    cfg = compose(overrides=["exp=sac_decoupled", "env.id=Pendulum-v1", "env.num_envs=2", "env.capture_video=False",
                             "env.wrapper._target_=test_torch_isolation.recording_pendulum",
                             f"+env.wrapper.record_dir={tmp_path}"])
    spec = SlabSpec.from_arrays({"rewards": np.zeros((1, 2, 1), np.float32)})
    plane = ProcessPlane(cfg, log_dir=str(tmp_path), entry="test_torch_isolation:recording_player", spec=spec,
                         n_players=1, envs_per_player=2, scalars={"num_updates": 1, "first_train_update": 1},
                         start_update=1).start()
    try:
        plane.recv(0, 1).release()
    finally:
        plane.drain()
    assert plane.exits == {0: {"cuda_initialized": False}}
    player = json.loads((tmp_path / "player_0.json").read_text())
    assert player == {"forbidden": [], "cuda_initialized": False, "envs": "AsyncSharedMemVectorEnv",
                      "cuda_visible_devices": ""}
    workers = [json.loads(p.read_text()) for p in tmp_path.glob("worker_*.json")]
    assert len(workers) >= 2 and all(w == {"forbidden": [], "cuda_initialized": False} for w in workers)
