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
                 "obs.dist.aggregate", "utils.model_manager"):
        assert f"sheeprl_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
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
    """P2E-DV3's L DIAMBRA exploration preset at its ``bf16-mixed`` on the
    DIAMBRA stand-in, then finetuning from its checkpoint and serving it, in
    a fresh interpreter: PyYAML, gymnasium, OpenCV, tensorboardX, JAX and the
    JAX package are never imported, and the served model is built from the
    run's ``bf16-mixed``."""
    tiny = [a for a in TINY_P2E if not a.startswith(("env=", "env.id=", "env.num_envs=", "total_steps=",
                                                       "algo.learning_starts="))]
    tiny += ["env.wrapper._target_=chip_smoke.doapp_stand_in", "env.capture_video=False", "env.num_envs=2",
             "total_steps=8", "algo.learning_starts=4", f"root_dir={tmp_path}", "fabric.accelerator=cpu"]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
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
