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
    assert "sheeprl_tpu_torch.serve.gateway" in modules
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
