"""The port's telemetry lint (counterpart of ``tools/lint_telemetry.py``):
every training loop under ``sheeprl_tpu_torch/algos/`` times its phases
through the shared plumbing (``obs.spans.span``, ``obs.perf.PhaseSeconds``,
``obs.perf.log_sps_metrics``), so that the trace, the histograms and the
rate gauges see all of them:

- no ``"Time/sps_..."`` or ``"Perf/mfu"`` string literal (a hand-rolled
  gauge: ``obs/perf.log_sps_metrics`` computes them);
- no ``timer(...)`` scope and no ``timer.compute()`` / ``timer.reset()``
  (a ``span`` is the timer plus the trace);
- no clock read of its own: ``time.perf_counter``, ``time.time`` or
  ``time.monotonic``, under any import alias.

AST-based: comments and docstrings that name these are fine.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import List

import pytest

REPO = Path(__file__).resolve().parents[1]
ALGOS = REPO / "sheeprl_tpu_torch" / "algos"
FORBIDDEN_LITERALS = ("Time/sps_", "Perf/mfu")
FORBIDDEN_CLOCKS = ("perf_counter", "time", "monotonic")


def findings(source: str) -> List[str]:
    """The lint's findings in one module's source."""
    tree = ast.parse(source)
    time_aliases, clock_names, timer_names = set(), set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            time_aliases |= {a.asname or a.name for a in node.names if a.name == "time"}
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            clock_names |= {a.asname or a.name for a in node.names if a.name in FORBIDDEN_CLOCKS}
        elif isinstance(node, ast.ImportFrom) and (node.module or "").endswith("utils.timer"):
            timer_names |= {a.asname or a.name for a in node.names if a.name == "timer"}
    docstrings = {
        id(node.body[0].value)
        for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
        and node.body and isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant)
    }
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings
                and node.value.startswith(FORBIDDEN_LITERALS)):
            out.append(f"{node.lineno}: gauge literal {node.value!r}")
        elif isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
                if fn.value.id in time_aliases and fn.attr in FORBIDDEN_CLOCKS:
                    out.append(f"{node.lineno}: clock read {fn.value.id}.{fn.attr}()")
                elif fn.value.id in timer_names | {"timer"} and fn.attr in ("compute", "reset"):
                    out.append(f"{node.lineno}: timer.{fn.attr}()")
            elif isinstance(fn, ast.Name) and fn.id in clock_names:
                out.append(f"{node.lineno}: clock read {fn.id}()")
            elif isinstance(fn, ast.Name) and fn.id in timer_names:
                out.append(f"{node.lineno}: timer scope {fn.id}(...)")
    return out


LOOPS = sorted(ALGOS.rglob("*.py"))


@pytest.mark.parametrize("path", LOOPS, ids=lambda p: str(p.relative_to(ALGOS)))
def test_no_loop_times_itself(path):
    assert findings(path.read_text()) == [], path.relative_to(REPO)


def test_the_lint_finds_what_it_forbids():
    source = (
        "import time as clock\n"
        "from time import perf_counter as pc, monotonic\n"
        "from sheeprl_tpu_torch.utils.timer import timer\n"
        "a = clock.perf_counter(); b = pc(); c = monotonic(); d = clock.time()\n"
        "with timer('Time/train_time'):\n"
        "    pass\n"
        "timer.compute()\n"
        "gauges = {'Time/sps_train': 1.0, 'Perf/mfu': 2.0}\n"
        "def f():\n"
        "    '''Time/sps_train in a docstring is fine'''\n"
    )
    got = findings(source)
    assert len(got) == 8, got
    assert findings("import time\ntime.sleep(1)\n") == []
