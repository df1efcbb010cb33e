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
  ``time.monotonic``, under any import alias;
- ``log_sps_metrics`` and ``profile_tick`` at the same log boundary: a file
  that calls the one calls the other (the in-run profiler advances there);
- a registered train cost (``register_step_cost``) with probe wiring: the
  file wires the learn tap (``learn_tap``, ``probe_update``,
  ``probe_optimizer``, ``observe_probes``, ``learn_probes``), or a module of
  the algorithms it imports does (the decoupled entrypoints run the coupled
  families' programs); and every train program built with
  ``build_train_burst`` or ``StepProgram`` is handed a tap (``UpdateProgram``
  makes its own).

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
PROBE_WIRING = {"learn_tap", "probe_update", "probe_optimizer", "observe_probes", "learn_probes"}


def _calls(tree) -> dict:
    """Called name -> the calls (``f(...)`` and ``x.f(...)``)."""
    out: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else fn.attr if isinstance(fn, ast.Attribute) else None
            if name is not None:
                out.setdefault(name, []).append(node)
    return out


def plane_findings(source: str, imported_sources=()) -> List[str]:
    """The profiler's and the learn probes' wiring findings in one module's
    source; ``imported_sources`` are the algorithm modules it imports."""
    calls = _calls(ast.parse(source))
    out = []
    if "log_sps_metrics" in calls and "profile_tick" not in calls:
        out.append(f"{calls['log_sps_metrics'][0].lineno}: log_sps_metrics without profile_tick")
    wired = PROBE_WIRING & set(calls) or any(PROBE_WIRING & set(_calls(ast.parse(s))) for s in imported_sources)
    if "register_step_cost" in calls and not wired:
        out.append(f"{calls['register_step_cost'][0].lineno}: train cost registered without learn-probe wiring")
    for node in calls.get("build_train_burst", []) + calls.get("StepProgram", []):
        if len(node.args) < 4 and not any(k.arg == "learn_tap" for k in node.keywords):
            out.append(f"{node.lineno}: a train program built without a learn tap")
    return out


def _imported_algos(source: str) -> list:
    """The sources of the algorithm modules ``source`` imports from."""
    out = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith("sheeprl_tpu_torch.algos."):
            path = REPO.joinpath(*node.module.split(".")).with_suffix(".py")
            if path.is_file():
                out.append(path.read_text())
    return out


@pytest.mark.parametrize("path", LOOPS, ids=lambda p: str(p.relative_to(ALGOS)))
def test_no_loop_times_itself(path):
    assert findings(path.read_text()) == [], path.relative_to(REPO)


@pytest.mark.parametrize("path", LOOPS, ids=lambda p: str(p.relative_to(ALGOS)))
def test_every_loop_wires_the_profiler_and_the_learn_probes(path):
    source = path.read_text()
    assert plane_findings(source, _imported_algos(source)) == [], path.relative_to(REPO)


def test_the_plane_lint_finds_what_it_forbids():
    source = (
        "log_sps_metrics(logger, policy_step=1, last_log=0)\n"
        "register_step_cost(program.step)\n"
        "program = build_train_burst(body, noise_for, prepare)\n"
        "other = StepProgram(body, draw, prepare, n_gates=2)\n"
    )
    got = plane_findings(source)
    assert [f.split(": ", 1)[1] for f in got] == [
        "log_sps_metrics without profile_tick", "train cost registered without learn-probe wiring",
        "a train program built without a learn tap", "a train program built without a learn tap"]
    wired = ("profile_tick(policy_step=1)\nlog_sps_metrics(logger)\nregister_step_cost(p)\n"
             "build_train_burst(body, noise_for, prepare, learn_tap())\nStepProgram(b, d, p, n_gates=2, learn_tap=t)\n")
    assert plane_findings(wired) == []
    # the cost of a program built by an imported module that wires the tap
    assert plane_findings("register_step_cost(p)\n", ["tap = learn_tap()\n"]) == []


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
