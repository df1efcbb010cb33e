#!/usr/bin/env python
"""Serving-boundary lint of the port: serve clients never load checkpoints
or build agents (counterpart of the JAX package's ``tools/lint_serve.py``,
the same boundary over ``sheeprl_tpu_torch/``).

The gateway exists so that actors get actions from a *served* policy: one
checked checkpoint load on the gateway, N clients riding
``act(obs) -> (action, version)``. The boundary is mechanical: code that
holds a ``LocalServeClient`` / ``RingServeClient`` / ``ServeContext`` (or
calls ``<gateway>.client(...)``) has no business also reaching for the
loading and building primitives (``find_eval_builder``, ``_builder_for``,
``build_agent``, ``read_checkpoint``, ``load_gateway_model``,
``GatewayModel``, ``fabric.load``).

The lint flags any file of ``sheeprl_tpu_torch/`` outside
``sheeprl_tpu_torch/serve/`` (the gateway is the loader by design), and the
repo's ``chip_smoke.py``, that does both. A file that plays both roles on
purpose is listed in :data:`ALLOWLIST`, which is checked both ways: a listed
file that no longer trips must be delisted. AST-based: comments and strings
do not count.

Usage: ``python -m sheeprl_tpu_torch.tools.lint_serve``; exit 1 with the
findings on a violation.
"""

from __future__ import annotations

import ast
import os
import sys
from typing import Iterator, List, Set, Tuple

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PACKAGE)

#: files that hold a serve client and loading or building primitives on purpose, with why
ALLOWLIST = {
    # the card check drives the gateway end to end: it trains and loads the checkpoints it serves (the
    # operator's side), publishes the hot-swap, and holds served actions against the plain cell's
    "chip_smoke.py",
}

#: holding one of these names marks a file as serve-client code (as does a ``<gateway>.client(...)`` call)
CLIENT_NAMES = {"LocalServeClient", "RingServeClient", "ServeContext"}

#: the checkpoint-loading and agent-building primitives a client may not touch
BANNED_NAMES = {"find_eval_builder", "_builder_for", "build_agent", "read_checkpoint", "load_gateway_model",
                "GatewayModel"}


def _names_used(tree: ast.AST) -> Set[str]:
    """Every bare name, attribute tail and from-import name of a file, plus
    the tokens ``fabric.load`` and ``.client()`` for those calls."""
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
            if node.attr == "load" and isinstance(node.value, ast.Name) and node.value.id == "fabric":
                names.add("fabric.load")
        elif isinstance(node, ast.ImportFrom):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) and func.attr == "client":
                names.add(".client()")
    return names


def scan_file(path: str) -> Tuple[bool, Set[str]]:
    """``(uses the client API, the banned names it uses)`` of one file."""
    with open(path, encoding="utf-8") as fh:
        try:
            tree = ast.parse(fh.read(), filename=path)
        except SyntaxError:
            return False, set()
    names = _names_used(tree)
    return bool(names & (CLIENT_NAMES | {".client()"})), names & (BANNED_NAMES | {"fabric.load"})


def iter_sources() -> Iterator[str]:
    """The port's sources but its gateway and this file, and chip_smoke.py."""
    skip = (os.path.join(PACKAGE, "serve"), os.path.abspath(__file__))
    for dirpath, dirnames, filenames in os.walk(PACKAGE):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith(".") and d != "__pycache__")
        for name in sorted(filenames):
            path = os.path.join(dirpath, name)
            if name.endswith(".py") and not path.startswith(skip):
                yield path
    smoke = os.path.join(REPO, "chip_smoke.py")
    if os.path.exists(smoke):
        yield smoke


def lint() -> Tuple[List[Tuple[str, List[str]]], List[str]]:
    """``(violations, allowlisted files that no longer trip)``."""
    violations, stale, seen = [], [], set()
    for path in iter_sources():
        rel = os.path.relpath(path, REPO)
        seen.add(rel)
        uses_client, banned = scan_file(path)
        trips = uses_client and bool(banned)
        if rel in ALLOWLIST:
            if not trips:
                stale.append(rel)
        elif trips:
            violations.append((rel, sorted(banned)))
    stale += sorted(rel for rel in ALLOWLIST if rel not in seen)
    return violations, stale


def main() -> int:
    violations, stale = lint()
    for rel, banned in violations:
        print(f"lint_serve: {rel} uses the serve client API and {', '.join(banned)}")
    for rel in stale:
        print(f"lint_serve: {rel} is allowlisted but no longer trips: delist it")
    if violations or stale:
        print("Clients get actions from the gateway (ServeGateway.client() or RingServeClient), never from "
              "checkpoint loads or agent builds of their own.")
        return 1
    print("lint_serve: OK (the serving boundary holds)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
