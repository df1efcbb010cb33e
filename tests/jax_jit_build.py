"""The JAX package's agent builds for the port's parity tests, initialised in
one jitted program.

A JAX ``build_agent`` called eagerly initialises every parameter op by op,
and each distinct shape of each op is an XLA compilation of its own: a small
DreamerV3 build compiles about 250 programs (about 50 s on a loaded 8-core
host, against about 13 s for one jitted program). The parity tests take the
JAX parameters as they come and carry them to the port, so where they are
initialised does not matter to what they check.
"""

from __future__ import annotations

from typing import Any, Callable

import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)


def jit_build(build: Callable[..., Any], *args: Any) -> Any:
    """``build(*args)`` for a builder whose last argument is the PRNG key and
    whose last output is the parameter tree: the same outputs, the tree
    initialised inside one ``jax.jit``."""
    import jax

    *head, key = args
    built = []

    def params_of(k):
        out = build(*head, k)
        built.append(out)
        return out[-1]

    params = jax.jit(params_of)(key)
    return (*built[0][:-1], params)
