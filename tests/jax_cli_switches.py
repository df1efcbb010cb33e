"""The JAX package's CLI for the port's parity tests, with its process-wide
switches put back: ``sheeprl_tpu.cli.run`` sets ``MetricAggregator.disabled``
and ``timer.disabled`` from ``metric.log_level`` for the whole process and
never restores them, so after a ``metric.log_level=0`` run every later test
on the same worker would find the JAX timer off (``tests/test_obs/
test_spans.py`` reads an empty registry); its Fabric switches JAX's default
key implementation for the whole process, so a later test's
``jax.random.PRNGKey`` would draw other numbers (``tests/test_envs/
test_rollout.py``'s Pendulum starts from another state)."""

from __future__ import annotations

from typing import Any, Sequence

import cpu_threads  # noqa: F401  (one CPU thread a process: see cpu_threads.py)


def run_jax_cli(args: Sequence[str]) -> Any:
    """``sheeprl_tpu.cli.run(args)``, the aggregator and timer switches and
    the default key implementation as they were before it."""
    import jax

    from sheeprl_tpu import cli as jax_cli
    from sheeprl_tpu.utils.metric import MetricAggregator
    from sheeprl_tpu.utils.timer import timer

    saved = MetricAggregator.disabled, timer.disabled
    saved_impl = jax.config.jax_default_prng_impl
    try:
        return jax_cli.run(list(args))
    finally:
        MetricAggregator.disabled, timer.disabled = saved
        jax.config.update("jax_default_prng_impl", saved_impl)
