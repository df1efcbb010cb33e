"""Algorithm registry (counterpart of ``sheeprl_tpu/utils/registry.py``).

Decorating an entrypoint registers it under its defining module: a
training ``main(fabric, cfg)`` with :func:`register_algorithm`, an
``evaluate(fabric, cfg, state)`` with :func:`register_evaluation`.
:func:`sheeprl_tpu_torch.register_algorithms` imports the ported
entrypoints so that they register.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

__all__ = [
    "algorithm_registry",
    "evaluation_registry",
    "find_algorithm",
    "find_evaluation",
    "register_algorithm",
    "register_evaluation",
    "registered_algorithm_names",
]

# {module_name: [{"name": algo_name, "entrypoint": fn_name, "decoupled": bool}]}
algorithm_registry: Dict[str, List[Dict[str, Any]]] = {}
# {module_name: [{"name": algo_name, "entrypoint": fn_name}]}
evaluation_registry: Dict[str, List[Dict[str, Any]]] = {}


def register_algorithm(decoupled: bool = False) -> Callable:
    """Decorator: register a ``main(fabric, cfg)`` training entrypoint under
    the last component of its module's name."""

    def inner(fn: Callable) -> Callable:
        module = fn.__module__
        algos = algorithm_registry.setdefault(module, [])
        name = module.split(".")[-1]
        if any(a["name"] == name for a in algos):
            raise ValueError(f"Algorithm '{name}' already registered in module '{module}'")
        algos.append({"name": name, "entrypoint": fn.__name__, "decoupled": decoupled})
        return fn

    return inner


def register_evaluation(algorithms: Any) -> Callable:
    """Decorator: register an ``evaluate(fabric, cfg, state)`` entrypoint for
    one algorithm name or a list of them."""
    names = [algorithms] if isinstance(algorithms, str) else list(algorithms)

    def inner(fn: Callable) -> Callable:
        evals = evaluation_registry.setdefault(fn.__module__, [])
        for name in names:
            if not any(e["name"] == name for e in evals):
                evals.append({"name": name, "entrypoint": fn.__name__})
        return fn

    return inner


def find_evaluation(name: str) -> Optional[Dict[str, Any]]:
    """Look up a registered evaluation by algorithm name → {module, entrypoint}."""
    for module, evals in evaluation_registry.items():
        for ev in evals:
            if ev["name"] == name:
                return {"module": module, **ev}
    return None


def find_algorithm(name: str) -> Optional[Dict[str, Any]]:
    """Look up a registered algorithm by name → {module, entrypoint, decoupled}."""
    for module, algos in algorithm_registry.items():
        for algo in algos:
            if algo["name"] == name:
                return {"module": module, **algo}
    return None


def registered_algorithm_names() -> List[str]:
    return sorted({a["name"] for algos in algorithm_registry.values() for a in algos})
