"""Print every registered algorithm and its evaluation entrypoint
(counterpart of ``sheeprl_tpu/available_agents.py``): the same columns, as a
``rich`` table where ``rich`` is installed and as a plain-text table where it
is not.

    python -m sheeprl_tpu_torch.available_agents
"""

from __future__ import annotations

from typing import List, Sequence

COLUMNS = ("Module", "Algorithm", "Entrypoint", "Decoupled", "Evaluated by")
TITLE = "SheepRL-TPU Agents"


def agent_rows() -> List[List[str]]:
    """One row a registered algorithm: its module, name, entrypoint, whether
    it is decoupled, and the evaluation entrypoint registered for its name
    (under any module), else ``Undefined``."""
    import sheeprl_tpu_torch
    from sheeprl_tpu_torch.utils.registry import algorithm_registry, evaluation_registry

    sheeprl_tpu_torch.register_algorithms()
    rows = []
    for module, implementations in algorithm_registry.items():
        for algo in implementations:
            evaluated_by = next(
                (f"{ev_module}.{ev['entrypoint']}" for ev_module, evals in evaluation_registry.items()
                 for ev in evals if ev["name"] == algo["name"]),
                "Undefined",
            )
            rows.append([module, algo["name"], algo["entrypoint"], str(algo["decoupled"]), evaluated_by])
    return rows


def plain_table(rows: Sequence[Sequence[str]], title: str = TITLE) -> str:
    """The rows under COLUMNS as left-aligned text columns."""
    widths = [max(len(str(r[i])) for r in [COLUMNS, *rows]) for i in range(len(COLUMNS))]

    def line(cells) -> str:
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()

    rule = "  ".join("-" * w for w in widths)
    return "\n".join([title, line(COLUMNS), rule, *(line(r) for r in rows)])


def main() -> None:
    rows = agent_rows()
    try:
        from rich.console import Console
        from rich.table import Table
    except ImportError:
        print(plain_table(rows))
        return
    table = Table(title=TITLE)
    for column in COLUMNS:
        table.add_column(column)
    for row in rows:
        table.add_row(*row)
    Console().print(table)


if __name__ == "__main__":
    main()
