"""Mini-Hydra: yaml config composition (counterpart of
``sheeprl_tpu/config/engine.py``, the same surface and semantics).

Hydra and PyYAML are not needed: files, CLI override values and dumps go
through the port's own YAML subset (:mod:`sheeprl_tpu_torch.config.yamlite`).
The subset of Hydra re-implemented here is what the recipes use:

- defaults lists with ``_self_`` ordering, relative (``default``) and absolute
  (``/optim@optimizer: adam``) entries, ``override /group: option`` directives,
  and mandatory ``???`` group choices;
- ``# @package _global_`` / ``# @package some.path`` headers;
- CLI override grammar ``group=option``, ``a.b.c=value``, ``+a.b=value``,
  ``~a.b``;
- ``${a.b.c}`` interpolation (typed when the whole string is one reference) and
  the ``${now:...}`` resolver;
- ``SHEEPRL_SEARCH_PATH`` with ``file://`` and ``pkg://`` entries so user
  projects can add configs without forking (reference plugin behavior).

Scientific-notation floats (``2e-4``) are parsed as floats, matching OmegaConf
rather than bare YAML 1.1.
"""

from __future__ import annotations

import datetime
import importlib
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sheeprl_tpu_torch.config import yamlite
from sheeprl_tpu_torch.utils import dotdict

MISSING = "???"

# ---------------------------------------------------------------------------
# yaml loading with OmegaConf-style float resolution
# ---------------------------------------------------------------------------


def yaml_load(text: str) -> Any:
    return yamlite.load(text, omegaconf_floats=True)


# ---------------------------------------------------------------------------
# search path
# ---------------------------------------------------------------------------

SEARCH_PATH_ENV_VAR = "SHEEPRL_SEARCH_PATH"


def _builtin_config_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")


def build_search_path(extra: Optional[Sequence[str]] = None) -> List[str]:
    """Ordered list of config roots; earlier entries win on lookup.

    As in the reference plugin (hydra_plugins/sheeprl_search_path.py:33, which
    *appends* user entries after the primary config dir), the builtin config
    tree comes first: user dirs add new options but cannot shadow builtins.
    """
    paths: List[str] = [_builtin_config_dir()]
    raw = []
    if extra:
        raw.extend(extra)
    env = os.environ.get(SEARCH_PATH_ENV_VAR, "")
    if env:
        raw.extend(p for p in env.split(";") if p)
    for entry in raw:
        if entry.startswith("file://"):
            p = os.path.abspath(entry[len("file://"):])
            if p not in paths:
                paths.append(p)
        elif entry.startswith("pkg://"):
            pkg = entry[len("pkg://"):]
            if pkg in ("sheeprl.configs", "sheeprl_tpu_torch.configs"):
                continue  # builtin tree is already first
            try:
                mod = importlib.import_module(pkg)
                paths.append(os.path.dirname(os.path.abspath(mod.__file__)))
            except Exception:
                pass
        else:
            p = os.path.abspath(entry)
            if p not in paths:
                paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# file model
# ---------------------------------------------------------------------------


class ConfigFile:
    def __init__(self, package: Optional[str], defaults: List[Any], body: Dict[str, Any]):
        self.package = package  # None = default (its own group path)
        self.defaults = defaults
        self.body = body


_PACKAGE_RE = re.compile(r"^#\s*@package\s+(\S+)\s*$", re.M)


def _load_config_file(search_path: List[str], group: str, name: str) -> ConfigFile:
    """Load ``<root>/<group>/<name>.yaml`` from the first root that has it."""
    name = name[:-5] if name.endswith(".yaml") else name
    rel = os.path.join(group, name + ".yaml") if group else name + ".yaml"
    for root in search_path:
        path = os.path.join(root, rel)
        if os.path.isfile(path):
            with open(path) as f:
                text = f.read()
            m = _PACKAGE_RE.search(text)
            package = m.group(1) if m else None
            data = yaml_load(text) or {}
            if not isinstance(data, dict):
                raise ValueError(f"Config file {path} must contain a mapping")
            defaults = data.pop("defaults", [])
            return ConfigFile(package, defaults, data)
    tried = [os.path.join(r, rel) for r in search_path]
    raise FileNotFoundError(
        f"Config '{rel}' not found in search path:\n  " + "\n  ".join(tried)
    )


def _config_exists(search_path: List[str], group: str, name: str) -> bool:
    name = name[:-5] if name.endswith(".yaml") else name
    rel = os.path.join(group, name + ".yaml") if group else name + ".yaml"
    return any(os.path.isfile(os.path.join(r, rel)) for r in search_path)


def _group_exists(search_path: List[str], group: str) -> bool:
    return any(os.path.isdir(os.path.join(r, group)) for r in search_path)


# ---------------------------------------------------------------------------
# defaults-entry parsing
# ---------------------------------------------------------------------------


class DefaultEntry:
    """One parsed defaults-list item."""

    def __init__(
        self,
        group: str,
        option: Any,
        package: Optional[str],
        is_override: bool,
        is_absolute: bool,
        is_self: bool = False,
    ):
        self.group = group          # group path, '/'-separated, no leading slash
        self.option = option        # option name, MISSING, or None (`- group: null` selects nothing)
        self.package = package      # explicit @package target (group-relative semantics)
        self.is_override = is_override
        self.is_absolute = is_absolute
        self.is_self = is_self


def _parse_default_entry(entry: Any, current_group: str) -> Optional[DefaultEntry]:
    """Parse a defaults item. Returns None for hydra-internal entries we skip."""
    if entry == "_self_":
        return DefaultEntry("", None, None, False, False, is_self=True)
    if isinstance(entry, str):
        # bare relative option in the same group, e.g. `- default`
        return DefaultEntry(current_group, entry, None, False, False)
    if isinstance(entry, dict):
        if len(entry) != 1:
            raise ValueError(f"Malformed defaults entry: {entry!r}")
        key, option = next(iter(entry.items()))
        key = key.strip()
        is_override = False
        if key.startswith("override "):
            is_override = True
            key = key[len("override "):].strip()
        if key.startswith("hydra/") or key == "hydra":
            return None  # hydra's own config groups don't apply here
        package = None
        if "@" in key:
            key, package = key.split("@", 1)
        is_absolute = key.startswith("/")
        group = key.lstrip("/")
        if not is_absolute and current_group:
            group = f"{current_group}/{group}" if group else current_group
        return DefaultEntry(group, option, package, is_override, is_absolute)
    raise ValueError(f"Malformed defaults entry: {entry!r}")


# ---------------------------------------------------------------------------
# merge helpers
# ---------------------------------------------------------------------------


def _deep_merge(dst: Dict[str, Any], src: Dict[str, Any]) -> Dict[str, Any]:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v if not isinstance(v, dict) else _deep_copy(v)
    return dst


def _deep_copy(d):
    if isinstance(d, dict):
        return {k: _deep_copy(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_deep_copy(v) for v in d]
    return d


def _merge_at(cfg: Dict[str, Any], package: str, body: Dict[str, Any]) -> None:
    """Merge ``body`` into ``cfg`` at dotted path ``package`` ('' = root)."""
    node = cfg
    if package:
        for part in package.split("."):
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"Cannot merge into non-dict at '{package}'")
    _deep_merge(node, body)


def _set_path(cfg: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        nxt = node.get(part)
        if not isinstance(nxt, dict):
            nxt = {}
            node[part] = nxt
        node = nxt
    node[parts[-1]] = value


def _del_path(cfg: Dict[str, Any], path: str) -> None:
    parts = path.split(".")
    node = cfg
    for part in parts[:-1]:
        node = node.get(part)
        if not isinstance(node, dict):
            return
    node.pop(parts[-1], None)


def _get_path(cfg: Dict[str, Any], path: str) -> Any:
    node = cfg
    for part in path.split("."):
        if not isinstance(node, dict) or part not in node:
            raise KeyError(path)
        node = node[part]
    return node


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def _effective_package(cfile: ConfigFile, entry_group: str, explicit_pkg: Optional[str]) -> str:
    """Where does this file's body merge? Priority: defaults-entry @pkg, file header, group path."""
    if explicit_pkg is not None:
        if explicit_pkg == "_global_":
            return ""
        return explicit_pkg
    if cfile.package is not None:
        if cfile.package == "_global_":
            return ""
        if cfile.package.startswith("_global_."):
            return cfile.package[len("_global_."):]
        return cfile.package
    return entry_group.replace("/", ".")


def _collect_choices(
    search_path: List[str],
    group: str,
    name: str,
    choices: Dict[str, str],
    cli_choices: Dict[str, str],
    depth: int = 0,
    is_root: bool = True,
) -> None:
    """Pre-pass: walk the defaults tree recording `override /g: opt` directives
    and default group choices, so late overrides (exp files) can retarget
    groups merged earlier — mirroring Hydra's two-phase defaults-tree build.

    Group choices (CLI `env=atari`, exp `override /env: atari`) target the
    *root* defaults list only; nested relative entries (e.g. `- default`
    inside `algo/ppo.yaml`) always use their literal option, as in Hydra.
    """
    if depth > 20:
        raise RecursionError("defaults tree too deep (cycle?)")
    cfile = _load_config_file(search_path, group, name)
    for raw in cfile.defaults:
        entry = _parse_default_entry(raw, group)
        if entry is None or entry.is_self or entry.option is None:
            continue
        g = entry.group
        if entry.is_override:
            if g not in cli_choices:
                choices[g] = entry.option
            continue
        if is_root:
            opt = cli_choices.get(g, choices.get(g, entry.option))
            if g not in choices:
                choices[g] = opt
        else:
            opt = entry.option
        if opt == MISSING:
            opt = cli_choices.get(g, choices.get(g))
            if opt in (None, MISSING):
                continue
        if _config_exists(search_path, g, opt):
            _collect_choices(search_path, g, opt, choices, cli_choices, depth + 1, is_root=False)


def _compose_file(
    search_path: List[str],
    group: str,
    name: str,
    entry_pkg: Optional[str],
    choices: Dict[str, str],
    cli_choices: Dict[str, str],
    cfg: Dict[str, Any],
    depth: int = 0,
    is_root: bool = True,
) -> None:
    """Merge ``group/name.yaml`` (with its defaults) into ``cfg`` in order."""
    if depth > 20:
        raise RecursionError("defaults tree too deep (cycle?)")
    cfile = _load_config_file(search_path, group, name)
    pkg = _effective_package(cfile, group, entry_pkg)

    entries = [_parse_default_entry(raw, group) for raw in cfile.defaults]
    entries = [e for e in entries if e is not None]
    has_self = any(e.is_self for e in entries)
    if not has_self:
        # Hydra 1.1+: implicit _self_ first — own body can be overridden by defaults
        entries.insert(0, DefaultEntry("", None, None, False, False, is_self=True))

    for entry in entries:
        if entry.is_self:
            _merge_at(cfg, pkg, _deep_copy(cfile.body))
            continue
        if entry.option is None:  # `- group: null` selects nothing
            continue
        if entry.is_override:
            continue  # handled in the pre-pass
        g = entry.group
        if is_root:
            opt = cli_choices.get(g, choices.get(g, entry.option))
        else:
            opt = entry.option
            if opt == MISSING:
                opt = cli_choices.get(g, choices.get(g, MISSING))
        if opt == MISSING:
            raise ValueError(
                f"You must specify '{g}', e.g, {g}=<OPTION>\nAvailable options:\n"
                + "\n".join("\t" + o for o in available_options(search_path, g))
            )
        if opt is None:
            continue
        # packages in nested defaults are relative to the parent file's package
        sub_pkg = entry.package
        if sub_pkg is not None and sub_pkg not in ("_global_",) and pkg:
            sub_pkg = f"{pkg}.{sub_pkg}"
        _compose_file(search_path, g, opt, sub_pkg, choices, cli_choices, cfg, depth + 1, is_root=False)


def available_options(search_path: List[str], group: str) -> List[str]:
    opts = set()
    for root in search_path:
        d = os.path.join(root, group)
        if os.path.isdir(d):
            for f in os.listdir(d):
                if f.endswith(".yaml"):
                    opts.add(f[:-5])
    return sorted(opts)


# ---------------------------------------------------------------------------
# CLI override parsing
# ---------------------------------------------------------------------------


def _parse_overrides(
    overrides: Sequence[str], search_path: List[str]
) -> Tuple[Dict[str, str], List[Tuple[str, Any]], List[str]]:
    """Split raw ``key=value`` tokens into (group choices, value sets, deletes)."""
    group_choices: Dict[str, str] = {}
    value_sets: List[Tuple[str, Any]] = []
    deletes: List[str] = []
    for tok in overrides:
        tok = tok.strip()
        if not tok:
            continue
        if tok.startswith("~"):
            deletes.append(tok[1:])
            continue
        if "=" not in tok:
            raise ValueError(f"Override '{tok}' is not of the form key=value")
        key, value = tok.split("=", 1)
        additive = key.startswith("+")
        key = key.lstrip("+")
        if not additive and "." not in key and "@" not in key and _group_exists(search_path, key):
            group_choices[key] = value
        elif "@" in key and "." not in key:
            raise ValueError(f"group@package CLI overrides are not supported: {tok}")
        else:
            value_sets.append((key, yaml_load(value)))
    return group_choices, value_sets, deletes


# ---------------------------------------------------------------------------
# interpolation
# ---------------------------------------------------------------------------

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def _resolve_interpolations(cfg: Dict[str, Any]) -> None:
    resolving: set = set()

    def resolve_value(val: Any) -> Any:
        if isinstance(val, str):
            return resolve_str(val)
        if isinstance(val, dict):
            return {k: resolve_value(v) for k, v in val.items()}
        if isinstance(val, list):
            return [resolve_value(v) for v in val]
        return val

    def lookup(ref: str) -> Any:
        if ref in resolving:
            raise ValueError(f"Interpolation cycle at '${{{ref}}}'")
        resolving.add(ref)
        try:
            raw = _get_path(cfg, ref)
            out = resolve_value(raw)
            _set_path(cfg, ref, out)
            return out
        finally:
            resolving.discard(ref)

    def eval_expr(expr: str) -> Any:
        expr = expr.strip()
        if expr.startswith("now:"):
            return datetime.datetime.now().strftime(expr[len("now:"):])
        if expr.startswith("oc.env:"):
            parts = expr[len("oc.env:"):].split(",", 1)
            return os.environ.get(parts[0], parts[1] if len(parts) > 1 else None)
        if expr.startswith("eval:"):
            inner = resolve_str(expr[len("eval:"):])
            return eval(inner, {"__builtins__": {}}, {})  # noqa: S307 — hydra parity
        return lookup(expr)

    def resolve_str(s: str) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string reference: keep the referenced type
            return eval_expr(m.group(1))
        out = s
        for _ in range(10):
            if not _INTERP_RE.search(out):
                break
            out = _INTERP_RE.sub(lambda mm: str(eval_expr(mm.group(1))), out)
        return out

    def walk(node: Any, path: str) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k], f"{path}.{k}" if path else k)
            return node
        if isinstance(node, list):
            return [walk(v, path) for v in node]
        if isinstance(node, str) and "${" in node:
            return resolve_value(node)
        return node

    walk(cfg, "")


def _check_missing(cfg: Dict[str, Any], path: str = "", allow: Tuple[str, ...] = ()) -> None:
    if isinstance(cfg, dict):
        for k, v in cfg.items():
            _check_missing(v, f"{path}.{k}" if path else k, allow)
    elif isinstance(cfg, list):
        for i, v in enumerate(cfg):
            _check_missing(v, f"{path}[{i}]", allow)
    elif cfg == MISSING:
        if path in allow:
            return
        raise ValueError(f"Missing mandatory value: {path} (set it with {path}=<VALUE>)")


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def compose(
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
    search_path: Optional[Sequence[str]] = None,
    allow_missing: Tuple[str, ...] = (),
    resolve: bool = True,
) -> dotdict:
    """Compose the config tree, Hydra-style. Returns a :class:`dotdict`."""
    sp = build_search_path(search_path)
    overrides = list(overrides or [])
    cli_choices, value_sets, deletes = _parse_overrides(overrides, sp)

    # two collection passes: the first discovers the exp chain's overrides,
    # the second re-walks with those choices kept so files selected *by* an
    # override also contribute their own overrides.
    choices: Dict[str, str] = {}
    _collect_choices(sp, "", config_name, choices, cli_choices)
    _collect_choices(sp, "", config_name, choices, cli_choices)

    cfg: Dict[str, Any] = {}
    _compose_file(sp, "", config_name, None, choices, cli_choices, cfg)

    for key, value in value_sets:
        _set_path(cfg, key, value)
    for key in deletes:
        _del_path(cfg, key)

    if resolve:
        _resolve_interpolations(cfg)
        _check_missing(cfg, allow=allow_missing)
    return dotdict(cfg)


def to_yaml(cfg) -> str:
    data = cfg.as_dict() if hasattr(cfg, "as_dict") else dict(cfg)
    return yamlite.dump(data)


def _split_sweep_values(value: str) -> List[str]:
    """Split a sweep value on TOP-LEVEL commas only.

    Commas inside brackets/braces/parens or quotes are list/dict/str
    literals, not sweep separators — Hydra's grammar makes the same
    distinction (``a=1,2`` sweeps; ``a=[1,2]`` is one list value).
    """
    parts: List[str] = []
    cur: List[str] = []
    depth = 0
    quote: Optional[str] = None
    for ch in value:
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    parts.append("".join(cur))
    return parts


def expand_multirun(overrides: Sequence[str]) -> List[List[str]]:
    """Hydra basic-sweeper subset (reference CLI surface: ``sheeprl -m
    exp=... algo.lr=1e-3,1e-4`` via ``@hydra.main`` — hydra 1.3's default
    sweeper): expand comma-separated override values into the cartesian
    product of single-run override lists, preserving override order within
    each job.

    ``exp=a2c,ppo optim.lr=1e-3,1e-4`` -> 4 jobs. Values whose commas sit
    inside brackets or quotes are not swept. Overrides without ``=`` (and
    ``~key`` deletions) pass through unchanged.
    """
    axes: List[List[str]] = []
    for ov in overrides:
        if "=" in ov and not ov.startswith("~"):
            key, value = ov.split("=", 1)
            axes.append([f"{key}={v}" for v in _split_sweep_values(value)])
        else:
            axes.append([ov])
    jobs: List[List[str]] = [[]]
    for axis in axes:
        jobs = [job + [choice] for job in jobs for choice in axis]
    return jobs
