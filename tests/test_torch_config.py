"""The port's config engine and YAML subset against the JAX package's.

- the port's YAML reader gives ``yaml.safe_load``'s result on every file of
  its tree and on ``yaml.safe_dump`` output, and (with the config engine's
  float rule) the JAX engine's ``yaml_load`` result;
- what its writer writes reads back equal under both readers;
- ``compose`` gives the JAX ``compose`` result for every experiment and for
  each override form, the ``_target_`` prefix aside (``run_name`` holds the
  composition's clock and is compared without it);
- the one deviation of a value, ``metric.telemetry.peak_tflops``, and the
  comments that name the port's profiler (DEVIATIONS) are where they are
  listed, and nowhere else;
- input outside the subset raises.

Equality is exact: both sides produce Python scalars, lists and dicts.
"""

import math
from pathlib import Path

import pytest
import yaml

from sheeprl_tpu.config import compose as jax_compose
from sheeprl_tpu.config.engine import yaml_load as jax_yaml_load
from sheeprl_tpu_torch.config import compose, yamlite
from sheeprl_tpu_torch.configs import dreamer_v2_config

REPO = Path(__file__).resolve().parents[1]
TREE = REPO / "sheeprl_tpu_torch" / "configs"
FILES = sorted(TREE.rglob("*.yaml"))
EXPS = sorted(p.stem for p in (TREE / "exp").glob("*.yaml") if p.stem != "default")
OVERRIDE_FORMS = {
    "group": ["env=dummy", "fabric=ddp-cpu"],
    "value": ["algo.gamma=2e-3", "env.num_envs=7", "cnn_keys.encoder=[rgb, depth]"],
    "added": ["+foo.bar=3", "+algo.new_knob={a: 1, b: [x, 2.5]}"],
    "deleted": ["~buffer.prioritize_ends", "~metric.telemetry"],
    "interpolated": ["env.num_envs=${seed}", "exp_name=${algo.name}_${env.id}"],
}


#: the port's listed deviations from the JAX tree: file → [(the port's text, the JAX text, why), ...]
DEVIATIONS = {
    "metric/default.yaml": [
        (
            "  # MFU denominator in TFLOP/s (default: the H100 SXM's dense bf16\n"
            "  # tensor-core peak; f32 programs are measured against the same bf16 peak)\n"
            "  peak_tflops: 989.4\n",
            "  # MFU denominator in TFLOP/s (default: TPU v5e single-chip bf16 peak)\n  peak_tflops: 197.0\n",
            "Perf/mfu divides by it: the port runs on an H100, the JAX package on a TPU v5e",
        ),
        # comments only: the port's profiler is torch.profiler, its traces Chrome traces of CUDA graphs and spans
        (
            "# torch.profiler trace of the whole run: false, true (a Chrome trace in\n"
            "# logs/runs/<root_dir>/<run_name>/torch_traces/), or the directory to write\n"
            "# the Chrome trace of the whole run into (CUDA kernels, graph replays, spans)\n",
            "# jax.profiler trace capture: false, or a directory to dump XLA/TensorBoard\n"
            "# traces of the whole run into (the TPU superset of the reference's\n"
            "# named-scope timers — SURVEY §5.1)\n",
            "a comment: metric.profiler's trace",
        ),
        (
            "  # mirror spans into torch.profiler.record_function ranges so phases show\n"
            "  # up inside the Chrome traces captured while a profiler records\n",
            "  # mirror spans into jax.profiler.TraceAnnotation so phases show up inside\n"
            "  # XLA/TensorBoard profiles captured with metric.profiler\n",
            "a comment: the span mirror",
        ),
        (
            "    # > 0: additionally capture an on-demand torch.profiler window of this\n"
            "    # many seconds next to each dump (flight_<...>_trace/)\n",
            "    # > 0: additionally capture an on-demand jax.profiler window of this\n"
            "    # many seconds next to each dump (flight_<...>_xla/)\n",
            "a comment: the flight recorder's window",
        ),
        (
            "  # in-run device-profile capture + roofline attribution (obs/prof/):\n"
            "  # every_n_steps > 0 opens a torch.profiler window at the first log\n"
            "  # boundary past each multiple of that many policy steps, bounds it at\n"
            "  # window_s seconds, parses its Chrome trace (device time by CUDA-graph\n"
            "  # replay and span), and folds\n",
            "  # in-run device-profile capture + roofline attribution (obs/prof/,\n"
            "  # howto/profiling.md): every_n_steps > 0 opens a jax.profiler window at\n"
            "  # the first log boundary past each multiple of that many policy steps,\n"
            "  # bounds it at window_s seconds, auto-parses the xplane, and folds\n",
            "a comment: the scheduled capture",
        ),
    ],
}
#: the composed key of that deviation: (the port's value, the JAX value)
PEAK_TFLOPS = (989.4, 197.0)


def _jax_view(node):
    """The port's tree with its targets renamed to the JAX package's and
    without ``run_name``."""
    if isinstance(node, dict):
        return {k: _jax_view(v) for k, v in node.items() if k != "run_name"}
    if isinstance(node, list):
        return [_jax_view(v) for v in node]
    if isinstance(node, str) and node.startswith("sheeprl_tpu_torch."):
        return "sheeprl_tpu." + node[len("sheeprl_tpu_torch."):]
    return node


def _without_run_name(node):
    return {k: v for k, v in node.items() if k != "run_name"}


def test_the_tree_is_the_jax_tree_with_port_targets():
    jax_tree = REPO / "sheeprl_tpu" / "configs"
    assert [p.relative_to(TREE) for p in FILES] == sorted(p.relative_to(jax_tree) for p in jax_tree.rglob("*.yaml"))
    assert len(FILES) == 74
    for path in FILES:
        ours = path.read_text().replace("_target_: sheeprl_tpu_torch.", "_target_: sheeprl_tpu.").replace(
            "cls: sheeprl_tpu_torch.", "cls: sheeprl_tpu."
        )
        for port_text, jax_text, _why in DEVIATIONS.get(str(path.relative_to(TREE)), ()):
            assert ours.count(port_text) == 1, path
            ours = ours.replace(port_text, jax_text)
        assert ours == (jax_tree / path.relative_to(TREE)).read_text(), path


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(TREE)))
def test_reader_matches_pyyaml_on_the_tree(path):
    text = path.read_text()
    assert yamlite.load(text) == yaml.safe_load(text)
    data = jax_yaml_load(text)
    assert yamlite.load(text, omegaconf_floats=True) == data
    assert yamlite.load(yaml.safe_dump(data, sort_keys=False)) == data
    written = yamlite.dump(data)
    assert yaml.safe_load(written) == data
    assert yamlite.load(written) == data


TRICKY = [
    "yes", "No", "off", "1e5", "2e-4", "0x1f", "010", "0b11", "1_000", "1:30", "+1", ".5", "5.", "-.inf", ".nan",
    "", " lead", "trail ", "a  b", "a: b", "x #y", "- z", "[a]", "{a}", "'q'", '"dq"', "it's", "q\"uote",
    "a\\b", "multi\nline", "\n\nx\n", "x\n\n", "tab\tt", "~", "null", "é ü", "${now:%Y}", "@x", "`x", "%x",
    "!x", "&x", "*x", "|", ">", "?x", "? x", ":x", "x:", "long words " * 30, "\\ x " * 30, "x" * 100 + "\n" + " y" * 50,
]


@pytest.mark.parametrize("value", TRICKY, ids=range(len(TRICKY)))
def test_strings_round_trip_through_both_readers(value):
    for data in ({"k": value}, [value], {"k": [value, {"n": value}]}, value):
        written = yamlite.dump(data)
        assert yaml.safe_load(written) == data
        assert yamlite.load(written) == data
        for width in (80, 20):
            assert yamlite.load(yaml.safe_dump(data, sort_keys=False, width=width)) == data


@pytest.mark.parametrize(
    "value", [1e-5, 2e-4, 1.0, 0.1, 1e16, -3.5e-12, math.inf, -math.inf, 0, -7, 2**40, True, False, None]
)
def test_scalars_keep_their_type(value):
    for written in (yamlite.dump({"v": value}), yaml.safe_dump({"v": value})):
        for read in (yaml.safe_load(written)["v"], yamlite.load(written)["v"]):
            assert type(read) is type(value) and read == value


@pytest.mark.parametrize(
    "text",
    ["a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  x\n", "a: >\n  x\n", "? a\n: b\n", "%YAML 1.1\n---\na: 1\n",
     "a: 2001-12-14\n", "<<: {a: 1}\n", "a: [1, 2\n", "a: 'open\n", "a:\n\t- 1\n"],
)
def test_outside_the_subset_raises(text):
    with pytest.raises(yamlite.YAMLSubsetError):
        yamlite.load(text)


def _compare(overrides):
    """Both composes give the same tree, or raise the same exception type."""
    try:
        want = _without_run_name(jax_compose(overrides=overrides).as_dict())
    except Exception as exc:  # e.g. a finetuning exp without its exploration checkpoint
        with pytest.raises(type(exc)):
            compose(overrides=overrides)
        return None
    ours = compose(overrides=overrides)
    view = _jax_view(ours.as_dict())
    telemetry = view.get("metric", {}).get("telemetry")
    if telemetry is not None and "peak_tflops" in telemetry:  # the listed deviation
        assert (telemetry["peak_tflops"], want["metric"]["telemetry"]["peak_tflops"]) == PEAK_TFLOPS
        telemetry["peak_tflops"] = PEAK_TFLOPS[1]
    assert view == want
    return ours


@pytest.mark.parametrize("exp", EXPS)
def test_compose_matches_jax_for_every_experiment(exp):
    ours = _compare([f"exp={exp}"])
    if ours is not None:
        assert ours.run_name.endswith(f"_{ours.exp_name}_{ours.seed}")
    _compare([f"exp={exp}", "checkpoint.exploration_ckpt_path=/x/ckpt_1_0"])


@pytest.mark.parametrize("form", sorted(OVERRIDE_FORMS))
@pytest.mark.parametrize("exp", ["dreamer_v2", "dreamer_v2_ms_pacman", "ppo"])
def test_compose_matches_jax_for_each_override_form(exp, form):
    assert _compare([f"exp={exp}"] + OVERRIDE_FORMS[form]) is not None


def test_compose_errors_match_jax():
    for overrides in (["exp=no_such_exp"], [], ["exp=dreamer_v2", "not_an_override"]):
        with pytest.raises(Exception) as ours:
            compose(overrides=overrides)
        with pytest.raises(Exception) as theirs:
            jax_compose(overrides=overrides)
        assert type(ours.value) is type(theirs.value)


def test_dreamer_v2_config_is_a_compose_of_the_exp():
    cfg = dreamer_v2_config(seed=7, **{"algo.dense_units": 32})
    want = compose(overrides=["exp=dreamer_v2_ms_pacman", "seed=7", "algo.dense_units=32"])
    assert _without_run_name(cfg.as_dict()) == _without_run_name(want.as_dict())
    assert cfg.algo.world_model.encoder.dense_units == 32  # the interpolation follows the root
    with pytest.raises(KeyError):
        dreamer_v2_config(**{"algo.not_a_field": 1})
