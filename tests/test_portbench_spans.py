"""``portbench/spans.py``: the device attribution to host spans from any
thread and the idle labels on made-up events, the readers of the
program's spans and counter in a tiny traced run of each cell on the
CPU, and the names those readers read against the port's source.

The runs go through a subprocess: the harness refuses a process in which
JAX is loaded, as it is in this one."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from portbench import spans, tracing
from portbench.tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
PROGRAM_SOURCES = ("program_span", "program_counter")


def test_device_by_span_charges_launches_from_any_thread():
    # a root span [10, 40) on the main thread, a nested span [12, 20);
    # kernels launched at 15 (inside both: the autograd thread's launch
    # counts too, whatever its thread), at 25 (root only) and at 40 (the
    # root's end: outside)
    host = [(10.0, 40.0, "step"), (12.0, 20.0, "step.backward")]
    kernels = [(15.0, 3.0), (25.0, 5.0), (40.0, 7.0), (9.0, 11.0)]
    got = spans.device_by_span(host, kernels)
    assert got == {"step": pytest.approx(8e-6),
                   "step.backward": pytest.approx(3e-6)}


def test_device_by_span_counts_a_kernel_once_a_name():
    # two spans of one name overlapping across threads
    host = [(0.0, 10.0, "render.field"), (5.0, 15.0, "render.field")]
    assert spans.device_by_span(host, [(7.0, 2.0), (14.0, 1.0)]) == {
        "render.field": pytest.approx(3e-6)}


def test_a_gap_goes_to_the_program_span_inside_the_harness_span():
    cpu = [(0.0, 100.0, "portbench.step (between operations)"),
           (10.0, 60.0, "step (between operations)"),
           (30.0, 31.0, "aten::add")]
    gaps = [(20.0, 30.0), (70.0, 80.0), (31.0, 33.0)]
    assert tracing.label_gaps(gaps, cpu) == [
        ["step (between operations)", pytest.approx(12e-6)],
        ["portbench.step (between operations)", pytest.approx(10e-6)]]
    idle = spans.idle_by_label(gaps, cpu, roots=[(10.0, 60.0)])
    assert idle["by_label"] == dict(tracing.label_gaps(gaps, cpu))
    assert idle["inside_s"] == pytest.approx(12e-6)
    assert idle["inside_root_self_s"] == pytest.approx(12e-6)
    assert idle["outside_s"] == pytest.approx(10e-6)


_RUNS = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness, spans
from f2nerf_tpu_torch.utils import trace
for cell in {cells!r}:
    trace.reset()
    rc = harness.main(["--workload", cell, "--seed", "2147483711",
                       "--seconds", "0.3", "--trace", "1"],
                      device="cpu", root={checkout!r})
    assert rc == 0, (cell, rc)
trace.reset()
rc = spans.main(["--workload", "occ-localize", "--seed", "4100000107",
                 "--seconds", "0.3"], device="cpu", root={checkout!r})
assert rc == 0, rc
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The result lines of a traced run of each cell, then the result
    line and the attribution line of ``spans.py`` on the frame cell."""
    checkout = helpers.tiny_checkout(tmp_path_factory.mktemp("spans"))
    code = _RUNS.format(root=str(ROOT), cells=list(helpers.CELLS),
                        checkout=str(checkout))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=checkout)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert len(lines) == len(helpers.CELLS) + 2
    return dict(zip(helpers.CELLS, lines)), lines[-2], lines[-1]


def _reader(name: str) -> pathlib.Path:
    return ROOT / "portbench" / "metrics" / f"{name}.py"


def _new_metrics(cell):
    """The cell's metrics read through ``portbench/spans.py``."""
    return [m for m in SPEC["per_layer"] if cell in m.get("workloads", ())
            and "import spans" in _reader(m["name"]).read_text()]


# counters only a run on a card gives: the train step's CUDA graphs
# engage on a CUDA device alone, so a CPU run leaves the metric out
CARD_ONLY = ("graph_share.train",)


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_a_tiny_traced_run_reads_the_program_metrics(runs, cell):
    got = runs[0][cell]["metrics"]
    metrics = _new_metrics(cell)
    assert metrics
    for m in metrics:
        if m["name"] in CARD_ONLY:
            assert m["name"] not in got, m["name"]
            continue
        value = got[m["name"]]["value"]
        if m["name"].startswith("live_share."):
            assert 0.0 < value <= 100.0, m["name"]
        else:
            assert value > 0.0, m["name"]


def test_the_attribution_run(runs):
    _, result, att = runs
    assert result["correct"] is True
    assert att["root"] == "serve.localize"
    for name in ("serve.localize", "serve.resize", "serve.render_reply",
                 "serve.score", "serve.reply", "localize.draw",
                 "localize.weigh", "localize.fuse", "render.sample",
                 "render.field", "render.shade", "render.composite",
                 "portbench.frame"):
        assert att["spans"][name]["calls"] >= 1, name
        assert att["spans"][name]["host_ms"] > 0.0, name
    assert att["spans"]["render.field"]["calls"] == 2 * att["units"]
    idle = att["idle"]
    # no card: the whole window is idle, every gap labelled once
    assert sum(idle["by_label"].values()) == pytest.approx(
        att["window_s"], rel=1e-6)
    assert idle["inside_s"] + idle["outside_s"] == pytest.approx(
        att["window_s"], rel=1e-6)
    assert 0.0 < att["counts"][spans.LIVE] <= att["counts"][spans.SLOTS]


def test_readers_give_nothing_without_the_program_module(monkeypatch):
    class Ctx:
        trace, work, units = object(), {"unit": "step"}, 4

    monkeypatch.setattr(spans, "_program_trace", lambda: None)
    assert spans.host_ms(Ctx, "step", "step.forward") is None
    assert spans.live_share(Ctx, "step") is None
    assert spans.host_ms(Ctx, "frame", "serve.resize") is None


def _read_names(path: pathlib.Path) -> set[str]:
    """The string arguments of the calls in a reader, less the unit."""
    return {arg.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Call) for arg in node.args
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str)
            } - {"frame", "step"}


@pytest.mark.parametrize("metric", [
    m["name"] for m in SPEC["per_layer"]
    if m["source"] in PROGRAM_SOURCES])
def test_each_program_name_a_reader_reads_is_in_the_port(metric):
    entry = next(m for m in SPEC["per_layer"] if m["name"] == metric)
    names = _read_names(_reader(metric))
    if entry["source"] == "program_counter":
        names = {spans.LIVE, spans.SLOTS}
    assert names
    source = "\n".join(p.read_text() for p in
                       (ROOT / "f2nerf_tpu_torch").rglob("*.py"))
    for name in names:
        assert f'"{name}"' in source, (metric, name)
