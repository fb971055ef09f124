"""BENCHMARK.json against the benchmark's contract, every file found by
name, each count at a hand-checked shape, the trace reduction on a
made-up trace, and a later PR's way of adding a cell: new files and new
entries only."""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import statistics

import pytest

from portbench import harness, tracing, work
from portbench.tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj"
                    r"|head|expansion|experts_per_tok")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    assert SPEC["paths"] == ["portbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_single_lines(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for entry in SPEC[kind]:
        assert NAME.match(entry["name"]), entry["name"]
        for key in ("why", "layer", "source"):
            if key in entry:
                text = entry[key]
                assert 1 <= len(text) <= 200 and "\n" not in text \
                    and "\t" not in text, (entry["name"], key)
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
        if "better" in entry:
            assert entry["better"] in ("lower", "higher")


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for conf in SPEC["configs"]:
        assert set(conf) == {"name", "source", "file", "reduced", "why"}
        assert conf["name"] in used
        assert conf["file"].startswith("portbench/")
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["name"] == conf["name"]
        assert len(conf["reduced"]) <= 16
        for key in conf["reduced"]:
            assert NAME.match(key) and not WIDTHS.search(key), key
        assert sorted(conf["reduced"]) == sorted(data["reduced"])


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf, layer


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in harness.end_to_end_for(SPEC, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer_for(SPEC, cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", helpers.CELLS)
def test_each_piece_is_found_by_name(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.mix["kind"] in ("frames", "train")
    assert (PB / f"drive_{c.mix['kind']}.py").is_file()
    assert c.limits
    for m in harness.per_layer_for(SPEC, cell):
        reader = harness.load_module(PB / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


@pytest.mark.parametrize("kernel", ["trilinear_fwd", "trilinear_bwd",
                                    "trilinear_bwd_frac", "train_step",
                                    "localize_frame"])
def test_each_count_is_found_by_name(kernel):
    mod = harness.load_module(PB / "counts" / f"{kernel}.py")
    assert callable(mod.count)


# -- counts at hand-checked shapes -------------------------------------------

SHAPES = {"samples_per_ray": 4, "levels": 2, "channels": 4, "feat_dim": 16,
          "sh_dim": 16, "shader_hidden": 64}


def _count(name, **w):
    return harness.load_module(PB / "counts" / f"{name}.py").count(
        {**SHAPES, **w})


def test_forward_count_of_a_mode0_frame():
    # 2 frames x (3 particle rays + 5 frame rays) x 4 samples = 64 samples
    c = _count("trilinear_fwd", unit="frame", units=2, mode=0,
               particle_rays=3, frame_rays=5)
    assert c["flops"] == 64 * 2 * (19 + 8 * 2 * 4)
    assert c["bytes"] == 64 * (12 + 2 * 4 * 4)


def test_forward_count_of_steps_with_a_refresh():
    # 3 steps x 10 rays x 4 samples + 1 refresh x 100 points
    c = _count("trilinear_fwd", unit="step", units=3, rays=10,
               refresh_steps=1, refresh_points=100, param_count=0)
    assert c["flops"] == 220 * 2 * 83 and c["bytes"] == 220 * 44
    b = _count("trilinear_bwd", unit="step", units=3, rays=10,
               refresh_steps=1, refresh_points=100, param_count=0)
    assert b["flops"] == 120 * 2 * 83 and b["bytes"] == 120 * 44


def test_point_gradient_count_of_mode1_frames():
    c = _count("trilinear_bwd_frac", unit="frame", units=1, mode=1,
               particle_rays=0, frame_rays=5)
    assert c["flops"] == 20 * 2 * (6 + 8 * 17)
    assert c["bytes"] == 20 * (24 + 2 * 4 * 4)
    assert _count("trilinear_bwd_frac", unit="frame", units=1, mode=0,
                  particle_rays=3, frame_rays=5)["flops"] == 0


def test_whole_step_count():
    c = _count("train_step", unit="step", units=1, rays=1, refresh_steps=0,
               refresh_points=0, param_count=10)
    mm = 2 * (2 * 4 * 16 + 32 * 64 + 64 * 3)
    fwd = 2 * 83 + mm + 3 * 16 + work.POINTWISE_FLOPS
    assert c["flops"] == 4 * (fwd + 2 * 83 + 2 * mm + work.POINTWISE_FLOPS) \
        + 10 * 12
    assert c["bytes"] == 2 * 4 * 44 + 10 * 28


# -- the trace reduction -----------------------------------------------------

def test_union_and_gaps():
    iv = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]
    assert tracing.union_s(iv) == pytest.approx(30e-6)
    assert tracing.gaps(iv, -5.0, 50.0) == [(-5.0, 0.0), (20.0, 30.0),
                                            (40.0, 50.0)]


def test_gaps_are_labelled_by_the_innermost_host_operation():
    cpu = [(0.0, 100.0, "outer"), (18.0, 32.0, "inner")]
    labels = tracing.label_gaps([(20.0, 30.0), (60.0, 70.0), (200.0, 210.0)],
                                cpu)
    assert labels == [["inner", pytest.approx(1e-5)],
                      ["outer", pytest.approx(1e-5)],
                      ["host outside any operation", pytest.approx(1e-5)]]


def test_kernel_time_by_whole_name():
    t = tracing.Trace(window_s=1.0, busy_s=0.5, launches=0, device=[
        (0.0, 10.0, "void trilinear_bwd_frac_kernel<float, 4>(...)"),
        (20.0, 25.0, "void trilinear_bwd_tiles<4>(...)"),
        (30.0, 31.0, "void trilinear_bwd_merge<float>(...)")])
    assert t.kernel_s(("trilinear_bwd_tiles", "trilinear_bwd_merge")) == \
        pytest.approx(6e-6)
    assert t.kernel_s(("trilinear_bwd_frac_kernel",)) == pytest.approx(1e-5)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert (q3 - q1) / statistics.median(values) < 0.2


# -- a later PR adds a cell by adding files and entries ----------------------

THROWAWAY_METRIC = '''"""Traced frames (the extension test's throwaway)."""


def read(ctx):
    return ctx.count("throwaway")["flops"] if ctx.trace is not None else None
'''
THROWAWAY_COUNT = '''"""One operation a traced unit (a throwaway count)."""


def count(work):
    return {"flops": work["units"], "bytes": 0}
'''


def test_a_cell_added_as_files_and_entries(tmp_path):
    root = helpers.tiny_checkout(tmp_path)
    pb = root / "portbench"
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    conf = json.loads((pb / "configs" / "f2nerf-occ.json").read_text())
    conf["name"] = "throwaway-occ"
    (pb / "configs" / "throwaway-occ.json").write_text(json.dumps(conf))
    mix = json.loads((pb / "mixes" / "node-mode0.json").read_text())
    mix["particle_num"] = 3
    (pb / "mixes" / "throwaway-mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "throwaway.frame.py").write_text(THROWAWAY_METRIC)
    (pb / "counts" / "throwaway.py").write_text(THROWAWAY_COUNT)
    shutil.copy(pb / "limits" / "occ-localize.json",
                pb / "limits" / "throwaway-cell.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway-occ", "source": "x",
                            "file": "portbench/configs/throwaway-occ.json",
                            "reduced": ["sample_near"], "why": "x"})
    spec["workloads"].append({"name": "throwaway-cell",
                              "config": "throwaway-occ",
                              "traffic": "throwaway-mix", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"].startswith("frame_ms"):
            m["workloads"].append("throwaway-cell")
    spec["per_layer"].append({"name": "throwaway.frame", "unit": "calls",
                              "better": "lower", "source": "device_trace",
                              "layer": "device", "moves": "frame_ms_p50",
                              "workloads": ["throwaway-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for path, data in before.items():
        assert path.read_bytes() == data, path
    rc, result, err = helpers.run_cpu(root, "throwaway-cell", trace=1)
    assert rc == 0, err
    assert result["correct"], result
    assert result["metrics"]["throwaway.frame"]["value"] == \
        json.loads((pb / "mixes" / "throwaway-mix.json").read_text())[
            "trace_frames"]
