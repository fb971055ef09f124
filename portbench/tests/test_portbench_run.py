"""Runs of every cell on the CPU at a tiny size: the result line's keys
and order, ``correct``, the traced run's keys, the refusal without a
card, and the isolation of the run from JAX and the JAX package."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests import helpers

ROOT = pathlib.Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return helpers.tiny_checkout(tmp_path_factory.mktemp("run"))


@pytest.mark.parametrize("cell", helpers.TINY_CELLS)
def test_untraced_run(checkout, cell):
    rc, result, err = helpers.run_cpu(checkout, cell, seed=2 ** 31 + 11)
    assert rc == 0, err
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    assert set(result["metrics"]) == {
        m["name"] for m in harness.end_to_end_for(spec, cell)}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    limits = json.loads((checkout / "portbench" / "limits"
                         / f"{cell}.json").read_text())
    assert set(result["checks"]) == set(limits)
    tail = err.strip().splitlines()[-len(limits):]
    assert [ln.split(":")[0] for ln in tail] == [f"check {k}" for k in limits]


@pytest.mark.parametrize("cell", helpers.TINY_CELLS)
def test_traced_run(checkout, cell):
    rc, result, err = helpers.run_cpu(checkout, cell, seed=5, trace=1)
    assert rc == 0, err
    assert result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10
    spec = json.loads((checkout / "BENCHMARK.json").read_text())
    names = {m["name"] for m in harness.per_layer_for(spec, cell)}
    assert set(result["metrics"]) <= names
    # no card: no kernels and no launches to read, nothing above 100%
    for name, m in result["metrics"].items():
        assert "roofline" not in name and "mfu" not in name


def test_the_same_seed_gives_the_same_inputs(checkout):
    a = helpers.run_cpu(checkout, "occ-train", seed=99)[1]["checks"]
    b = helpers.run_cpu(checkout, "occ-train", seed=99)[1]["checks"]
    assert a == b


def test_refused_without_a_card(checkout):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    err = subprocess.run(
        [sys.executable, str(checkout / "portbench" / "run.py"),
         "--workload", "occ-train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=checkout, capture_output=True, text=True,
        timeout=300)
    assert err.returncode == 2 and err.stdout == ""


def test_refused_in_a_folder_of_the_benchmark_alone(tmp_path):
    import shutil

    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "occ-train",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and not res.stdout.strip()


_PROBE = """
import json, pathlib, sys
sys.path.insert(0, {root!r})
from portbench import harness
from portbench.tests import helpers
import importlib
for mod in ("common", "checks", "inputs", "tracing", "readers", "work",
            "drive_frames", "drive_train", "control", "faults",
            "reference.field",
            "reference.train", "reference.localize", "reference.sh"):
    importlib.import_module("portbench." + mod)
pb = pathlib.Path({pb!r})
for folder in ("metrics", "counts"):
    for path in sorted((pb / folder).glob("*.py")):
        harness.load_module(path)
root = helpers.tiny_tree(pathlib.Path({tmp!r}))
rc = harness.main(["--workload", {cell!r}, "--seed", "3", "--seconds",
                   "0.2", "--trace", "1"], device="cpu", root=root)
print(json.dumps({{"rc": rc, "modules": sorted(sys.modules)}}))
"""


@pytest.mark.parametrize("cell", ["occ-localize", "occ-train"])
def test_no_jax_nor_the_jax_package(tmp_path, cell):
    code = _PROBE.format(root=str(ROOT), pb=str(PB),
                         tmp=str(tmp_path / "c"), cell=cell)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    probe = json.loads(res.stdout.strip().splitlines()[-1])
    assert probe["rc"] == 0
    tops = {m.split(".", 1)[0] for m in probe["modules"]}
    assert not tops & {"jax", "jaxlib", "flax", "f2nerf_tpu"}
    assert "f2nerf_tpu_torch" in tops


def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & {"f2nerf_tpu_torch", "f2nerf_tpu", "jax",
                                 "jaxlib", "flax"}


@pytest.mark.cuda
def test_a_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "occ-localize",
         "--seed", "17", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
