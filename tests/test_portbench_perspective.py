"""The benchmark's perspective field (``portbench/fields/perspective.py``)
and its plain warp reference (``portbench/reference/warp.py``) against
the port on the CPU, on the field's seeded trajectory at the tiny size
of the benchmark's tests (8 views, 8 regions of 2 cameras), at the
cell's own size (128 views, 64 regions of 4) and on
``make_corridor_dataset()`` (24 views, 24 regions of 4): the tables, the
warp, the field's query, and the warp's counters in a tiny traced run of
``persp-train``.

Tolerances, each with its reason:

* tables and trajectory: bitwise (the same float32 NumPy operations);
* warped coordinates: atol 1e-6 (measured 0 on 2e5 points): the
  reference sums each chart in the program's order, so both round
  alike; the region choices exactly;
* the warp in chunks: its values bitwise the whole's;
* the field: rtol 1e-5, atol 1e-6, those of the encode in
  ``portbench/tests/test_portbench_reference.py`` (another gather and
  order of the corner sums).

The traced run goes through a subprocess: the harness refuses a process
in which JAX is loaded, as it is in this one.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import harness, inputs
from portbench.reference import field as F
from portbench.reference import train as RT
from portbench.reference import warp as RW
from portbench.tests import helpers
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.data.synthetic import make_corridor_dataset
from f2nerf_tpu_torch.models import hash_field
from f2nerf_tpu_torch.models import warp as PW
from f2nerf_tpu_torch.ops.contraction import uncontract
from f2nerf_tpu_torch.utils import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
PB = ROOT / "portbench"
FIELD = harness.load_module(PB / "fields" / "perspective.py")
CONF = json.loads((PB / "configs" / "f2nerf-perspective.json").read_text())
MIX = json.loads((PB / "mixes" / "free-train.json").read_text())
SEED = 2 ** 31 + 11
CPU = torch.device("cpu")


def _model(size: str) -> dict:
    """The configuration's model dict at the tests' tiny size or its
    own."""
    model = dict(CONF["config"]["model"])
    if size == "tiny":
        model.update(helpers.TINY_MODEL)
        model.update(FIELD.TINY_MODEL)
    return model


def _views(size: str) -> int:
    return FIELD.TINY_MIX["train"]["images"] if size == "tiny" \
        else MIX["images"]


def _poses(which: str) -> tuple[np.ndarray, dict]:
    if which == "corridor":
        return make_corridor_dataset().poses, _model("cell")
    return FIELD.trajectory(_views(which), 5), _model(which)


def _rows(ch: RW.Charts) -> np.ndarray:
    m = ch.anchors.shape[0]
    return np.concatenate([ch.w2c.reshape(m, -1), ch.mean,
                           ch.pca.reshape(m, -1), ch.scale], axis=1)


def _tables(poses: np.ndarray, model: dict) -> PW.WarpTables:
    t = PW.build_warp(poses, F.model_ns(model))
    return PW.WarpTables(torch.tensor(t.anchors), torch.tensor(t.rows),
                         t.n_cams)


@pytest.mark.parametrize("which", ["tiny", "cell", "corridor"])
def test_the_reference_tables_are_the_programs(which):
    poses, model = _poses(which)
    ns = F.model_ns(model)
    got = PW.build_warp(poses, ns)
    ch = RW.charts(poses, ns)
    rows = _rows(ch)
    assert ch.anchors.shape[0] == min(ns.warp_n_regions, len(poses))
    assert np.array_equal(got.anchors, ch.anchors)
    assert np.array_equal(got.rows[:, :rows.shape[1]], rows)
    assert not got.rows[:, rows.shape[1]:].any()


def test_the_trajectory_is_the_corridors_path():
    ds = make_corridor_dataset(n_images=24, seed=3)
    assert np.array_equal(FIELD.trajectory(24, 3), ds.poses)
    assert np.abs(ds.poses[:, :, 3]).max() <= 1.0 + 1e-6


def _points(which: str, n: int = 20000) -> torch.Tensor:
    """Seeded points: around the cameras and up to 4 units behind and
    ahead of them, or grid-domain points in [-2, 2)^3."""
    g = torch.Generator().manual_seed(11)
    if which == "contracted":
        return torch.rand((n, 3), generator=g) * 3.9998 - 1.9999
    return torch.randn((n, 3), generator=g) * torch.tensor([0.4, 0.3, 1.6])


@pytest.mark.parametrize("blend_k", [1, 3])
@pytest.mark.parametrize("pts", ["world", "contracted"])
@pytest.mark.parametrize("which", ["tiny", "cell"])
def test_the_reference_warp_against_warp_points(which, pts, blend_k):
    poses, model = _poses(which)
    ns = F.model_ns(model)
    x = _points(pts)
    if pts == "contracted":
        world = uncontract(x, ns.contraction_radius)
        assert torch.equal(RW.uncontract(x, ns.contraction_radius), world)
        x = world
    got = PW.warp_points(x, _tables(poses, model), blend_k=blend_k)
    want = RW.warp(x, RW.charts(poses, ns), blend_k)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
    assert got.abs().max() <= RW.CLAMP


@pytest.mark.parametrize("blend_k", [1, 3])
def test_the_warp_in_chunks_is_the_whole_bit_for_bit(monkeypatch, blend_k):
    poses, model = _poses("cell")
    tables = _tables(poses, model)
    x = _points("world", 2500).requires_grad_(True)
    whole = PW.warp_points(x, tables, blend_k=blend_k)
    (g_whole,) = torch.autograd.grad(whole.square().sum(), x)
    monkeypatch.setattr(PW, "WARP_CHUNK", 1000)
    parts = PW.warp_points(x, tables, blend_k=blend_k)
    (g_parts,) = torch.autograd.grad(parts.square().sum(), x)
    assert torch.equal(parts, whole)
    # the point gradient's sums over the broadcast camera rows round by
    # the block's length on the CPU: a few ulp (measured 4.8e-6 relative
    # on 58 of 7,500 entries at blend 1, none at blend 3)
    torch.testing.assert_close(g_parts, g_whole, rtol=1e-5, atol=0.0)


def _scene(size: str):
    model = _model(size)
    mix = {**MIX, "image_hw": 16, "focal": 12.0, "images": _views(size)}
    ns = F.model_ns(model)
    return ns, model, FIELD.train_scene(ns, mix, SEED, CPU)


@pytest.mark.parametrize("contracted", [False, True])
def test_the_field_query_against_the_fields_reference(contracted):
    ns, model, scene = _scene("tiny")
    cfg = Config.from_dict(CONF["config"]).model
    cfg = dataclasses.replace(cfg, **{k: model[k] for k in (
        *helpers.TINY_MODEL, *FIELD.TINY_MODEL)})
    x = _points("contracted" if contracted else "world", 4000)
    got = hash_field.query(scene.params["field"], x, cfg,
                           pre_contracted=contracted, consts=scene.consts)
    want = FIELD.features(ns, scene)(scene.params, x, F.table_dtype(ns),
                                     contracted=contracted)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_the_scene_is_seeded_and_its_tables_are_the_trainers():
    ns, model, scene = _scene("tiny")
    again = _scene("tiny")[2]
    assert torch.equal(scene.poses, again.poses)
    poses = scene.poses.numpy()
    want = PW.warp_consts(poses, ns, CPU)["field"]
    assert set(scene.consts) == set(hash_field.WARP_KEYS)
    for k in hash_field.WARP_KEYS:
        assert torch.equal(scene.consts[k], want[k]), k
    # the trajectory's stream is not the weights' seed itself
    assert not np.array_equal(poses, FIELD.trajectory(len(poses), SEED))


def test_the_counters_act_only_under_a_profiler():
    poses, model = _poses("tiny")
    trace.reset()
    PW.warp_points(_points("world", 100), _tables(poses, model), blend_k=3)
    assert trace.counts() == {}


_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from portbench import harness
from f2nerf_tpu_torch.utils import trace
trace.reset()
rc = harness.main(["--workload", "persp-train", "--seed", "4100000123",
                   "--seconds", "0.3", "--trace", "1"], device="cpu",
                  root={checkout!r})
assert rc == 0, rc
print(json.dumps(trace.counts()))
"""


def test_a_tiny_traced_run_counts_every_warped_point(tmp_path):
    checkout = helpers.tiny_checkout(tmp_path)
    code = _RUN.format(root=str(ROOT), checkout=str(checkout))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=checkout)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    result, counts = lines[-2], lines[-1]
    assert result["correct"] is True
    conf = json.loads((checkout / "portbench" / "configs"
                       / "f2nerf-perspective.json").read_text())
    model = F.model_ns(conf["config"]["model"])
    mix = json.loads((checkout / "portbench" / "mixes"
                      / "free-train.json").read_text())
    first = inputs.first_step(model) + mix["checked_steps"]
    refreshes = sum(RT.refresh_phase(model, s) is not None
                    for s in range(first, first + mix["trace_steps"]))
    assert refreshes >= 1
    per_refresh = model.occ_grid_res ** 3 // model.occ_refresh_phases
    # the samples the field encoded, and each refresh's grid points
    assert counts["warp.points"] == (counts["render.slots"]
                                     + refreshes * per_refresh)
    assert 0 < counts["warp.clamped"] <= counts["warp.points"]
    got = result["metrics"]
    assert got["warp_host_ms.train"]["value"] > 0.0
    assert got["warp_clamp_share.train"]["value"] == pytest.approx(
        100.0 * counts["warp.clamped"] / counts["warp.points"])


@pytest.mark.parametrize("name", ["warp.points", "warp.clamped"])
def test_the_counter_names_are_in_the_port(name):
    reader = (PB / "metrics" / "warp_clamp_share.train.py").read_text()
    assert f'"{name}"' in reader
    source = "\n".join(p.read_text() for p in
                       (ROOT / "f2nerf_tpu_torch").rglob("*.py"))
    assert f'"{name}"' in source
