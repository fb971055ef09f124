"""Port parity for the localizer through the perspective warp: mode 0's
particle weights and the differential modes' pose gradient,
``f2nerf_tpu_torch.localize`` against ``f2nerf_tpu.localize`` on the CPU
with the scene of ``test_torch_warp.py`` (``tiny_cfg`` with the warp
tables of ``sphere_ds``, O(1) features), the JAX side eager.

Tolerances (those of ``tests/test_torch_localize.py``), with the
errors measured when they were set: renders atol 1e-5; particles bitwise
(one numpy Generator on each side); particle weights and the fused pose
atol 1e-4 (2.8e-6, 1.8e-7); the differential loss rtol 1e-5 (3.8e-7)
and its pose gradient atol 1e-4 x its largest entry (3.0e-5).

Then a warp run directory of the port's CLI on the CPU: ``train``,
``test``, ``render`` and ``infer`` through ``apps.main``, and one
request of each mode through the service.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_warp import ATOL, H, INTR, W, _setup, _warp

from f2nerf_tpu.core import cameras as jcams
from f2nerf_tpu.localize import localizer as jloc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu_torch.apps import main as tcli
from f2nerf_tpu_torch.apps import serve as tserve
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
from f2nerf_tpu_torch.localize import localizer as tloc
from f2nerf_tpu_torch.models import warp as twarp
from f2nerf_tpu_torch.train import checkpoint as tckpt


@pytest.fixture(scope="module")
def dense(tiny_cfg, sphere_ds):
    return _setup(_warp(tiny_cfg), sphere_ds.poses, 0)


def _localizers(s, seed):
    jl = jloc.Localizer(s["jp"], s["jc"], s["jcfg"], INTR, np.zeros(3), 1.0,
                        H, W, seed=seed)
    tl = tloc.Localizer(s["tp"], s["tcfg"], INTR, np.zeros(3), 1.0, H, W,
                        seed=seed, device="cpu", consts=s["tc"])
    return jl, tl


def _pose0():
    pose = np.eye(3, 4, dtype=np.float32)
    pose[:, 3] = [0.05, 0.0, 0.3]
    return pose


def _frame(jl):
    """A frame rendered 1-3 cm and 1-2 degrees away from ``_pose0``."""
    target = _pose0()
    target[:3, :3] = jloc._euler_rotations(np.deg2rad([1.0, -2.0, 1.5])) \
        @ target[:3, :3]
    target[:, 3] += [0.02, -0.01, 0.03]
    return np.asarray(jl.render_image(target))


def test_localizer_mode0_scores(dense):
    """Mode 0's particle weights and fused pose with the same particles
    and pixels on both sides."""
    jl, tl = _localizers(dense, 7)
    image = _frame(jl)
    np.testing.assert_allclose(tl.render_image(_pose0()).numpy(),
                               np.asarray(jl.render_image(_pose0())),
                               atol=ATOL)
    pj = jl.optimize_pose_by_random_search(_pose0(), image, 16, 1.5)
    pt = tl.optimize_pose_by_random_search(_pose0(), image, 16, 1.5)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.pose, b.pose)
    w_t, w_j = [p.weight for p in pt], [p.weight for p in pj]
    np.testing.assert_allclose(w_t, w_j, atol=1e-4)
    assert max(w_t) > 2 * min(w_t)
    np.testing.assert_allclose(tloc.calc_average_pose(pt),
                               jloc.calc_average_pose(pj), atol=1e-4)


def test_pose_gradient_through_warp(dense):
    """The differential loss and its pose gradient (rays, sampler, warp,
    encode point gradient, shader, compositing) against eager
    jax.value_and_grad."""
    jl, tl = _localizers(dense, 0)
    image = _frame(jl)
    ij = jnp.asarray(jcams.pixel_grid(H, W))
    gt = jnp.asarray(image.reshape(H * W, 3))

    def loss_fn(p):
        o, d = jcams.rays_from_pose(p[None], jl.intrinsic[None], ij)
        res = jrend.render(jl.params, jl.consts, o, d, None,
                           dense["jcfg"].model, None, train=False)
        return jnp.sum((res.colors - gt) ** 2) / (H * W * 3)

    loss_j, g_j = jax.value_and_grad(loss_fn)(jnp.asarray(_pose0()))
    loss_t, g_t = tl.pose_gradient(_pose0(), image)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())


# -- a warp run directory through the CLI and the service ---------------------


@pytest.fixture(scope="module")
def warp_run(tiny_cfg, tmp_path_factory):
    """``apps.main train`` on a 4-view 16x16 sphere with ``tiny_cfg`` in
    perspective mode (the warp chosen in ``train_config.yaml``)."""
    root = tmp_path_factory.mktemp("warp_cli")
    data, run = root / "data", root / "run"
    run.mkdir()
    ds = make_sphere_dataset(n_images=4, h=16, w=16)
    tdata.save_dataset(ds, data)
    cfg = _warp(tiny_cfg)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, end_iter=6, report_freq=3, save_freq=6, vis_freq=6))
    TConfig.from_dict(dataclasses.asdict(cfg)).save(run / "train_config.yaml")
    tcli.main(["train", str(run), str(data), "--device", "cpu"])
    return run, data, ds


def test_cli_on_a_warp_run(warp_run, tmp_path, monkeypatch):
    """train wrote the tables into its checkpoint; test, render and
    infer read them back through ``Localizer.from_checkpoint``."""
    run, data, ds = warp_run
    state = tckpt.restore(run / "checkpoints")
    ref = twarp.build_warp(ds.poses, TConfig.load(
        run / "train_config.yaml").model)
    np.testing.assert_array_equal(
        state["consts"]["field/warp_rows"].numpy(), ref.rows)
    assert not any("warp" in k for k in state["params"])
    cpu = ["--device", "cpu"]
    tcli.main(["test", str(run), str(data), *cpu])
    assert (run / "test_result" / "summary.tsv").is_file()
    np.save(tmp_path / "poses.npy", ds.poses[:2])
    tcli.main(["render", str(run), str(tmp_path / "poses.npy"),
               str(tmp_path / "out"), *cpu])
    assert len(list((tmp_path / "out").glob("*.png"))) == 2
    real_load = tdata.load_dataset

    def load_one(d):
        full = real_load(d)
        return dataclasses.replace(
            full, poses=full.poses[:1], intrinsics=full.intrinsics[:1],
            dist_params=full.dist_params[:1], bounds=full.bounds[:1],
            images=full.images[:1])

    monkeypatch.setattr(tdata, "load_dataset", load_one)
    tcli.main(["infer", str(run), str(data), "4", *cpu])
    rows = (run / "inference_result" / "0000" / "position.tsv").read_text()
    assert len(rows.splitlines()) == 1 + 1 + 8 + 8 * 10


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_service_on_a_warp_run(warp_run, mode):
    """One request of each mode from a 2 cm offset, through the service
    on the run directory."""
    run, _, ds = warp_run
    loc = tloc.Localizer.from_checkpoint(
        run, tloc.LocalizerParam(resize_factor=1), device="cpu")
    assert set(loc.consts["field"]) == {"warp_anchors", "warp_rows"}
    svc = tserve.LocalizerService(loc)
    world = loc.camera2world(ds.poses[1])
    world[:3, 3] += [0.012, -0.008, 0.014]
    assert svc.handle({"cmd": "init_pose", "pose": world.tolist()})["ok"]
    r = svc.handle({"cmd": "localize", "image": ds.images[1].tolist(),
                    "mode": mode, "particle_num": 8, "search_rounds": 1,
                    "diff_iters": 2})
    assert r["ok"], r
    pose = np.asarray(r["pose"])
    assert pose.shape == (4, 4) and np.isfinite(pose).all()
    assert np.isfinite(r["score"]) and r["score"] > 0
    assert ("diff_loss" in r) == (mode == 2)
