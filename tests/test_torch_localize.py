"""Port parity for the localizer and its service as a whole: mode 0
(particle search) and the pose gradient of modes 1 and 2 (differential
pose refinement), f2nerf_tpu_torch against f2nerf_tpu on the CPU, with
converted JAX params, one seeded occupancy grid and the same host seed
on both sides. The differential modes' runs are in
``test_torch_localize_diff.py``.

Tolerances: particles are drawn by the same numpy Generator, so they
are bitwise equal; particle weights atol 1e-4 (softmax of -5 log loss:
a relative loss difference e moves a weight by ~5e); fused pose atol
1e-4; score rtol 1e-3. The pose gradient atol 1e-4 x its largest entry
and the loss rtol 1e-5 (f32 sums in another order, amplified by the
finest level's scale of 1024).
"""

import dataclasses
import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.apps import serve as jserve
from f2nerf_tpu.core import cameras as jcams
from f2nerf_tpu.localize import localizer as jloc
from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.utils.image_io import resize_image as jresize
from f2nerf_tpu_torch.apps import serve as tserve
from f2nerf_tpu_torch.convert import flatten, tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.localize import localizer as tloc
from f2nerf_tpu_torch.models import occupancy as tocc
from f2nerf_tpu_torch.utils.image_io import resize_image as tresize

H, W = 24, 24
INTR = np.array([[30.0, 0, 12], [0, 30.0, 12], [0, 0, 1]], np.float32)
CENTER = np.array([0.1, -0.2, 0.05], np.float32)
RADIUS = 1.5


def _make_scene(cfg, seed):
    params, consts = jrend.init(jax.random.key(seed), cfg.model, 4)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 6.0    # opaque enough to see structure
    g = cfg.model.occ_grid_res
    thresh = jocc.sigma_threshold(cfg.model)
    dense = (rng.random((g, g, g)) < 0.25).astype(np.float32) * 2 * thresh
    grid = np.stack([dense, dense])
    tcfg = TConfig.from_dict(dataclasses.asdict(cfg))

    def make(seed):
        jl = jloc.Localizer(jax.tree.map(jnp.asarray, tree), consts, cfg,
                            INTR, CENTER, RADIUS, H, W,
                            occ_bits=jocc.occ_values(jnp.asarray(grid),
                                                     cfg.model),
                            seed=seed)
        tl = tloc.Localizer(tree_from_numpy(tree, "cpu"), tcfg, INTR,
                            CENTER, RADIUS, H, W,
                            occ_vals=tocc.occ_values(torch.from_numpy(grid),
                                                     tcfg.model),
                            seed=seed, device="cpu")
        return jl, tl

    jl, tl = make(0)
    pose0 = np.eye(3, 4, dtype=np.float32)
    pose0[:, 3] = [0.05, 0.0, 0.3]
    offset = pose0.copy()
    offset[:3, :3] = jloc._euler_rotations(np.deg2rad([1.0, -2.0, 1.5])) \
        @ offset[:3, :3]
    offset[:, 3] += [0.02, -0.01, 0.03]
    image = np.asarray(jl.render_image(offset))
    return dict(make=make, tree=tree, grid=grid, jcfg=cfg, tcfg=tcfg,
                jl=jl, tl=tl, pose0=pose0, image=image)


@pytest.fixture(scope="module")
def scene(occ_cfg):
    """The occupancy-sampler scene; its ``jl`` is the module's one JAX
    Localizer for the differential modes (each instance compiles its
    steps)."""
    return _make_scene(occ_cfg, 3)


@pytest.fixture(scope="module")
def dense_scene(tiny_cfg):
    return _make_scene(tiny_cfg, 4)


def test_render_image(scene):
    img_t = scene["tl"].render_image(scene["pose0"]).numpy()
    img_j = np.asarray(scene["jl"].render_image(scene["pose0"]))
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    assert img_t.std() > 1e-2


def test_evaluate_poses(scene):
    jl, tl = scene["make"](5)
    rng = np.random.default_rng(6)
    poses = np.stack([scene["pose0"]] * 6)
    poses[:, :, 3] += rng.normal(0, 0.03, (6, 3)).astype(np.float32)
    w_j = jl.evaluate_poses(poses, scene["image"])
    w_t = tl.evaluate_poses(poses, scene["image"])
    np.testing.assert_allclose(w_t, w_j, atol=1e-4)
    assert abs(w_t.sum() - 1.0) < 1e-5 and w_t.max() > 2 * w_t.min()


def test_random_search_and_average(scene):
    jl, tl = scene["make"](7)
    pj = jl.optimize_pose_by_random_search(scene["pose0"], scene["image"],
                                           16, 1.5)
    pt = tl.optimize_pose_by_random_search(scene["pose0"], scene["image"],
                                           16, 1.5)
    assert len(pt) == len(pj) == 16
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_allclose([p.weight for p in pt],
                               [p.weight for p in pj], atol=1e-4)
    np.testing.assert_allclose(tloc.calc_average_pose(pt),
                               jloc.calc_average_pose(pj), atol=1e-4)
    # the port's own copy of the averaging agrees exactly on one input
    np.testing.assert_array_equal(tloc.calc_average_pose(pj),
                                  jloc.calc_average_pose(pj))


def test_quaternion_helpers_match():
    rng = np.random.default_rng(8)
    for theta in rng.uniform(-3, 3, (10, 3)):
        r = jloc._euler_rotations(theta)
        np.testing.assert_array_equal(tloc._euler_rotations(theta), r)
        np.testing.assert_array_equal(tloc.matrix_to_quat_xyzw(r),
                                      jloc.matrix_to_quat_xyzw(r))
        q = jloc.matrix_to_quat_xyzw(r)
        np.testing.assert_array_equal(tloc.quat_xyzw_to_matrix(q),
                                      jloc.quat_xyzw_to_matrix(q))


def test_service_mode0_request(scene):
    jl, tl = scene["make"](11)
    js, ts = jserve.LocalizerService(jl), tserve.LocalizerService(tl)
    world = jl.camera2world(scene["pose0"])
    np.testing.assert_allclose(tl.camera2world(scene["pose0"]), world,
                               atol=1e-6)
    for s in (js, ts):
        assert s.handle({"cmd": "init_pose", "pose": world.tolist()})["ok"]
    req = {"cmd": "localize", "image": scene["image"].tolist(), "mode": 0,
           "particle_num": 16}
    rj, rt = js.handle(req), ts.handle(req)
    assert rt["ok"] and rj["ok"]
    np.testing.assert_allclose(rt["pose"], rj["pose"], atol=1e-4)
    np.testing.assert_allclose(rt["score"], rj["score"], rtol=1e-3)
    assert rt["noise_coeff"] == rj["noise_coeff"]
    st = ts.handle({"cmd": "status"})
    assert st["ok"] and st["frames"] == 1 and st["initialized"]
    assert st["previous_score"] == rt["score"]


def _jax_pose_loss_and_grad(s, pose):
    """jax.value_and_grad of the differential loss, composed from the
    JAX package's public pieces (rays_from_pose, a VALIDATE render),
    run eagerly on the occupancy scene: under jit, XLA's fusion moves
    sample positions by an ulp, which there moves a sample across a
    fine-level cell edge, where the point gradient jumps."""
    jl = s["jl"]
    ij = jnp.asarray(jcams.pixel_grid(H, W))
    gt = jnp.asarray(s["image"].reshape(H * W, 3))

    def loss_fn(p):
        o, d = jcams.rays_from_pose(p[None], jl.intrinsic[None], ij)
        res = jrend.render(jl.params, jl.consts, o, d, None, s["jcfg"].model,
                           None, train=False, occ_bits=jl.occ_bits)
        return jnp.sum((res.colors - gt) ** 2) / (H * W * 3)

    grad_fn = jax.value_and_grad(loss_fn)
    if s["jcfg"].model.sampler_mode == "dense":
        grad_fn = jax.jit(grad_fn)      # no such flip on the dense scene
    loss, g = grad_fn(jnp.asarray(pose))
    return float(loss), np.asarray(g)


@pytest.mark.parametrize("which", ["dense_scene", "scene"])
def test_pose_gradient(which, request):
    """The pose gradient through the whole VALIDATE render (rays, sampler,
    contraction, encode point gradient, shader, compositing) against
    jax.grad: loss rtol 1e-5, gradient atol 1e-4 x its largest entry."""
    s = request.getfixturevalue(which)
    loss_j, g_j = _jax_pose_loss_and_grad(s, s["pose0"])
    loss_t, g_t = s["tl"].pose_gradient(s["pose0"], s["image"])
    assert g_t.shape == (3, 4) and np.abs(g_j).max() > 0
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())


def _rpc(f, req):
    f.write(json.dumps(req) + "\n")
    f.flush()
    return json.loads(f.readline())


def test_tcp_round_trip(scene, tmp_path):
    _, tl = scene["make"](13)
    srv = tserve.serve(tl, port=0, save_particles_dir=str(tmp_path))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with socket.create_connection(srv.server_address, timeout=120) as s:
            f = s.makefile("rw")
            assert not _rpc(f, {"cmd": "status"})["initialized"]
            r = _rpc(f, {"cmd": "localize",
                         "image": scene["image"].tolist()})
            assert not r["ok"] and "init_pose" in r["error"]
            world = tl.camera2world(scene["pose0"])
            assert _rpc(f, {"cmd": "init_pose", "pose": world.tolist()})["ok"]
            # a frame at twice the resolution is resized on the way in
            big = np.repeat(np.repeat(scene["image"], 2, 0), 2, 1)
            r = _rpc(f, {"cmd": "localize", "image": big.tolist(),
                         "mode": 0, "particle_num": 8,
                         "return_image": True})
            assert r["ok"] and np.isfinite(r["score"]) and r["score"] > 0
            assert np.asarray(r["pose"]).shape == (4, 4)
            assert np.asarray(r["rendered"]).shape == (H, W, 3)
            assert _rpc(f, {"cmd": "status"})["frames"] == 1
            assert _rpc(f, {"cmd": "shutdown"})["shutdown"]
        t.join(timeout=30)
        assert not t.is_alive()
        assert len(list(tmp_path.glob("*.tsv"))) == 1
    finally:
        srv.server_close()


@pytest.mark.parametrize("src,dst", [((48, 64), (24, 32)),
                                     ((50, 70), (24, 32)),
                                     ((850, 1920), (106, 240))])
def test_resize_image_vs_pil(src, dst):
    """PIL and torch both quantize to uint8; their antialiased bilinear
    filters differ by rounding, measured at most 1 level of 255 here."""
    rng = np.random.default_rng(src[0])
    base = rng.random((src[0] // 10 + 2, src[1] // 10 + 2, 3))
    img = np.asarray(torch.nn.functional.interpolate(
        torch.from_numpy(base).permute(2, 0, 1)[None], size=src,
        mode="bilinear", align_corners=False)[0].permute(1, 2, 0),
        dtype=np.float32)
    img = np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(
        np.float32)
    out_t, out_j = tresize(img, *dst), jresize(img, *dst)
    assert out_t.shape == out_j.shape == (*dst, 3)
    assert np.abs(out_t - out_j).max() <= 1.0 / 255 + 1e-6
    assert np.abs(out_t - out_j).mean() < 0.2 / 255


def test_from_checkpoint(scene, tmp_path):
    cfg = scene["jcfg"]
    cfg.save(tmp_path / "train_config.yaml")
    lines = ["%YAML 1.2", "---", "n_images: 4", f"height: {H}",
             f"width: {W}",
             "intrinsic: [" + ", ".join(f"{v:.6f}" for v in INTR.ravel())
             + "]",
             "normalizing_center: [" + ", ".join(f"{v:.6f}" for v in CENTER)
             + "]",
             f"normalizing_radius: {RADIUS:.6f}"]
    (tmp_path / "inference_params.yaml").write_text("\n".join(lines) + "\n")
    flat = flatten(scene["tree"])
    flat["occ_grid"] = scene["grid"]
    np.savez(tmp_path / "torch_params.npz", **flat)
    tl = tloc.Localizer.from_checkpoint(tmp_path, device="cpu")
    tl._rng = np.random.default_rng(0)
    _, ref = scene["make"](0)
    np.testing.assert_allclose(
        tl.evaluate_poses(np.stack([scene["pose0"]] * 3), scene["image"]),
        ref.evaluate_poses(np.stack([scene["pose0"]] * 3), scene["image"]),
        atol=1e-6)
    assert tl.device.type == "cpu"


def test_localizer_needs_a_card_by_default(scene):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tloc.Localizer(tree_from_numpy(scene["tree"], "cpu"),
                       scene["tcfg"], INTR, CENTER, RADIUS, H, W)
