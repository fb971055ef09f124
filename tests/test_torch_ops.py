"""Port parity: pointwise ops, compositing, cameras and config
(f2nerf_tpu_torch against f2nerf_tpu on the CPU).

Tolerances: fp32 elementwise chains agree to atol 1e-6 (the two
frameworks may fuse or order a few float ops differently).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.core import cameras as jcam
from f2nerf_tpu.core import config as jconfig
from f2nerf_tpu.ops import composite as jcomp
from f2nerf_tpu.ops import contraction as jcontr
from f2nerf_tpu.ops import sh as jsh
from f2nerf_tpu.ops import trunc_exp as jte
from f2nerf_tpu_torch.core import cameras as tcam
from f2nerf_tpu_torch.core import config as tconfig
from f2nerf_tpu_torch.ops import composite as tcomp
from f2nerf_tpu_torch.ops import contraction as tcontr
from f2nerf_tpu_torch.ops import sh as tsh
from f2nerf_tpu_torch.ops import trunc_exp as tte

ATOL = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("make", ["default", "tiny", "quality"])
def test_config_roundtrip(make):
    jcfg = getattr(jconfig.Config, make)() if make != "default" \
        else jconfig.Config()
    tcfg = getattr(tconfig.Config, make)() if make != "default" \
        else tconfig.Config()
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tconfig.Config.from_dict(dataclasses.asdict(jcfg)) == tcfg
    assert tcfg.model.shader_in_dim == jcfg.model.shader_in_dim
    assert tcfg.train.rays_per_step == jcfg.train.rays_per_step


def test_config_load_yaml(tmp_path):
    jcfg = jconfig.Config.tiny()
    jcfg.save(tmp_path / "train_config.yaml")
    tcfg = tconfig.Config.load(tmp_path / "train_config.yaml")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)


def test_contract_uncontract():
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(4096, 3)) * 3.0).astype(np.float32)
    for radius in (1.0, 0.5):
        c_j = np.asarray(jcontr.contract(jnp.asarray(pts), radius))
        c_t = tcontr.contract(_t(pts), radius).numpy()
        np.testing.assert_allclose(c_t, c_j, atol=ATOL)
        u_j = np.asarray(jcontr.uncontract(jnp.asarray(c_j), radius))
        u_t = tcontr.uncontract(_t(c_j), radius).numpy()
        np.testing.assert_allclose(u_t, u_j, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("degree", range(1, 9))
def test_sh_encode(degree):
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ref = np.asarray(jsh.sh_encode(jnp.asarray(d), degree))
    out = tsh.sh_encode(_t(d), degree).numpy()
    assert out.shape == ref.shape == (2048, degree * degree)
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_sh_encode_rejects_bad_degree():
    with pytest.raises(ValueError):
        tsh.sh_encode(torch.zeros(1, 3), 9)


def test_trunc_exp_value_and_grad():
    x = np.linspace(-150.0, 12.0, 977).astype(np.float32)
    g = np.random.default_rng(1).normal(size=x.shape).astype(np.float32)
    y_j = np.asarray(jte.trunc_exp(jnp.asarray(x)))
    dx_j = np.asarray(jax.grad(
        lambda v: jnp.sum(jte.trunc_exp(v) * jnp.asarray(g)))(
            jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    y_t = tte.trunc_exp(xt)
    (y_t * _t(g)).sum().backward()
    # atol 1e-37: XLA on the CPU flushes subnormal results to zero
    np.testing.assert_allclose(y_t.detach().numpy(), y_j, rtol=1e-6,
                               atol=1e-37)
    np.testing.assert_allclose(xt.grad.numpy(), dx_j, rtol=1e-6,
                               atol=1e-37)
    # the truncation itself: the gradient above x = 5 is g * e^5
    big = x > 5.0
    np.testing.assert_allclose(xt.grad.numpy()[big], g[big] * np.exp(5.0),
                               rtol=1e-6)


def test_density_activation_and_cumsum():
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(64, 32)).astype(np.float32) * 3
    np.testing.assert_allclose(
        tcomp.density_activation(_t(raw), 3.0).numpy(),
        np.asarray(jcomp.density_activation(jnp.asarray(raw), 3.0)),
        rtol=1e-6)
    # prefix sums may associate differently: a few ulp of the running sum
    np.testing.assert_allclose(
        tcomp.exclusive_cumsum(_t(raw)).numpy(),
        np.asarray(jcomp.exclusive_cumsum(jnp.asarray(raw))), atol=ATOL,
        rtol=1e-5)


def test_composite():
    rng = np.random.default_rng(3)
    r, s = 256, 48
    sec = (rng.random((r, s)) ** 3 * 1.5).astype(np.float32)
    sec[:, 0] = 0.0
    colors = rng.random((r, s, 3)).astype(np.float32)
    t = np.cumsum(rng.random((r, s)) * 0.1 + 0.01, axis=1).astype(np.float32)
    bg = rng.random((r, 3)).astype(np.float32)
    ref = jcomp.composite(jnp.asarray(sec), jnp.asarray(colors),
                          jnp.asarray(t), jnp.asarray(bg), 1e-4)
    out = tcomp.composite(_t(sec), _t(colors), _t(t), _t(bg), 1e-4)
    np.testing.assert_array_equal(out[3].numpy(), np.asarray(ref[3]))
    for o, e in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(o.numpy(), np.asarray(e), atol=ATOL,
                                   rtol=1e-6)


def _random_poses(rng, n):
    from f2nerf_tpu.localize.localizer import _euler_rotations

    rot = _euler_rotations(rng.uniform(-np.pi, np.pi, (n, 3)))
    poses = np.concatenate(
        [rot, rng.normal(size=(n, 3, 1))], axis=-1).astype(np.float32)
    return poses


def test_rays_from_pose():
    rng = np.random.default_rng(4)
    poses = _random_poses(rng, 5)
    intr = np.tile(np.array([[50.0, 0, 16], [0, 45.0, 12], [0, 0, 1]],
                            np.float32), (5, 1, 1))
    ij = rng.uniform(0, 24, (5, 300, 2)).astype(np.float32)
    o_j, d_j = jcam.rays_from_pose(jnp.asarray(poses)[:, None],
                                   jnp.asarray(intr)[:, None],
                                   jnp.asarray(ij))
    o_t, d_t = tcam.rays_from_pose(_t(poses)[:, None], _t(intr)[:, None],
                                   _t(ij))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=ATOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=ATOL)
    np.testing.assert_array_equal(tcam.pixel_grid(3, 5),
                                  jcam.pixel_grid(3, 5))


def test_world_camera_frames():
    rng = np.random.default_rng(5)
    center = rng.normal(size=3).astype(np.float32)
    radius = 2.5
    for pose in _random_poses(rng, 4):
        world = np.asarray(jcam.camera2world(jnp.asarray(pose),
                                             jnp.asarray(center), radius))
        world_t = tcam.camera2world(_t(pose), _t(center), radius).numpy()
        np.testing.assert_allclose(world_t, world, atol=1e-5)
        back_j = np.asarray(jcam.world2camera(jnp.asarray(world),
                                              jnp.asarray(center), radius))
        back_t = tcam.world2camera(_t(world), _t(center), radius).numpy()
        np.testing.assert_allclose(back_t, back_j, atol=1e-6)
        np.testing.assert_allclose(back_t, pose, atol=1e-5)
    poses = _random_poses(rng, 6)
    out_t = tcam.normalize_poses(poses)
    out_j = jcam.normalize_poses(poses)
    np.testing.assert_allclose(out_t[0], out_j[0])
    np.testing.assert_allclose(out_t[1], out_j[1])
    assert out_t[2] == out_j[2]


def _spread_inputs(seed):
    """Weights from a real composite (prefix-masked), monotone t."""
    rng = np.random.default_rng(seed)
    r, s = 64, 48
    sec = rng.uniform(0.0, 0.3, (r, s)).astype(np.float32)
    dt = rng.uniform(0.02, 0.1, (r, s)).astype(np.float32)
    dt[:, 0] = 0.0
    dt[::7, -5:] = 0.0                       # invalid tail slots
    t = np.cumsum(dt, axis=-1).astype(np.float32) + 0.1
    colors = rng.random((r, s, 3)).astype(np.float32)
    _, _, w, mask = jcomp.composite(jnp.asarray(sec * (dt > 0)),
                                    jnp.asarray(colors), jnp.asarray(t),
                                    jnp.full((r, 3), 0.5), 1e-2)
    assert 0 < float(jnp.mean(mask)) < 1
    return np.asarray(w), np.asarray(mask), t, dt


def test_weight_variance():
    w, mask, t, _ = _spread_inputs(1)
    for pos in (None, t / (1.0 / 64 * 16.0)):
        ref = np.asarray(jcomp.weight_variance(
            jnp.asarray(w), jnp.asarray(mask),
            pos=None if pos is None else jnp.asarray(pos)))
        out = tcomp.weight_variance(
            _t(w), _t(mask), pos=None if pos is None else _t(pos))
        assert out.shape == (w.shape[0],)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=ATOL)


def test_distortion_loss():
    w, mask, t, dt = _spread_inputs(2)
    ref = np.asarray(jcomp.distortion_loss(jnp.asarray(w), jnp.asarray(t),
                                           jnp.asarray(dt),
                                           jnp.asarray(mask), 4.0))
    out = tcomp.distortion_loss(_t(w), _t(t), _t(dt), _t(mask), 4.0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=ATOL)
    # and its gradient in the weights (the train step differentiates it)
    wt = _t(w).requires_grad_(True)
    tcomp.distortion_loss(wt, _t(t), _t(dt), _t(mask), 4.0).sum().backward()
    gj = jax.grad(lambda x: jnp.sum(jcomp.distortion_loss(
        x, jnp.asarray(t), jnp.asarray(dt), jnp.asarray(mask), 4.0)))(
            jnp.asarray(w))
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=ATOL)
