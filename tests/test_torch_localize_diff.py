"""Port parity for the localizer's differential modes end to end:
``optimize_pose_by_differential`` (mode 1), the staged ``localize``
(mode 2), its backtracking loop and both service modes, f2nerf_tpu_torch
against f2nerf_tpu on the CPU, on the dense scene of
``test_torch_localize`` (the pose gradient itself is held against
``jax.grad`` there).

Tolerances: Adam moves each pose entry by about lr whatever the size of
its gradient, so poses after differential steps are held within 0.01 lr
on the entries whose gradient is well above rounding, and the staged
pipeline's losses at rtol 1e-4 with the same backtracking decisions.
The scene is the dense one because the JAX steps are jitted: on the
occupancy scene jit's fusion moves a sample across a fine-level cell
edge (see ``test_torch_localize._jax_pose_loss_and_grad``). The module
shares one JAX ``Localizer``: each instance compiles its steps.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from f2nerf_tpu.apps import serve as jserve
from f2nerf_tpu_torch.apps import serve as tserve
from test_torch_localize import RADIUS, _jax_pose_loss_and_grad, _make_scene


@pytest.fixture(scope="module")
def dense_scene(tiny_cfg):
    return _make_scene(tiny_cfg, 4)


def test_optimize_pose_by_differential(dense_scene):
    """Three Adam iterations at lr 1e-4 on both sides. Each moves an
    entry by about lr whatever the size of its gradient, so the poses
    are compared within 0.01 lr, on the entries whose gradient is well
    above its rounding (the reported rotation is the initial one)."""
    lr = 1e-4
    _, g = _jax_pose_loss_and_grad(dense_scene, dense_scene["pose0"])
    res_j = dense_scene["jl"].optimize_pose_by_differential(
        dense_scene["pose0"], dense_scene["image"], 3, lr=lr)
    res_t = dense_scene["tl"].optimize_pose_by_differential(
        dense_scene["pose0"], dense_scene["image"], 3, lr=lr)
    assert len(res_t) == len(res_j) == 3
    strong = np.abs(g) > 1e-2 * np.abs(g).max()
    strong[:, :3] = False               # the rotation is reported as given
    assert strong.sum() >= 2
    for a, b in zip(res_t, res_j):
        np.testing.assert_array_equal(a[:, :3], dense_scene["pose0"][:, :3])
        np.testing.assert_allclose(a[strong], b[strong], rtol=0,
                                   atol=0.01 * lr)
    # the first step moves each entry by lr (Adam's first update is
    # lr * g / (|g| + eps))
    first = np.abs(res_t[0] - dense_scene["pose0"])[strong]
    np.testing.assert_allclose(first, lr, rtol=1e-3)


def test_localize_staged(dense_scene):
    """The real staged pipeline, small: one search round of 8 particles
    (the same draws on both sides), then 3 differential iterations."""
    jl, tl = dense_scene["jl"], dense_scene["tl"]
    kw = dict(particle_num=8, search_rounds=1, noise_coeff=1.0,
              diff_iters=3, diff_lr=3e-3)
    jl._rng, tl._rng = np.random.default_rng(21), np.random.default_rng(21)
    rj = jl.localize(dense_scene["pose0"], dense_scene["image"], **kw)
    rt = tl.localize(dense_scene["pose0"], dense_scene["image"], **kw)
    np.testing.assert_allclose(rt["search_pose"], rj["search_pose"],
                               atol=1e-4)
    assert rt["backtracks"] == rj["backtracks"]
    assert rt["lr_final"] == rj["lr_final"]
    assert len(rt["loss_history"]) == len(rj["loss_history"]) >= 3
    np.testing.assert_allclose(rt["loss_history"], rj["loss_history"],
                               rtol=1e-4)
    np.testing.assert_allclose(rt["loss"], rj["loss"], rtol=1e-4)
    np.testing.assert_allclose(rt["pose"], rj["pose"], atol=1e-5)
    np.testing.assert_array_equal(rt["pose"][:, :3],
                                  rt["search_pose"][:, :3])


def test_localize_backtracking_loop(dense_scene, monkeypatch):
    """The refinement loop on both sides with the same scripted losses and
    gradients (each instance's ``_diff_step_auto`` patched; the search is
    skipped): three backtracks, the lr halved each time, the pose
    reverted to the best one and Adam restarted with fresh moments."""
    losses = [1.0, 0.8, 0.9, 0.85, 0.7, 0.75, 0.65]
    grads = np.random.default_rng(22).normal(size=(len(losses), 3, 4))
    opt_j = optax.inject_hyperparams(optax.adam)(
        learning_rate=1e-4, b1=0.9, b2=0.999, eps=1e-8)
    calls = {"j": 0, "t": 0}

    def step_j(pose, state, gt):
        k = calls["j"]
        calls["j"] += 1
        upd, state = opt_j.update(jnp.asarray(grads[k], jnp.float32), state,
                                  pose)
        return optax.apply_updates(pose, upd), state, jnp.float32(losses[k])

    def step_t(pose, opt, frame):
        k = calls["t"]
        calls["t"] += 1
        pose.grad = torch.tensor(grads[k], dtype=torch.float32)
        opt.step()
        return float(np.float32(losses[k]))

    jl, tl = dense_scene["jl"], dense_scene["tl"]
    monkeypatch.setattr(jl, "_diff_step_auto", lambda: (step_j, opt_j))
    monkeypatch.setattr(tl, "_diff_step_auto", step_t)
    kw = dict(search_rounds=0, diff_iters=4, diff_lr=3e-3)
    rj = jl.localize(dense_scene["pose0"], dense_scene["image"], **kw)
    rt = tl.localize(dense_scene["pose0"], dense_scene["image"], **kw)
    assert calls == {"j": 7, "t": 7}
    assert rt["backtracks"] == rj["backtracks"] == 3
    assert rt["lr_final"] == rj["lr_final"] == 3e-3 / 8
    assert rt["loss_history"] == rj["loss_history"] == [
        float(np.float32(x)) for x in losses]
    assert rt["loss"] == rj["loss"] == float(np.float32(0.65))
    np.testing.assert_array_equal(rt["search_pose"], dense_scene["pose0"])
    np.testing.assert_allclose(rt["pose"], rj["pose"], rtol=0, atol=1e-7)
    assert np.abs(rt["pose"] - dense_scene["pose0"]).max() > 1e-4


def test_service_differential_modes(dense_scene):
    """Modes 1 and 2 of the service against the JAX service (the shared
    JAX Localizer, the same host draws), and an unknown cmd refused."""
    jl, tl = dense_scene["jl"], dense_scene["tl"]
    js, ts = jserve.LocalizerService(jl), tserve.LocalizerService(tl)
    world = jl.camera2world(dense_scene["pose0"])
    for s in (js, ts):
        assert s.handle({"cmd": "init_pose", "pose": world.tolist()})["ok"]
    req1 = {"cmd": "localize", "image": dense_scene["image"].tolist(), "mode": 1}
    rj, rt = js.handle(req1), ts.handle(req1)
    assert rt["ok"] and rj["ok"] and rt["noise_coeff"] == 0.0
    np.testing.assert_allclose(rt["pose"], rj["pose"],
                               atol=0.01 * 1e-4 * RADIUS)
    np.testing.assert_allclose(rt["score"], rj["score"], rtol=1e-3)
    jl._rng, tl._rng = np.random.default_rng(23), np.random.default_rng(23)
    req2 = {"cmd": "localize", "image": dense_scene["image"].tolist(), "mode": 2,
            "particle_num": 8, "search_rounds": 1, "diff_iters": 2}
    rj, rt = js.handle(req2), ts.handle(req2)
    assert rt["ok"] and rj["ok"]
    assert rt["backtracks"] == rj["backtracks"]
    assert rt["lr_final"] == rj["lr_final"] == 3e-3 / 2 ** rt["backtracks"]
    np.testing.assert_allclose(rt["diff_loss"], rj["diff_loss"], rtol=1e-4)
    np.testing.assert_allclose(rt["pose"], rj["pose"], atol=1e-5 * RADIUS)
    np.testing.assert_allclose(rt["score"], rj["score"], rtol=1e-3)
    assert rt["noise_coeff"] == rj["noise_coeff"] == 2.0
    assert ts.handle({"cmd": "status"})["frames"] == 2
    assert ts.handle({"cmd": "bogus"})["ok"] is False
