"""Port parity for the perspective warp (``f2nerf_tpu_torch.models.warp``
and everything that carries its tables) against ``f2nerf_tpu`` on the
CPU, in fp32, on seeded numpy inputs.

Scenes: ``sphere_ds`` (4 views on a unit ring) with 4 regions of 3
cameras, as ``tests/test_warp.py`` uses it, and ``make_corridor_dataset``
at its defaults (24 views, 24 regions of 4 cameras). The warp's small
dot products are chains of fused multiply-adds in XLA's order, so at
n = 3 cameras (dots of 3 and 6 terms) the port's warp equals the JAX
package's eager warp bit for bit; at n = 4 XLA sums the 8-term dot in a
tree, ~1 ulp apart.

Tolerances, each with the error measured when it was set:
* tables: bitwise;
* uncontract: atol 1e-6 (measured 0);
* warped coordinates: atol 1e-6 at n = 3 (measured 0), 4e-6 at n = 4
  (measured 1.3e-6 of coordinates up to 2); the discrete choices (the
  top-k charts and their order) exactly;
* warp gradients: atol 1e-6 x the largest entry at n = 3 (measured
  1.7e-7), 1e-5 x at n = 4 (measured 1.1e-6): another order of the
  backward's sums, and at n = 4 the forward's ulp, amplified near the
  cameras, where the warp's Lipschitz constant is O(100);
* the field on warped points, the VALIDATE render, the renders of a run
  directory: those of ``tests/test_torch_render.py`` (atol 1e-5), the
  JAX side eager (measured: the query 4.8e-7; colors 2.4e-7, depths
  7.2e-7, weights 1.8e-7);
* three train steps: the tolerances of ``tests/test_torch_train.py``
  (measured: metrics 2.4e-7 relative, grads 3.7e-5 of each leaf's
  largest, params 0.0048 lr).

The localizer's modes through the warp are in
``test_torch_warp_localize.py`` (a second file, so that ``--dist
loadfile`` runs the two on two workers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _run as train_run

from f2nerf_tpu.core import cameras as jcams
from f2nerf_tpu.data.synthetic import make_corridor_dataset as jcorridor
from f2nerf_tpu.localize import localizer as jloc
from f2nerf_tpu.models import hash_field as jhf
from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.models import warp as jwarp
from f2nerf_tpu.ops import contraction as jcon
from f2nerf_tpu.train.loop import Trainer as JTrainer
from f2nerf_tpu_torch.convert import flatten, tree_from_numpy, unflatten
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.data.synthetic import make_corridor_dataset as tcorridor
from f2nerf_tpu_torch.localize import localizer as tloc
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.models import occupancy as tocc
from f2nerf_tpu_torch.models import renderer as trend
from f2nerf_tpu_torch.models import warp as twarp
from f2nerf_tpu_torch.ops import contraction as tcon
from f2nerf_tpu_torch.ops import hash_paged as thp
from f2nerf_tpu_torch.train import checkpoint as tckpt
from f2nerf_tpu_torch.train.loop import Trainer as TTrainer

ATOL = 1e-5
H, W = 24, 24
INTR = np.array([[30.0, 0, 12], [0, 30.0, 12], [0, 0, 1]], np.float32)


def _warp(cfg, **kw):
    """``cfg`` in perspective mode with 4 regions of 3 cameras."""
    kw = {"warp_n_regions": 4, "warp_n_cams": 3, **kw}
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, warp_mode="perspective", **kw))


def _tcfg(jcfg):
    return TConfig.from_dict(dataclasses.asdict(jcfg))


def _port_ds(ds):
    return tdata.Dataset(**{f.name: getattr(ds, f.name)
                            for f in dataclasses.fields(tdata.Dataset)})


def _jtables(poses, jcfg):
    t = jwarp.build_warp(poses, jcfg.model)
    return {"field": {"warp_anchors": t.anchors, "warp_rows": t.rows}}


def _setup(jcfg, poses, seed):
    """JAX params with O(1) features, the warp tables of ``poses`` built
    by each package, a seeded ~25%-occupied grid, both sides."""
    params, _ = jrend.init(jax.random.key(seed), jcfg.model, 4)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 4.0
    tcfg = _tcfg(jcfg)
    g = jcfg.model.occ_grid_res
    thresh = jocc.sigma_threshold(jcfg.model)
    dense = (rng.random((g, g, g)) < 0.25).astype(np.float32) * 2 * thresh
    grid = np.stack([dense, dense])
    return dict(jcfg=jcfg, tcfg=tcfg, tree=tree, grid=grid,
                jp=jax.tree.map(jnp.asarray, tree), jc=_jtables(poses, jcfg),
                tp=tree_from_numpy(tree, "cpu"),
                tc=twarp.warp_consts(poses, tcfg.model, "cpu"),
                jvals=jocc.occ_values(jnp.asarray(grid), jcfg.model),
                tvals=tocc.occ_values(torch.from_numpy(grid), tcfg.model))


@pytest.fixture(scope="module")
def dense(tiny_cfg, sphere_ds):
    return _setup(_warp(tiny_cfg), sphere_ds.poses, 0)


@pytest.fixture(scope="module")
def occ(occ_cfg, sphere_ds):
    return _setup(_warp(occ_cfg), sphere_ds.poses, 1)


@pytest.fixture(scope="module")
def corridor():
    """The corridor at its defaults, from each package's generator."""
    return jcorridor(), tcorridor()


# -- the warp itself ----------------------------------------------------------


def test_uncontract_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 2.0, (1024, 3)).astype(np.float32)
    y = np.asarray(jcon.contract(jnp.asarray(pts)))
    ref = np.asarray(jcon.uncontract(jnp.asarray(y)))
    out = tcon.uncontract(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    # and it inverts the port's own contraction
    back = tcon.uncontract(tcon.contract(torch.from_numpy(pts))).numpy()
    np.testing.assert_allclose(back, pts, rtol=1e-4, atol=1e-5)


def test_build_warp_bitwise_sphere(tiny_cfg, sphere_ds):
    jcfg = _warp(tiny_cfg)
    ref = jwarp.build_warp(sphere_ds.poses, jcfg.model)
    out = twarp.build_warp(sphere_ds.poses, _tcfg(jcfg).model)
    assert out.anchors.shape == (4, 3) and out.rows.shape == (4, 128)
    assert out.anchors.dtype == out.rows.dtype == np.float32
    np.testing.assert_array_equal(out.anchors, np.asarray(ref.anchors))
    np.testing.assert_array_equal(out.rows, np.asarray(ref.rows))
    assert out.n_cams == ref.n_cams == 3


def test_build_warp_bitwise_corridor(tiny_cfg, corridor):
    """At the warp's defaults (64 regions -> 24, 4 cameras)."""
    jds, tds = corridor
    np.testing.assert_array_equal(tds.poses, jds.poses)
    jcfg = dataclasses.replace(tiny_cfg, model=dataclasses.replace(
        tiny_cfg.model, warp_mode="perspective"))
    ref = jwarp.build_warp(jds.poses, jcfg.model)
    out = twarp.build_warp(tds.poses, _tcfg(jcfg).model)
    assert out.rows.shape == (24, 128) and out.n_cams == ref.n_cams == 4
    np.testing.assert_array_equal(out.anchors, np.asarray(ref.anchors))
    np.testing.assert_array_equal(out.rows, np.asarray(ref.rows))
    # the consts the trainer holds are those tables, as f32 tensors
    c = twarp.warp_consts(tds.poses, _tcfg(jcfg).model, "cpu")
    assert set(c) == {"field"} and set(c["field"]) == set(thf.WARP_KEYS)
    np.testing.assert_array_equal(c["field"]["warp_rows"].numpy(), out.rows)
    assert twarp.warp_consts(tds.poses, _tcfg(tiny_cfg).model, "cpu") == {}


def _warp_inputs(which, tiny_cfg, sphere_ds, corridor):
    if which == "sphere":
        jcfg, poses, std = _warp(tiny_cfg), sphere_ds.poses, 1.0
    else:
        jcfg = dataclasses.replace(tiny_cfg, model=dataclasses.replace(
            tiny_cfg.model, warp_mode="perspective"))
        poses, std = corridor[0].poses, 0.7
    t = jwarp.build_warp(poses, jcfg.model)
    tt = twarp.WarpTables(torch.tensor(np.asarray(t.anchors)),
                          torch.tensor(np.asarray(t.rows)), t.n_cams)
    pts = np.random.default_rng(3).normal(0, std, (4096, 3)).astype(
        np.float32)
    return t, tt, pts


@pytest.mark.parametrize("which,k", [("sphere", 1), ("sphere", 3),
                                     ("corridor", 1), ("corridor", 3)])
def test_warp_points_and_grad(which, k, tiny_cfg, sphere_ds, corridor):
    jt, tt, pts = _warp_inputs(which, tiny_cfg, sphere_ds, corridor)
    # discrete choices first: the nearest anchors, in top_k's order
    d2 = jnp.sum((jnp.asarray(pts)[:, None] - jt.anchors[None]) ** 2, -1)
    _, jidx = jax.lax.top_k(-d2, k)
    tidx = twarp._nearest(torch.from_numpy(np.asarray(d2)), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))

    ref = np.asarray(jwarp.warp_points(jnp.asarray(pts), jt, blend_k=k))
    out = twarp.warp_points(torch.from_numpy(pts), tt, blend_k=k).numpy()
    assert out.shape == (4096, 3) and np.abs(out).max() <= 1.999
    sphere = which == "sphere"
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 if sphere else 4e-6)

    def jloss(p):
        return jnp.sum(jnp.sin(3.0 * jwarp.warp_points(p, jt, blend_k=k)))

    g_ref = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))
    x = torch.from_numpy(pts).requires_grad_(True)
    torch.sum(torch.sin(3.0 * twarp.warp_points(x, tt, blend_k=k))).backward()
    scale = float(np.abs(g_ref).max())
    assert scale > 0
    np.testing.assert_allclose(x.grad.numpy(), g_ref, rtol=0,
                               atol=(1e-6 if sphere else 1e-5) * scale)


def test_nearest_ties_follow_top_k():
    """Among equal distances the lower index comes first, as in
    ``jax.lax.top_k``."""
    d2 = np.array([[1.0, 0.0, 0.0, 2.0, 0.0], [3.0, 3.0, 1.0, 3.0, 3.0]],
                  np.float32)
    for k in (1, 3, 5):
        _, ref = jax.lax.top_k(-jnp.asarray(d2), k)
        out = twarp._nearest(torch.from_numpy(d2), k)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- the field, the renderer and the localizer through the warp ---------------


@pytest.mark.parametrize("pre_contracted", [False, True])
def test_field_query_warp(dense, pre_contracted):
    """The warped coordinates, then the field on them, then the query."""
    rng = np.random.default_rng(2)
    hi = 1.95 if pre_contracted else 3.0
    pts = rng.uniform(-hi, hi, (2000, 3)).astype(np.float32)
    if pre_contracted:
        pts = pts[np.linalg.norm(pts, axis=-1) < 1.95]
    jcfg, tcfg = dense["jcfg"].model, dense["tcfg"].model
    world = (jcon.uncontract(jnp.asarray(pts)) if pre_contracted
             else jnp.asarray(pts))
    jx = np.asarray(jwarp.warp_points(world, jwarp.WarpTables(
        dense["jc"]["field"]["warp_anchors"],
        dense["jc"]["field"]["warp_rows"], jcfg.warp_n_cams),
        blend_k=jcfg.warp_blend_k))
    tx = thf.encode_coords(torch.from_numpy(pts), tcfg, dense["tc"]["field"],
                           pre_contracted=pre_contracted)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-6)
    # the field on the same warped coordinates
    feat = thp.paged_encode(torch.from_numpy(jx), dense["tp"]["field"][
        "feat_pool"], thf.paged_meta(tcfg), compute_dtype=torch.float32)
    on_jx = feat @ dense["tp"]["field"]["mlp"]["w"] \
        + dense["tp"]["field"]["mlp"]["b"]
    ref_contract = np.asarray(jhf.query(
        dense["jp"]["field"], {}, jnp.asarray(jx), dense["jcfg"].model,
        pre_contracted=True))
    np.testing.assert_allclose(on_jx.numpy(), ref_contract, atol=ATOL)
    # the whole query
    ref = np.asarray(jhf.query(dense["jp"]["field"], dense["jc"]["field"],
                               jnp.asarray(pts), jcfg,
                               pre_contracted=pre_contracted))
    out = thf.query(dense["tp"]["field"], torch.from_numpy(pts), tcfg,
                    pre_contracted=pre_contracted, consts=dense["tc"]["field"])
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    assert float(out[:, 0].std()) > 1e-2
    # density_at threads the renderer's consts to the field
    sig = trend.density_at(dense["tp"], torch.from_numpy(pts), tcfg,
                           contracted=pre_contracted, consts=dense["tc"])
    sig_ref = np.asarray(jrend.density_at(
        dense["jp"], dense["jc"], jnp.asarray(pts), jcfg,
        contracted=pre_contracted))
    np.testing.assert_allclose(sig.numpy(), sig_ref, rtol=1e-5)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("which", ["dense", "occ"])
def test_render_validate_warp(which, request):
    s = request.getfixturevalue(which)
    o, d = _rays(256, 7)
    use_occ = which == "occ"
    ref = jrend.render(s["jp"], s["jc"], jnp.asarray(o), jnp.asarray(d),
                       None, s["jcfg"].model, None, train=False,
                       occ_bits=s["jvals"] if use_occ else None)
    out = trend.render(s["tp"], torch.from_numpy(o), torch.from_numpy(d),
                       s["tcfg"].model,
                       occ_vals=s["tvals"] if use_occ else None,
                       consts=s["tc"])
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for name in ("colors", "depths", "weights"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=1e-5, err_msg=name)
    assert float(out.weights.sum(-1).max()) > 0.5
    assert float(out.colors.std()) > 1e-2
    # the warp is not the contraction: the same params render otherwise
    plain = trend.render(s["tp"], torch.from_numpy(o), torch.from_numpy(d),
                         dataclasses.replace(s["tcfg"].model,
                                             warp_mode="contract"),
                         occ_vals=s["tvals"] if use_occ else None)
    assert float((plain.colors - out.colors).abs().max()) > 1e-2


def test_perspective_without_tables_raises(dense):
    tcfg = dense["tcfg"]
    pts = torch.zeros(4, 3)
    for consts in (None, {}, {"warp_rows": dense["tc"]["field"]["warp_rows"]}):
        with pytest.raises(ValueError, match="warp_anchors"):
            thf.query(dense["tp"]["field"], pts, tcfg.model, consts=consts)
    o, d = (torch.from_numpy(x) for x in _rays(4, 0))
    with pytest.raises(ValueError, match="warp_rows"):
        trend.render(dense["tp"], o, d, tcfg.model)
    with pytest.raises(ValueError, match="warp_anchors"):
        tloc.Localizer(dense["tp"], tcfg, INTR, np.zeros(3), 1.0, H, W,
                       device="cpu")
    with pytest.raises(ValueError, match="warp_mode"):
        thf.check_consts(dataclasses.replace(tcfg.model, warp_mode="bent"),
                         None)


# -- the trainer, its checkpoints and the run directory ------------------------


@pytest.fixture(scope="module")
def warp_steps(tiny_cfg):
    """Three steps of each trainer's step on tiny_cfg with the warp
    (``test_torch_train._run``: the same params, batches and draws)."""
    return train_run(_warp(tiny_cfg), seed=5, step0=14)


def test_train_steps_metrics(warp_steps):
    for k, (j, t) in enumerate(zip(warp_steps["jax"], warp_steps["port"])):
        np.testing.assert_allclose(t["metrics"], j["metrics"], rtol=1e-5,
                                   err_msg=f"step {k}")


def test_train_steps_grads_and_params(warp_steps):
    """Grads atol 1e-3 (1e-2 in the third step) x each leaf's largest;
    params atol 0.05 lr; the tables are no leaf of Adam."""
    lr_max = max(warp_steps["lr"])
    assert lr_max > 0
    for k, (j, t) in enumerate(zip(warp_steps["jax"], warp_steps["port"])):
        assert set(t["grads"]) == set(j["grads"])
        assert not any("warp" in name for name in t["grads"])
        for name, gj in j["grads"].items():
            scale = float(np.abs(gj).max())
            assert scale > 0, (k, name)
            np.testing.assert_allclose(t["grads"][name], gj, rtol=0,
                                       atol=(1e-3 if k < 2 else 1e-2) * scale,
                                       err_msg=f"step {k} {name}")
            np.testing.assert_allclose(t["new_params"][name],
                                       j["new_params"][name], rtol=0,
                                       atol=0.05 * lr_max,
                                       err_msg=f"step {k} {name}")
    assert set(warp_steps["tconsts"]["field"]) == set(thf.WARP_KEYS)


def _trainer(jcfg, ds, rd, **kw):
    return TTrainer(_tcfg(jcfg), _port_ds(ds), result_dir=rd, device="cpu",
                    **kw)


def test_trainer_tables_match_jax_trainer(tiny_cfg, sphere_ds):
    jcfg = _warp(tiny_cfg)
    jtr = JTrainer(jcfg, sphere_ds, use_mesh=False)
    ttr = _trainer(jcfg, sphere_ds, None)
    for key in thf.WARP_KEYS:
        np.testing.assert_array_equal(ttr.consts["field"][key].numpy(),
                                      np.asarray(jtr.consts["field"][key]))
    assert not any("warp" in name for name in ttr.optimizer.named)
    assert _trainer(tiny_cfg, sphere_ds, None).consts == {}


def test_checkpoint_round_trip_with_tables(tiny_cfg, sphere_ds, tmp_path):
    jcfg = _warp(tiny_cfg)
    a = _trainer(jcfg, sphere_ds, tmp_path)
    a.run(2)
    a.save_checkpoint()
    state = tckpt.restore(tmp_path / "checkpoints")
    assert set(state["consts"]) == {"field/warp_anchors", "field/warp_rows"}
    b = _trainer(jcfg, sphere_ds, tmp_path)
    with torch.no_grad():                     # resume must bring them back
        b.consts["field"]["warp_rows"].zero_()
    assert b.try_resume() and b.step == 2
    for key in thf.WARP_KEYS:
        assert torch.equal(b.consts["field"][key], a.consts["field"][key])
    for (na, pa), (nb, pb) in zip(a.optimizer.named.items(),
                                  b.optimizer.named.items()):
        assert na == nb and torch.equal(pa, pb), na
    b.run(1)
    assert b.step == 3
    a.close()
    b.close()


def test_checkpoint_without_consts_still_loads(tiny_cfg, sphere_ds, tmp_path):
    """A contract-mode checkpoint written before ``consts`` existed reads
    as consts = {} and serves."""
    tr = _trainer(tiny_cfg, sphere_ds, tmp_path)
    tr.run(2)
    tr.save_checkpoint()
    tr.close()
    path = tmp_path / "checkpoints" / "step_00000002" / tckpt.STATE_FILE
    state = torch.load(path, weights_only=True)
    assert state.pop("consts") == {}
    torch.save(state, path)
    assert tckpt.restore(tmp_path / "checkpoints")["consts"] == {}
    b = _trainer(tiny_cfg, sphere_ds, tmp_path)
    assert b.try_resume() and b.consts == {} and b.step == 2
    b.close()
    loc = tloc.Localizer.from_checkpoint(tmp_path, device="cpu")
    assert loc.consts == {}
    img = loc.render_image(sphere_ds.poses[0])
    assert img.shape == (sphere_ds.height, sphere_ds.width, 3)
    assert bool(torch.isfinite(img).all())


def test_from_checkpoint_warp_run(tiny_cfg, sphere_ds, tmp_path):
    """A warp run directory of the port's trainer, and the same field as
    ``torch_params.npz`` with the ``consts/...`` keys, serve what the
    JAX localizer renders with the JAX tables; without the tables the
    run directory raises."""
    jcfg = _warp(tiny_cfg)
    run = tmp_path / "run"
    tr = _trainer(jcfg, sphere_ds, run)
    tr.run(2)
    tr.save_checkpoint()
    tr.close()
    state = tckpt.restore(run / "checkpoints")
    tree = jax.tree.map(jnp.asarray, unflatten(
        {k: v.numpy() for k, v in state["params"].items()}))
    jl = jloc.Localizer(tree, _jtables(sphere_ds.poses, jcfg), jcfg,
                        sphere_ds.intrinsics[0], sphere_ds.center,
                        sphere_ds.radius, sphere_ds.height, sphere_ds.width)
    pose = sphere_ds.poses[1]
    ref = np.asarray(jl.render_image(pose))
    assert ref.std() > 0
    loc = tloc.Localizer.from_checkpoint(run, device="cpu")
    for key in thf.WARP_KEYS:
        assert torch.equal(loc.consts["field"][key], tr.consts["field"][key])
    np.testing.assert_allclose(loc.render_image(pose).numpy(), ref, rtol=0,
                               atol=ATOL)

    npz = tmp_path / "npz"
    npz.mkdir()
    for name in ("train_config.yaml", "inference_params.yaml"):
        (npz / name).write_text((run / name).read_text())
    flat = {k: v.numpy() for k, v in state["params"].items()}
    consts = flatten(jax.tree.map(np.asarray, jl.consts), "consts/")
    assert set(consts) == {"consts/field/warp_anchors",
                           "consts/field/warp_rows"}
    np.savez(npz / "torch_params.npz", **flat, **consts)
    loc = tloc.Localizer.from_checkpoint(npz, device="cpu")
    np.testing.assert_allclose(loc.render_image(pose).numpy(), ref, rtol=0,
                               atol=ATOL)
    np.savez(npz / "torch_params.npz", **flat)
    with pytest.raises(ValueError, match="warp_anchors"):
        tloc.Localizer.from_checkpoint(npz, device="cpu")


def test_consts_from_numpy(dense):
    c = tree_from_numpy(jax.tree.map(np.asarray, dense["jc"]), "cpu")
    for key in thf.WARP_KEYS:
        t = c["field"][key]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), dense["tc"]["field"][key])
    assert tree_from_numpy({"field": {}}, "cpu") == {"field": {}}
