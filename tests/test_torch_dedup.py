"""Port parity: run dedup (``ops/hash_paged.py`` ``dedup_budgets``,
``compute_runs``, ``paged_encode_rays``; ``models/hash_field.py``
``ray_budgets``, ``compacted_budgets``, ``query_rays``,
``query_compacted``) against the JAX package on the CPU.

Tolerances:
* budgets, run ids and run pages are integers: exactly equal;
* ``paged_encode_rays`` in fp32 against JAX's (jnp branch): features
  atol 1e-5, the page gradient atol 1e-6 x its largest entry, the point
  gradient atol 1e-5 x its largest entry (``test_torch_hash.py``'s flat
  encode tolerances: the same f32 sums in another order);
* the port's dedup against the port's flat encode where no run id clamps:
  bitwise (the encode's inputs are the same tensors' values), and so are
  a render and two train steps with ``encode_dedup`` on and off;
* ``query_compacted`` against JAX's on both sides of its run-time check:
  the field query's atol 1e-5 (``test_torch_render.py``);
* the run counts of the samplers' own rays against ``ray_budgets``:
  integers, within the budget.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.core.config import Config as JConfig
from f2nerf_tpu.models import hash_field as jhf
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.ops import hash_paged as jhp
from f2nerf_tpu.ops.hash_encode import level_scales as jlevel_scales
from f2nerf_tpu_torch.convert import tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.models import occupancy, sampler
from f2nerf_tpu_torch.models import renderer as trend
from f2nerf_tpu_torch.ops import hash_paged as thp
from f2nerf_tpu_torch.ops.hash_encode import level_scales
from f2nerf_tpu_torch.train import optim as topt
from f2nerf_tpu_torch.train import step as tstep
from test_hash import _ray_points
from test_torch_train import _setup as train_setup
from test_torch_train import jax_noise

CPU = torch.device("cpu")


def _tcfg(jcfg: JConfig) -> TConfig:
    return TConfig.from_dict(dataclasses.asdict(jcfg))


def _dense_cfg():
    cfg = JConfig()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, sampler_mode="dense"))


CFGS = {"default": JConfig, "quality": JConfig.quality,
        "dense": _dense_cfg}


@pytest.mark.parametrize("name", ["default", "quality", "tiny", "occ",
                                  "dense"])
def test_budgets_match_jax(name, tiny_cfg, occ_cfg):
    jcfg = {"tiny": tiny_cfg, "occ": occ_cfg}.get(name) or CFGS[name]()
    jm, tm = jcfg.model, _tcfg(jcfg).model
    assert thf.ray_budgets(tm) == jhf.ray_budgets(jm)
    for s2 in (jm.n_samples, 64, 256):
        assert thf.compacted_budgets(tm, s2) == jhf.compacted_budgets(jm, s2)
    jmeta, tmeta = jhf.paged_meta(jm), thf.paged_meta(tm)
    for s, march, frac, occ in ((64, 1.0, 0.75, (8, 8, 128)),
                                (1024, 6.0, 0.6, None),
                                (48, 2.0, 1.0, None)):
        assert (thp.dedup_budgets(tmeta, s, march, frac, occ=occ)
                == jhp.dedup_budgets(jmeta, s, march, frac, occ=occ))
    if name in ("default", "quality"):
        assert thf.ray_budgets(tm) == (24, 40, 48, 48, 0, 0, 0, 0)
    for off in (dict(encode_dedup=False), dict(hash_mode="xor"),
                dict(warp_mode="perspective")):
        assert thf.ray_budgets(dataclasses.replace(tm, **off)) is None


def _meta_pair(n_levels=3, tsize=4096, c=2):
    """``tests/test_hash.py::TestDedupEncode``'s layout in both packages."""
    jm = jhp.make_paged_meta(n_levels, tsize, c,
                             jlevel_scales(n_levels, 1.0, 4.0), np_seed=0)
    tm = thp.make_paged_meta(n_levels, tsize, c,
                             level_scales(n_levels, 1.0, 4.0), np_seed=0)
    return jm, tm


RAYS = {"random": {}, "diagonal": dict(diag=True),
        "invalid_suffix": dict(invalid_suffix=True)}


def _rays(kind, n_rays=16, n_samples=48, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "clamp":
        return _ray_points(rng, n_rays=n_rays, n_samples=n_samples,
                           diag=True)
    return _ray_points(rng, n_rays=n_rays, n_samples=n_samples,
                       **RAYS[kind])


def _budgets(jm, kind, n_samples=48):
    budgets = jhp.dedup_budgets(jm, n_samples, 2.0, max_frac=1.0)
    assert any(budgets)
    if kind == "clamp":
        return tuple(8 if b else 0 for b in budgets)
    return budgets


@pytest.mark.parametrize("kind", [*RAYS, "clamp"])
def test_compute_runs_bitwise(kind):
    jm, tm = _meta_pair()
    pts = _rays(kind, n_rays=64)
    budgets = _budgets(jm, kind)
    r, s = pts.shape[:2]
    pidx, _, _ = jhp._page_indices_lm(jnp.asarray(pts.reshape(-1, 3)), jm)
    pidx = np.asarray(pidx)
    clamped = False
    for lvl, b in enumerate(budgets):
        if not b:
            continue
        pl = pidx[lvl].reshape(r, s)
        jid, jpage = jhp.compute_runs(jnp.asarray(pl), b,
                                      fill=jm.page_offset[lvl])
        tid, tpage = thp.compute_runs(torch.tensor(pl), b,
                                      tm.page_offset[lvl])
        assert tid.dtype == torch.int32 and tpage.dtype == torch.int32
        np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
        np.testing.assert_array_equal(tpage.numpy(), np.asarray(jpage))
        runs = int((1 + (np.diff(pl, axis=1) != 0).sum(1)).max())
        clamped |= runs > b
    assert clamped == (kind == "clamp")


def _encode_inputs(kind, n_rays=6, n_samples=24, c=2):
    jm, tm = _meta_pair(c=c)
    rng = np.random.default_rng(11)
    pages = rng.normal(size=(jm.total_pages, c, 4, 4, 4)).astype(np.float32)
    pts = _rays(kind, n_rays=n_rays, n_samples=n_samples, seed=3)
    budgets = _budgets(jm, kind, n_samples)
    g = rng.normal(size=(n_rays, n_samples, jm.n_levels * c)
                   ).astype(np.float32)
    return jm, tm, pages, pts, budgets, g


def _port_encode(pts, pages, tm, budgets, g, chunk=65536):
    """The port's dedup (``budgets``) or flat (None) encode in fp32: the
    features and the page and point gradients of sum(feat * g)."""
    tp = torch.from_numpy(pages).requires_grad_(True)
    tx = torch.from_numpy(pts).requires_grad_(True)
    if budgets is None:
        r, s = pts.shape[:2]
        feat = thp.paged_encode(tx.reshape(r * s, 3), tp, tm,
                                compute_dtype=torch.float32,
                                chunk=chunk).reshape(r, s, -1)
    else:
        feat = thp.paged_encode_rays(tx, tp, tm, budgets,
                                     compute_dtype=torch.float32,
                                     chunk=chunk)
    (feat * torch.from_numpy(g)).sum().backward()
    return feat.detach(), tp.grad, tx.grad


@pytest.mark.parametrize("kind,chunk", [("random", 65536), ("random", 96),
                                        ("diagonal", 65536),
                                        ("invalid_suffix", 96),
                                        ("clamp", 65536), ("clamp", 96)])
def test_paged_encode_rays_matches_jax(kind, chunk):
    jm, tm, pages, pts, budgets, g = _encode_inputs(kind)

    def f(p, x):
        out = jhp.paged_encode_rays(x, p, jm, budgets,
                                    compute_dtype=jnp.float32, chunk=chunk,
                                    use_pallas=False, point_grads=True)
        return jnp.sum(out * g), out

    (_, ref), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pages), jnp.asarray(pts))
    feat, tgp, tgx = _port_encode(pts, pages, tm, budgets, g, chunk)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    for out, want, tol in ((tgp, gp, 1e-6), (tgx, gx, 1e-5)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0.1
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=tol * scale)
    if kind == "clamp":
        # clamped runs read their run's page: not the flat encode's values
        flat = np.asarray(jhp.paged_encode(
            jnp.asarray(pts.reshape(-1, 3)), jnp.asarray(pages), jm,
            compute_dtype=jnp.float32, use_pallas=False))
        assert np.abs(flat.reshape(ref.shape) - np.asarray(ref)).max() > 1e-3


@pytest.mark.parametrize("kind", list(RAYS))
def test_paged_encode_rays_bitwise_flat(kind):
    """No run id clamps: features, page and point gradients equal the
    port's flat encode bitwise."""
    jm, tm, pages, pts, budgets, g = _encode_inputs(kind, n_rays=12,
                                                    n_samples=48)
    for a, b in zip(_port_encode(pts, pages, tm, budgets, g),
                    _port_encode(pts, pages, tm, None, g)):
        assert torch.equal(a, b)


def _deduped(which, tiny_cfg, occ_cfg):
    """``tiny_cfg`` / ``occ_cfg`` with more samples a ray, so that level 0
    is deduped (the tiny configs' rays are too short to dedup any)."""
    jcfg, kw = {"tiny": (tiny_cfg, dict(n_samples=64, sample_l=1.0 / 32)),
                "occ": (occ_cfg, dict(occ_keep=2,
                                      occ_samples_per_segment=16))}[which]
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               **kw))
    assert jhf.ray_budgets(jcfg.model) == (24, 0)
    return jcfg


@pytest.mark.parametrize("train", [True, False], ids=["TRAIN", "VALIDATE"])
@pytest.mark.parametrize("which", ["occ", "tiny"], ids=["occ", "dense"])
def test_ray_budgets_hold_on_the_samplers_rays(which, train, tiny_cfg,
                                               occ_cfg):
    """The certified budgets bound the runs of every ray the sampler
    gives: each ray's largest run count, from the page indices of its
    contracted samples, is at most ``ray_budgets``, so no run id clamps
    and the dedup encode reads the flat encode's pages."""
    tcfg = _tcfg(_deduped(which, tiny_cfg, occ_cfg))
    m = tcfg.model
    budgets = thf.ray_budgets(m)
    gen = torch.Generator().manual_seed(8)
    n_rays = 256
    o = torch.rand((n_rays, 3), generator=gen) * 0.6 - 0.3
    d = torch.randn((n_rays, 3), generator=gen)
    d = d / d.norm(dim=-1, keepdim=True)
    noise = tstep.draw_noise(tcfg, 7, n_rays, CPU) if train else None
    if m.sampler_mode == "occ":
        # about a third of the cells occupied, scattered along every ray
        g = m.occ_grid_res
        occ = (torch.rand((g, g, g), generator=gen) < 0.3).float()
        vals = occupancy.occ_values(torch.stack([occ, torch.zeros_like(occ)]),
                                    m)
        pts = occupancy.sample_rays_occ(
            o, d, vals, m, rank_u=noise.rank if train else None,
            within_u=noise.within if train else None,
            explore=noise.explore if train else None).pts
    else:
        pts = sampler.sample_rays(o, d, m,
                                  u=noise.march if train else None).pts
    r, s = pts.shape[:2]
    pidx, _, _ = thp.page_indices(
        thf.contract(pts.reshape(-1, 3), m.contraction_radius),
        thf.paged_meta(m))
    for lvl, b in enumerate(budgets):
        if not b:
            continue
        pl = pidx[lvl].reshape(r, s).numpy()
        runs = 1 + (np.diff(pl, axis=1) != 0).sum(1)
        assert 1 < runs.max() <= b, (lvl, int(runs.max()), b)


def _render_setup(jcfg, seed):
    params, _ = jrend.init(jax.random.key(seed), jcfg.model, 4)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    return tree_from_numpy(tree, "cpu"), rng


@pytest.mark.parametrize("which", ["tiny", "occ"])
def test_render_dedup_on_off_bitwise(which, tiny_cfg, occ_cfg):
    """The VALIDATE render with ``encode_dedup`` on and off: colors,
    depths and the pose gradient's inputs (the points' gradient through
    the whole render) bitwise."""
    jcfg = _deduped(which, tiny_cfg, occ_cfg)
    tcfg = _tcfg(jcfg)
    params, rng = _render_setup(jcfg, 4)
    g = tcfg.model.occ_grid_res
    occ_vals = None
    if tcfg.model.sampler_mode == "occ":
        occ_vals = torch.ones((2, g ** 3))
    o = torch.tensor(rng.uniform(-0.3, 0.3, (64, 3)), dtype=torch.float32)
    d = torch.tensor(rng.normal(size=(64, 3)), dtype=torch.float32)
    d = d / d.norm(dim=-1, keepdim=True)
    outs = []
    for on in (True, False):
        m = dataclasses.replace(tcfg.model, encode_dedup=on)
        ro = o.clone().requires_grad_(True)
        res = trend.render(params, ro, d, m, occ_vals=occ_vals)
        (res.colors.sum() + res.depths.sum()).backward()
        outs.append((res.colors.detach(), res.depths.detach(), ro.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["tiny", "occ"])
def test_train_steps_dedup_on_off_bitwise(which, tiny_cfg, occ_cfg):
    """Two train steps of the port with ``encode_dedup`` on and off from
    the same state and draws: metrics, every grad and the params after
    the update bitwise."""
    jcfg = _deduped(which, tiny_cfg, occ_cfg)
    tree, poses, intr, batches, grid = train_setup(jcfg, 2)
    use_occ = jcfg.model.sampler_mode == "occ"
    outs = []
    for on in (True, False):
        tcfg = _tcfg(jcfg)
        tcfg = dataclasses.replace(tcfg, model=dataclasses.replace(
            tcfg.model, encode_dedup=on))
        params = tree_from_numpy(tree, "cpu")
        opt = topt.make_optimizer(params, tcfg.train)
        step_fn = tstep.make_train_step(tcfg, opt)
        tgrid = torch.tensor(grid) if use_occ else None
        rec = []
        for k in range(2):
            cam, ij, gt = batches[k]
            step = 600 + k
            tgrid, m = step_fn(params, tgrid, torch.tensor(poses),
                               torch.tensor(intr), step, torch.tensor(cam),
                               torch.tensor(ij), torch.tensor(gt),
                               noise=jax_noise(jcfg, step, len(cam)))
            rec.append(torch.stack(tuple(m)))
            rec += [p.grad.clone() for p in opt.named.values()]
        rec += [p.detach().clone() for p in opt.named.values()]
        outs.append(rec)
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _compacted_case(tiny_cfg, coherent):
    """A dense config whose level 0 is deduped on the compacted stream
    (``test_torch_two_pass.py``'s survivor-dedup point), and N = 4 x 256
    points: ray-major samples along straight rays (the check holds) or
    uniform random points (it fails)."""
    jm = dataclasses.replace(tiny_cfg.model, n_samples=256,
                             sample_l=1.0 / 64.0, dense_two_pass_dedup=True)
    budgets = jhf.compacted_budgets(jm, jm.n_samples)
    assert budgets == (80, 0)
    rng = np.random.default_rng(5)
    if coherent:
        pts = _ray_points(rng, n_rays=4, n_samples=256, march=2.0)
    else:
        pts = rng.uniform(-1.5, 1.5, (4, 256, 3)).astype(np.float32)
    return jm, budgets, pts.reshape(-1, 3)


@pytest.mark.parametrize("coherent", [True, False])
def test_query_compacted_check(coherent, tiny_cfg):
    """Both sides of JAX's run-time check: JAX's ``ok`` and run counts
    come out as the case expects, the port's page indices (so its run
    counts) equal JAX's, and the features equal JAX's whichever branch
    it takes, and the flat query's exactly."""
    jm, budgets, pts = _compacted_case(tiny_cfg, coherent)
    tm = _tcfg(JConfig(model=jm)).model
    jparams, jconsts = jrend.init(jax.random.key(3), jm, 4)
    tree = jax.tree.map(np.asarray, jparams)
    tree["field"]["feat_pool"] = np.random.default_rng(3).uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    jfield = jax.tree.map(jnp.asarray, tree["field"])
    # JAX's check (hash_field.py:179-187) on its own page indices
    x = jhf.contract(jnp.asarray(pts), jm.contraction_radius)
    jpidx, _, _ = jhp._page_indices_lm(x, jhf.paged_meta(jm))
    want_runs = {lvl: int((1 + (np.diff(np.asarray(jpidx[lvl]).reshape(
        -1, jm.n_samples), axis=1) != 0).sum(1)).max())
        for lvl, b in enumerate(budgets) if b}
    want_ok = all(want_runs[lvl] <= budgets[lvl] for lvl in want_runs)
    assert want_ok == coherent
    ref = np.asarray(jhf.query_compacted(jfield, jconsts["field"],
                                         jnp.asarray(pts), jm,
                                         point_grads=False))

    tpidx, _, _ = thp.page_indices(
        thf.contract(torch.from_numpy(pts), tm.contraction_radius),
        thf.paged_meta(tm))
    np.testing.assert_array_equal(tpidx.numpy(), np.asarray(jpidx))
    tfield = tree_from_numpy(tree["field"], "cpu")
    out = thf.query_compacted(tfield, torch.from_numpy(pts), tm)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    # the flat query's values exactly, with the flag on and off
    flat = thf.query(tfield, torch.from_numpy(pts), tm)
    assert torch.equal(out, flat)
    assert torch.equal(thf.query_compacted(
        tfield, torch.from_numpy(pts),
        dataclasses.replace(tm, dense_two_pass_dedup=False)), flat)
