"""Port parity: field, shader, samplers and the VALIDATE renderer
(f2nerf_tpu_torch.models against f2nerf_tpu.models) on the CPU, in fp32,
with the JAX params converted by f2nerf_tpu_torch.convert.

Tolerances: field features and colors atol 1e-5 (f32 encode sums and
small matmuls in another order); the samplers' discrete outputs exactly;
sample positions atol 1e-6; the refreshed occupancy grid rtol 1e-5
(densities of the same params). TRAIN mode gets the JAX package's own
draws, rebuilt from its keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.models import hash_field as jhf
from f2nerf_tpu.models import occupancy as jocc
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.models import sampler as jsamp
from f2nerf_tpu.models import sh_shader as jsh
from f2nerf_tpu_torch.convert import tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.models import occupancy as tocc
from f2nerf_tpu_torch.models import renderer as trend
from f2nerf_tpu_torch.models import sampler as tsamp
from f2nerf_tpu_torch.models import sh_shader as tsh

ATOL = 1e-5


def _setup(jcfg, seed=0):
    """JAX params with O(1) features (random init pages are ~1e-4),
    their port twin, and a seeded ~25%-occupied grid for both."""
    params, consts = jrend.init(jax.random.key(seed), jcfg.model, 4)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    # stronger density so rays terminate inside the march
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 4.0
    jparams = jax.tree.map(jnp.asarray, tree)
    tcfg = TConfig.from_dict(dataclasses.asdict(jcfg))
    tparams = tree_from_numpy(tree, "cpu")
    g = jcfg.model.occ_grid_res
    thresh = jocc.sigma_threshold(jcfg.model)
    dense = (rng.random((g, g, g)) < 0.25).astype(np.float32) * 2 * thresh
    grid = np.stack([dense, dense])
    jvals = jocc.occ_values(jnp.asarray(grid), jcfg.model)
    tvals = tocc.occ_values(torch.from_numpy(grid), tcfg.model)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jparams, jc=consts, tp=tparams,
                jvals=jvals, tvals=tvals)


@pytest.fixture(scope="module")
def dense(tiny_cfg):
    return _setup(tiny_cfg)


@pytest.fixture(scope="module")
def occ(occ_cfg):
    return _setup(occ_cfg, seed=1)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def test_occ_values_match(occ):
    np.testing.assert_array_equal(occ["tvals"].numpy(),
                                  np.asarray(occ["jvals"]))
    g = jocc.init_grid(occ["jcfg"].model)
    tg = tocc.init_grid(occ["tcfg"].model, "cpu")
    np.testing.assert_array_equal(tg.numpy(), np.asarray(g))
    np.testing.assert_array_equal(
        tocc.occupancy_bits(tg, occ["tcfg"].model).numpy(),
        np.asarray(jocc.occupancy_bits(g, occ["jcfg"].model)))
    assert tocc.sigma_threshold(occ["tcfg"].model) == \
        jocc.sigma_threshold(occ["jcfg"].model)


def test_field_query(dense):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    ref = np.asarray(jhf.query(dense["jp"]["field"], dense["jc"]["field"],
                               jnp.asarray(pts), dense["jcfg"].model))
    out = thf.query(dense["tp"]["field"], torch.from_numpy(pts),
                    dense["tcfg"].model)
    assert out.shape == (2000, 16)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    lw = np.array([1.0, 0.25], np.float32)
    ref_w = np.asarray(jhf.query(dense["jp"]["field"], dense["jc"]["field"],
                                 jnp.asarray(pts), dense["jcfg"].model,
                                 level_weights=jnp.asarray(lw)))
    out_w = thf.query(dense["tp"]["field"], torch.from_numpy(pts),
                      dense["tcfg"].model, level_weights=torch.from_numpy(lw))
    np.testing.assert_allclose(out_w.numpy(), ref_w, atol=ATOL)


def test_field_query_rays_vs_dedup(dense):
    """The JAX side runs its run-dedup encode (encode_dedup=True); the
    port encodes flat."""
    # finer march than tiny_cfg, so the coarse level gets a run budget
    jm = dataclasses.replace(dense["jcfg"].model, n_samples=128,
                             sample_l=1.0 / 32.0)
    tm = dataclasses.replace(dense["tcfg"].model, n_samples=128,
                             sample_l=1.0 / 32.0)
    assert jm.encode_dedup and any(jhf.ray_budgets(jm))
    o, d = _rays(64, 3)
    smp = jsamp.sample_rays(jnp.asarray(o), jnp.asarray(d), jm, None)
    ref = np.asarray(jhf.query_rays(dense["jp"]["field"],
                                    dense["jc"]["field"], smp.pts, jm))
    out = thf.query_rays(dense["tp"]["field"],
                         torch.tensor(np.asarray(smp.pts)), tm)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_field_init_and_haloed_cache(dense):
    cfg = dense["tcfg"].model
    g = torch.Generator().manual_seed(0)
    p = thf.init(g, cfg, torch.device("cpu"))
    meta = thf.paged_meta(cfg)
    assert p["feat_pool"].shape == (meta.total_pages, cfg.n_channels, 4, 4, 4)
    assert float(p["feat_pool"].abs().max()) <= 1e-4
    assert p["mlp"]["w"].shape == (cfg.n_levels * cfg.n_channels, 16)
    pts = torch.rand(100, 3) * 4 - 2
    cached = dict(p, haloed=thf.haloed_table(p, cfg))
    torch.testing.assert_close(thf.query(cached, pts, cfg),
                               thf.query(p, pts, cfg), rtol=0, atol=0)
    with pytest.raises(ValueError, match="hash_mode"):
        thf.init(g, dataclasses.replace(cfg, hash_mode="cuckoo"),
                 torch.device("cpu"))


def test_sh_shader(dense):
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(500, 16)).astype(np.float32)
    dirs = rng.normal(size=(500, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ref = np.asarray(jsh.query(dense["jp"]["shader"], jnp.asarray(feats),
                               jnp.asarray(dirs), dense["jcfg"].model))
    out = tsh.query(dense["tp"]["shader"], torch.from_numpy(feats),
                    torch.from_numpy(dirs), dense["tcfg"].model)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_dense_sampler(dense):
    o, d = _rays(128, 5)
    ref = jsamp.sample_rays(jnp.asarray(o), jnp.asarray(d),
                            dense["jcfg"].model, None)
    out = tsamp.sample_rays(torch.from_numpy(o), torch.from_numpy(d),
                            dense["tcfg"].model)
    for name in ("pts", "dirs", "dt", "t"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-6, err_msg=name)


def test_occ_sampler_validate(occ):
    cfg = occ["jcfg"].model
    o, d = _rays(512, 6)
    ref = jocc.sample_rays_occ(jnp.asarray(o), jnp.asarray(d),
                               occ["jvals"], cfg, None)
    out = tocc.sample_rays_occ(torch.from_numpy(o), torch.from_numpy(d),
                               occ["tvals"], occ["tcfg"].model)
    # discrete outputs first: validity, explore flags, segment index
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.explore.numpy(),
                                  np.asarray(ref.explore))
    seg_len = cfg.n_samples * cfg.sample_l / cfg.occ_segments
    seg_t = np.floor((out.t.numpy() - cfg.sample_near) / seg_len)
    seg_j = np.floor((np.asarray(ref.t) - cfg.sample_near) / seg_len)
    np.testing.assert_array_equal(seg_t, seg_j)
    assert 0 < out.valid.float().mean() < 1
    for name in ("t", "dt", "pts", "dirs"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-6, err_msg=name)
    # TRAIN needs both jitter draws
    with pytest.raises(ValueError):
        tocc.sample_rays_occ(torch.from_numpy(o), torch.from_numpy(d),
                             occ["tvals"], occ["tcfg"].model,
                             rank_u=torch.rand(512, cfg.occ_keep))


@pytest.mark.parametrize("which", ["dense", "occ"])
def test_render_validate(which, request):
    s = request.getfixturevalue(which)
    o, d = _rays(256, 7)
    occ_bits = s["jvals"] if which == "occ" else None
    cfg = s["jcfg"].model
    ref = jax.jit(lambda p, c, o_, d_, b: jrend.render(
        p, c, o_, d_, None, cfg, None, train=False, occ_bits=b))(
            s["jp"], s["jc"], jnp.asarray(o), jnp.asarray(d), occ_bits)
    out = trend.render(s["tp"], torch.from_numpy(o), torch.from_numpy(d),
                       s["tcfg"].model,
                       occ_vals=s["tvals"] if which == "occ" else None)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for name in ("colors", "depths"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=1e-5, err_msg=name)
    # per-sample values are held looser: jit fuses o + d*t into an FMA,
    # so sample positions differ by an ulp, which the finest level
    # (scale 1024) turns into ~1e-4 of cell fraction
    for name in ("weights", "sec_density"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=1e-3, err_msg=name)
    # the fixtures are not degenerate: rays terminate, colors vary
    assert float(out.weights.sum(-1).max()) > 0.5
    assert float(out.colors.std()) > 1e-2


@pytest.mark.parametrize("which", ["dense", "occ"])
def test_render_image(which, request):
    s = request.getfixturevalue(which)
    pose = np.eye(3, 4, dtype=np.float32)
    pose[:, 3] = [0.1, -0.05, 0.2]
    intr = np.array([[20.0, 0, 8], [0, 20.0, 6], [0, 0, 1]], np.float32)
    occ_bits = s["jvals"] if which == "occ" else None
    rgb_j, dep_j = jrend.render_image(
        s["jp"], s["jc"], jnp.asarray(pose), jnp.asarray(intr), 12, 16,
        s["jcfg"].model, chunk=64, occ_bits=occ_bits, supersample=2)
    rgb_t, dep_t = trend.render_image(
        s["tp"], torch.from_numpy(pose), torch.from_numpy(intr), 12, 16,
        s["tcfg"].model, chunk=100,
        occ_vals=s["tvals"] if which == "occ" else None, supersample=2)
    assert rgb_t.shape == (12, 16, 3) and dep_t.shape == (12, 16)
    np.testing.assert_allclose(rgb_t.numpy(), np.asarray(rgb_j), atol=ATOL)
    np.testing.assert_allclose(dep_t.numpy(), np.asarray(dep_j), atol=ATOL,
                               rtol=1e-5)


def test_density_at(dense):
    pts = np.random.default_rng(8).uniform(-2, 2, (300, 3)).astype(
        np.float32)
    ref = np.asarray(jrend.density_at(dense["jp"], dense["jc"],
                                      jnp.asarray(pts), dense["jcfg"].model,
                                      contracted=True))
    out = trend.density_at(dense["tp"], torch.from_numpy(pts),
                           dense["tcfg"].model, contracted=True)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


def _cut_vals(s, seed):
    """Occupancy values whose mean channel is opaque (sigma 2e3) in the
    occupied cells: rays crossing 3+ occupied segments get ineligible
    ones, the targets of the explore slots."""
    cfg = s["jcfg"].model
    g = cfg.occ_grid_res
    occ = (np.random.default_rng(seed).random((g, g, g)) < 0.25).astype(
        np.float32)
    grid = np.stack([occ * 2 * jocc.sigma_threshold(cfg), occ * 2e3])
    return (jocc.occ_values(jnp.asarray(grid), cfg),
            tocc.occ_values(torch.from_numpy(grid), s["tcfg"].model))


def _occ_draws(key, cfg, r):
    """sample_rays_occ's TRAIN draws (occupancy.py:239-271, 316-319)."""
    explore = None
    if cfg.occ_explore_eps > 0.0:
        key, k_exp = jax.random.split(key)
        explore = torch.tensor(np.asarray(jax.random.bernoulli(
            k_exp, cfg.occ_explore_eps, (r, 1))))
    k_rank, k_within = jax.random.split(key)
    rank = jax.random.uniform(k_rank, (r, cfg.occ_keep))
    within = jax.random.uniform(k_within, (r, cfg.occ_keep,
                                           cfg.occ_samples_per_segment))
    return dict(rank_u=torch.tensor(np.asarray(rank)),
                within_u=torch.tensor(np.asarray(within)), explore=explore)


@pytest.mark.parametrize("eps", [0.0, 0.5])
def test_occ_sampler_train(occ, eps):
    """TRAIN: jittered ranks and samples, the targeted explore slot, and
    (eps > 0) exploration rays."""
    jcfg = dataclasses.replace(occ["jcfg"].model, occ_explore_eps=eps)
    tcfg = dataclasses.replace(occ["tcfg"].model, occ_explore_eps=eps)
    assert jcfg.occ_explore_slots == 1 and jcfg.occ_explore_targeted
    jvals, tvals = _cut_vals(occ, 3)
    o, d = _rays(512, 9)
    key = jax.random.key(11)
    ref = jocc.sample_rays_occ(jnp.asarray(o), jnp.asarray(d), jvals, jcfg,
                               key)
    out = tocc.sample_rays_occ(torch.from_numpy(o), torch.from_numpy(d),
                               tvals, tcfg, **_occ_draws(key, jcfg, 512))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.explore.numpy(),
                                  np.asarray(ref.explore))
    for name in ("t", "dt", "pts", "dirs"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-6, err_msg=name)
    # the fixture reaches the branches: ineligible segments are sampled
    # (by the explore slot) and the jitter moved samples off the centres
    assert 0 < float(out.explore.float().mean()) < 0.5
    val = tocc.sample_rays_occ(torch.from_numpy(o), torch.from_numpy(d),
                               tvals, tcfg)
    assert not torch.equal(val.t, out.t)
    if eps == 0.0:
        # without the explore slot VALIDATE never samples them
        assert not bool(val.explore.any())


def test_update_grid_two_phases(occ):
    """Two K=4 refresh phases in a row, the JAX jitter injected."""
    jcfg, tcfg = occ["jcfg"].model, occ["tcfg"].model
    assert jcfg.occ_refresh_phases == 4
    g = jcfg.occ_grid_res
    rng = np.random.default_rng(12)
    grid = np.stack([rng.uniform(0, 1, (g, g, g)),
                     rng.uniform(0, 1, (g, g, g))]).astype(np.float32)
    jgrid, tgrid = jnp.asarray(grid), torch.from_numpy(grid)
    m = g ** 3 // 4
    for phase in (0, 1):
        key = jax.random.key(20 + phase)
        jgrid = jocc.update_grid(
            jgrid, lambda x: jrend.density_at(occ["jp"], occ["jc"], x, jcfg,
                                              contracted=True),
            key, jcfg, phase=phase)
        u = torch.tensor(np.asarray(jax.random.uniform(key, (m, 3))))
        with torch.no_grad():
            tgrid = tocc.update_grid(
                tgrid, lambda x: trend.density_at(occ["tp"], x, tcfg,
                                                  contracted=True),
                tcfg, phase=phase, u=u)
        np.testing.assert_allclose(tgrid.numpy(), np.asarray(jgrid),
                                   rtol=1e-5, atol=1e-7)
    # each phase touched its quarter of the mean channel, not the rest
    changed = (tgrid[1] != torch.from_numpy(grid[1])).reshape(m, 4)
    assert bool(changed[:, :2].all()) and not bool(changed[:, 2:].any())
    # and the single-channel legacy grid keeps its shape
    one = tocc.update_grid(torch.from_numpy(grid[0]), lambda x: x[:, 0],
                           tcfg, phase=3, u=u)
    assert one.shape == (g, g, g)


class _Noise:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("which", ["dense", "occ"])
def test_render_train(which, request):
    """TRAIN mode: random background, jittered samplers, app_emb."""
    s = request.getfixturevalue(which)
    jcfg = s["jcfg"].model
    o, d = _rays(256, 13)
    emb_idx = np.random.default_rng(14).integers(0, 4, 256).astype(np.int32)
    key = jax.random.key(15)
    if which == "occ":
        jvals, tvals = _cut_vals(s, 16)
    else:
        jvals = tvals = None
    ref = jax.jit(lambda p, c, o_, d_, e, b: jrend.render(
        p, c, o_, d_, e, jcfg, key, train=True, occ_bits=b))(
            s["jp"], s["jc"], jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(emb_idx), jvals)
    key_noise, key_bg = jax.random.split(key)
    bg = torch.tensor(np.asarray(jax.random.uniform(key_bg, (256, 3))))
    if which == "occ":
        draws = _occ_draws(key_noise, jcfg, 256)
        noise = _Noise(bg=bg, march=None, rank=draws["rank_u"],
                       within=draws["within_u"], explore=draws["explore"])
    else:
        noise = _Noise(bg=bg, march=torch.tensor(np.asarray(
            jax.random.uniform(key_noise, (256, jcfg.n_samples)))),
            rank=None, within=None, explore=None)
    out = trend.render(s["tp"], torch.from_numpy(o), torch.from_numpy(d),
                       s["tcfg"].model, occ_vals=tvals,
                       emb_idx=torch.from_numpy(emb_idx), noise=noise)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for name in ("colors", "depths"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=ATOL, rtol=1e-5, err_msg=name)
    for name in ("weights", "sec_density"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-4, rtol=1e-3, err_msg=name)
    # the embedding and the background reach the colors
    plain = trend.render(s["tp"], torch.from_numpy(o), torch.from_numpy(d),
                         s["tcfg"].model, occ_vals=tvals, noise=noise)
    assert float((plain.colors - out.colors).abs().max()) > 1e-4


def test_cached_haloed_refused_when_training(dense):
    """A cached haloed table would give feat_pool a zero gradient: a
    query that differentiates feat_pool refuses it."""
    cfg = dense["tcfg"].model
    p = {"feat_pool": dense["tp"]["field"]["feat_pool"].clone(),
         "mlp": dense["tp"]["field"]["mlp"]}
    cached = dict(p, haloed=thf.haloed_table(p, cfg))
    p["feat_pool"].requires_grad_(True)
    pts = torch.rand(50, 3) * 4 - 2
    with pytest.raises(ValueError, match="haloed"):
        thf.query(cached, pts, cfg)
    with torch.no_grad():        # no gradient asked: the cache is fine
        torch.testing.assert_close(thf.query(cached, pts, cfg),
                                   thf.query(p, pts, cfg), rtol=0, atol=0)
    thf.query(p, pts, cfg)[:, 0].sum().backward()
    assert float(p["feat_pool"].grad.abs().max()) > 0
