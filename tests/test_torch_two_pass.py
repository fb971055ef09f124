"""Port parity: the dense two-pass TRAIN renderer
(f2nerf_tpu_torch.models.renderer._render_two_pass, hash_field
.query_compacted) against the JAX package on the CPU, in fp32.

The two-pass equals the masked single pass (JAX ``TestDenseTwoPass``,
``tests/test_renderer.py:187-280``), so the port's two-pass is held
against JAX's single pass, jitted, with JAX's own draws injected, at
JAX's own tolerances: colors rtol/atol 1e-5, depths 1e-4, weights rtol
1e-5 atol 1e-6, the mask exactly, ``sec_density`` under the mask, zero
outside it; param grads rtol 5e-3 atol 1e-6 against the port's own
single pass, and against JAX's with the atol of ``test_torch_train.py``
(1e-3 of each leaf's largest |grad|). JAX's two-pass itself
is run once, eagerly, to hold the bucket and the mask: jitting the
grads of all its branches is what makes JAX's own test slow. The
training steps are held to ``test_torch_train.py``'s tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_train import N_IMAGES, _record, _setup, jax_noise

from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.train.optim import make_optimizer as jmake_optimizer
from f2nerf_tpu.train.step import make_train_step as jmake_train_step
from f2nerf_tpu_torch.convert import flatten, tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.models import renderer as trend
from f2nerf_tpu_torch.train import optim as topt
from f2nerf_tpu_torch.train import step as tstep

R = 16


def _tcfg(jcfg, **model):
    cfg = TConfig.from_dict(dataclasses.asdict(jcfg))
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                              **model))


class _Noise:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _rays(seed):
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((R, 3)) * 0.2).astype(np.float32)
    d = rng.standard_normal((R, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _bucket_spy(monkeypatch):
    """Records the point count of each compacted query (the bucket)."""
    sizes = []
    orig = thf.query_compacted

    def spy(params, points, *a, **kw):
        sizes.append(points.shape[0])
        return orig(params, points, *a, **kw)

    monkeypatch.setattr(thf, "query_compacted", spy)
    return sizes


def _expected_bucket(mask):
    n, n_surv = mask.size, int(mask.sum())
    return next((b for b in (n // 8, n // 4, n // 2) if n_surv <= b), None)


def _compare(jmodel, monkeypatch, seed=0):
    """The port's two-pass against JAX's masked single pass on R rays:
    outputs and the grads of sum(colors) + sum(depths) + sum(weights*t).
    Returns the port's result and the bucket it took."""
    jcfg_sp = dataclasses.replace(jmodel, dense_two_pass=False)
    tcfg = TConfig.from_dict({"model": dataclasses.asdict(jmodel)}).model
    tcfg = dataclasses.replace(tcfg, dense_two_pass=True)
    params, consts = jrend.init(jax.random.key(seed), jmodel, 4)
    o, d = _rays(seed + 1)
    emb = np.zeros((R,), np.int32)
    key = jax.random.key(3)

    def loss(p):
        res = jrend.render(p, consts, jnp.asarray(o), jnp.asarray(d),
                           jnp.asarray(emb), jcfg_sp, key, train=True,
                           point_grads=False)
        return (jnp.sum(res.colors) + jnp.sum(res.depths)
                + jnp.sum(res.weights * res.t)), res

    (_, ref), g_ref = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    key_noise, key_bg = jax.random.split(key)
    noise = _Noise(
        bg=torch.tensor(np.asarray(jax.random.uniform(key_bg, (R, 3)))),
        march=torch.tensor(np.asarray(jax.random.uniform(
            key_noise, (R, jmodel.n_samples)))))
    sizes = _bucket_spy(monkeypatch)
    grads = {}
    for two_pass in (False, True):
        tparams = tree_from_numpy(jax.tree.map(np.asarray, params), "cpu")
        leaves = flatten(tparams)
        for p in leaves.values():
            p.requires_grad_(True)
        out = trend.render(tparams, torch.tensor(o), torch.tensor(d),
                           dataclasses.replace(tcfg, dense_two_pass=two_pass),
                           emb_idx=torch.tensor(emb).long(), noise=noise)
        (out.colors.sum() + out.depths.sum()
         + (out.weights * out.t).sum()).backward()
        grads[two_pass] = {k: p.grad.numpy() for k, p in leaves.items()}

    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), m)
    np.testing.assert_allclose(out.colors.detach().numpy(),
                               np.asarray(ref.colors), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.depths.detach().numpy(),
                               np.asarray(ref.depths), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.weights.detach().numpy(),
                               np.asarray(ref.weights), rtol=1e-5, atol=1e-6)
    sec = out.sec_density.detach().numpy()
    np.testing.assert_allclose(sec * m, np.asarray(ref.sec_density) * m,
                               rtol=1e-5, atol=1e-6)
    assert float(np.abs(sec * ~m).max()) == 0.0
    assert out.explore is None
    # grads: the port's two-pass against its own single pass at JAX's
    # tolerance, and against JAX's at test_torch_train's (f32 sums in
    # another order cancel to ~1e-4 of the leaf's largest |grad|)
    g_ref = flatten(jax.tree.map(np.asarray, g_ref))
    for name, g in grads[True].items():
        np.testing.assert_allclose(g, grads[False][name], rtol=5e-3,
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            g, g_ref[name], rtol=5e-3,
            atol=1e-3 * float(np.abs(g_ref[name]).max()), err_msg=name)
    bucket = _expected_bucket(m)
    # a compact bucket queries its NB points once; the full bucket none
    assert sizes == ([] if bucket is None else [bucket])
    return out, bucket


def test_full_bucket(tiny_cfg, monkeypatch):
    """Seeded init: nothing terminates, the single pass runs."""
    out, bucket = _compare(tiny_cfg.model, monkeypatch)
    assert bool(out.mask.all()) and bucket is None


def test_prefix_bucket(tiny_cfg, monkeypatch):
    """A boosted density terminates rays early: a compact bucket."""
    cfg = dataclasses.replace(tiny_cfg.model, density_shift=-2.0)
    out, bucket = _compare(cfg, monkeypatch)
    assert bucket is not None and bucket < out.mask.numel()


def test_prefix_bucket_survivor_dedup(tiny_cfg, monkeypatch):
    """dense_two_pass_dedup at a dense-point-like sample count: the
    port encodes flat (query_compacted), the same values."""
    cfg = dataclasses.replace(tiny_cfg.model, n_samples=256,
                              sample_l=1.0 / 64.0, density_shift=-2.0,
                              dense_two_pass_dedup=True)
    out, bucket = _compare(cfg, monkeypatch)
    assert bucket is not None


def test_jax_two_pass_bucket_and_mask(tiny_cfg, monkeypatch):
    """One eager forward of JAX's own two-pass: the port takes the same
    bucket, gives the same mask and agrees on the outputs."""
    jm = dataclasses.replace(tiny_cfg.model, density_shift=-4.0,
                             dense_two_pass=True)
    tm = TConfig.from_dict({"model": dataclasses.asdict(jm)}).model
    params, consts = jrend.init(jax.random.key(1), jm, 4)
    o, d = _rays(5)
    key = jax.random.key(6)
    ref = jrend.render(params, consts, jnp.asarray(o), jnp.asarray(d), None,
                       jm, key, train=True, point_grads=False)
    key_noise, key_bg = jax.random.split(key)
    noise = _Noise(
        bg=torch.tensor(np.asarray(jax.random.uniform(key_bg, (R, 3)))),
        march=torch.tensor(np.asarray(jax.random.uniform(
            key_noise, (R, jm.n_samples)))))
    sizes = _bucket_spy(monkeypatch)
    with torch.no_grad():
        out = trend.render(tree_from_numpy(jax.tree.map(np.asarray, params),
                                             "cpu"),
                           torch.tensor(o), torch.tensor(d), tm, noise=noise)
    m = np.asarray(ref.mask)
    np.testing.assert_array_equal(out.mask.numpy(), m)
    bucket = _expected_bucket(m)
    assert bucket is not None and sizes == [bucket]
    np.testing.assert_allclose(out.colors.numpy(), np.asarray(ref.colors),
                               rtol=1e-5, atol=1e-5)
    # JAX's two-pass takes each ray's exclusive prefix from one cumsum
    # over the whole compacted batch minus the rays before it, so its
    # transmittance carries the rounding of the batch's total optical
    # depth (~1e3 here: 1.5e-5 relative measured); the port's per-ray
    # cumsum does not
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(out.sec_density.numpy(),
                               np.asarray(ref.sec_density), rtol=1e-5,
                               atol=1e-6)


def run_steps(jcfg, tcfg, seed, step0, n_steps=3, consts=False):
    """``n_steps`` of the JAX trainer on ``jcfg`` and of the port on
    ``tcfg`` from the same params (``test_torch_train._setup``), batches
    and draws; ``consts``: carry ``renderer.init``'s constants (xor).
    Per step: metrics, grads and params after the update on both sides,
    and the lr; the port's bucket sizes."""
    tree, poses, intr, batches, _ = _setup(jcfg, seed)
    jconsts = {"field": {}}
    tconsts = {}
    if consts:
        jconsts = jrend.init(jax.random.key(seed), jcfg.model, N_IMAGES)[1]
        tconsts = tree_from_numpy(jax.tree.map(np.asarray, jconsts), "cpu")
    jopt = optax.chain(_record(), jmake_optimizer(jcfg.train))
    jstep = jax.jit(jmake_train_step(jcfg, jopt))
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jopt.init(jparams)
    tparams = tree_from_numpy(tree, "cpu")
    opt = topt.make_optimizer(tparams, tcfg.train)
    tstep_fn = tstep.make_train_step(tcfg, opt)
    out = []
    for k in range(n_steps):
        step = step0 + k
        cam, ij, gt = batches[k]
        before = flatten(jax.tree.map(np.asarray, jparams))
        jparams, jstate, _, jm = jstep(
            jparams, jstate, jnp.zeros((1,)), jconsts, jnp.asarray(poses),
            jnp.asarray(intr), jnp.asarray(step, jnp.int32), jnp.asarray(cam),
            jnp.asarray(ij), jnp.asarray(gt))
        lr = opt.adam.param_groups[0]["lr"]
        _, tm = tstep_fn(tparams, None, torch.tensor(poses),
                         torch.tensor(intr), step, torch.tensor(cam),
                         torch.tensor(ij), torch.tensor(gt),
                         noise=jax_noise(jcfg, step, len(cam)),
                         consts=tconsts)
        out.append(dict(
            lr=lr, before=before,
            jax=dict(metrics=np.array([float(x) for x in jm]),
                     grads=flatten(jax.tree.map(np.asarray, jstate[0])),
                     params=flatten(jax.tree.map(np.asarray, jparams))),
            port=dict(metrics=np.array([float(x) for x in tm]),
                      grads={n: p.grad.numpy().copy()
                             for n, p in opt.named.items()},
                      params={n: p.detach().numpy().copy()
                              for n, p in opt.named.items()})))
    return out


def check_steps(steps):
    """``test_torch_train.py``'s tolerances for metrics (rtol 1e-5) and
    grads (atol 1e-3, 1e-2 in the third step, of each leaf's largest
    |grad|); params as ``chip_smoke.py``'s step check holds them: every
    entry within 2.05 lr and at most 0.1% of them beyond 0.05 lr (an
    Adam step moves an entry by about lr whatever its grad, so a
    near-zero grad that rounds the other way moves it up to 2 lr apart;
    the boosted density of these runs makes such entries)."""
    lr_max = max(s["lr"] for s in steps)
    assert steps[0]["lr"] == 0.0 and lr_max > 0.0
    for k, s in enumerate(steps):
        j, t = s["jax"], s["port"]
        np.testing.assert_allclose(t["metrics"], j["metrics"], rtol=1e-5,
                                   err_msg=f"step {k}")
        assert set(t["grads"]) == set(j["grads"])
        rel = 1e-3 if k < 2 else 1e-2
        for name, gj in j["grads"].items():
            scale = float(np.abs(gj).max())
            assert scale > 0, (k, name)
            np.testing.assert_allclose(t["grads"][name], gj, rtol=0,
                                       atol=rel * scale,
                                       err_msg=f"step {k} {name}")
        for name, pj in j["params"].items():
            dev = np.abs(t["params"][name] - pj)
            assert dev.max() <= 2.05 * lr_max, (k, name, dev.max())
            assert np.mean(dev > 0.05 * lr_max) <= 1e-3, (k, name)
    assert any(not np.array_equal(p, steps[-1]["before"][n])
               for n, p in steps[-1]["port"]["params"].items())


def test_train_steps(tiny_cfg, monkeypatch):
    """Three steps with the two-pass on in the port, against JAX's
    single pass (the same function; JAX's jitted two-pass would compile
    the grads of every bucket). The boosted density puts every step in a
    compact bucket."""
    jcfg = dataclasses.replace(tiny_cfg, model=dataclasses.replace(
        tiny_cfg.model, density_shift=-2.0))
    tcfg = _tcfg(jcfg, dense_two_pass=True)
    sizes = _bucket_spy(monkeypatch)
    steps = run_steps(jcfg, tcfg, seed=4, step0=14)
    n = tcfg.train.rays_per_step * tcfg.model.n_samples
    assert len(sizes) == 3 and all(s < n for s in sizes)
    check_steps(steps)


def test_two_pass_taken_only_where_jax_takes_it(tiny_cfg, monkeypatch):
    """VALIDATE, the occupancy sampler and S % 8 != 0 take the single
    pass; an unknown hash mode raises."""
    tm = dataclasses.replace(_tcfg(tiny_cfg).model, dense_two_pass=True,
                             density_shift=-4.0)
    g = torch.Generator().manual_seed(0)
    params = trend.init(g, tm, 4, torch.device("cpu"))
    o, d = _rays(7)
    sizes = _bucket_spy(monkeypatch)
    with torch.no_grad():
        trend.render(params, torch.tensor(o), torch.tensor(d), tm)
        odd = dataclasses.replace(tm, n_samples=30)
        trend.render(params, torch.tensor(o), torch.tensor(d), odd,
                     noise=_Noise(bg=torch.rand(R, 3),
                                  march=torch.rand(R, 30)))
        assert sizes == []
        trend.render(params, torch.tensor(o), torch.tensor(d), tm,
                     noise=_Noise(bg=torch.rand(R, 3),
                                  march=torch.rand(R, tm.n_samples)))
    assert len(sizes) == 1
    with pytest.raises(ValueError, match="hash_mode"):
        thf.query(params["field"], torch.zeros(4, 3),
                  dataclasses.replace(tm, hash_mode="cuckoo"))
