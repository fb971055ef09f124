"""Port parity: the XOR-prime hash (``hash_mode="xor"``,
f2nerf_tpu_torch.ops.hash_encode and the xor branch of the field) against
the JAX package on the CPU, in fp32.

Tolerances: corner indices exactly (before any feature), trilinear
weights and encoded features atol 1e-6; ``init_primes`` bitwise; the
VALIDATE render as ``test_torch_render.py`` holds it; three training
steps as ``test_torch_two_pass.check_steps`` holds them; localizer
particle weights as ``test_torch_localize.py`` holds them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_two_pass import check_steps, run_steps

from f2nerf_tpu.localize import localizer as jloc
from f2nerf_tpu.models import hash_field as jhf
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.ops import hash_encode as jhe
from f2nerf_tpu_torch.convert import flatten, tree_from_numpy
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
from f2nerf_tpu_torch.localize import localizer as tloc
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.models import renderer as trend
from f2nerf_tpu_torch.ops import hash_encode as the
from f2nerf_tpu_torch.train import checkpoint as tckpt
from f2nerf_tpu_torch.train.loop import Trainer as TTrainer

L = 4


def _consts(seed=0, n_levels=L):
    rng = np.random.default_rng(seed)
    primes = jhe.init_primes(rng, n_levels)
    biases = rng.uniform(100.0, 1100.0, (n_levels, 3)).astype(np.float32)
    return primes, biases, jhe.level_scales(n_levels)


def _points(n, seed):
    pts = np.random.default_rng(seed).uniform(-2.5, 2.5, (n, 3)).astype(
        np.float32)
    pts[:16] *= 400.0      # far negative and positive: the saturation
    return pts


@pytest.mark.parametrize("table_size", [1 << 12, 3000])
def test_corner_indices_exact(table_size):
    """Power-of-two tables mask, others take the remainder; negative
    cells saturate to 0 as CUDA's float -> unsigned does."""
    primes, biases, scales = _consts(1)
    pts = _points(4000, 2)
    assert (pts * scales[-1] + biases[-1].min() < 0).any()
    ij, wj = jhe.hash_corner_indices(jnp.asarray(pts), jnp.asarray(primes),
                                     jnp.asarray(biases), jnp.asarray(scales),
                                     table_size)
    it, wt = the.hash_corner_indices(
        torch.tensor(pts), torch.tensor(primes.astype(np.int64)),
        torch.tensor(biases), torch.tensor(scales), table_size)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert it.min() >= 0 and it.max() < table_size
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hash_encode_features(dtype):
    primes, biases, scales = _consts(3)
    pool = np.random.default_rng(4).uniform(-1, 1, (L, 1 << 12, 2)).astype(
        np.float32)
    pts = _points(3000, 5)
    jpool = jnp.asarray(pool).astype(dtype)
    tpool = torch.tensor(pool).to(getattr(torch, dtype))
    fj = jhe.hash_encode(jnp.asarray(pts), jpool, jnp.asarray(primes),
                         jnp.asarray(biases), jnp.asarray(scales))
    ft = the.hash_encode(torch.tensor(pts), tpool,
                         torch.tensor(primes.astype(np.int64)),
                         torch.tensor(biases), torch.tensor(scales))
    assert ft.shape == (3000, 2 * L) and ft.dtype == torch.float32
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-6)


def test_init_primes_and_consts(tiny_cfg):
    """init_primes bitwise from one Generator; init_consts draws the
    primes JAX's renderer.init draws (np_seed 2022 by default, not
    cfg.init_seed) and the same scales."""
    for seed in (0, 7):
        np.testing.assert_array_equal(
            the.init_primes(np.random.default_rng(seed), 8),
            jhe.init_primes(np.random.default_rng(seed), 8))
    jm = dataclasses.replace(tiny_cfg.model, hash_mode="xor", init_seed=5)
    tm = TConfig.from_dict({"model": dataclasses.asdict(jm)}).model
    _, jc = jrend.init(jax.random.key(0), jm, 2)
    g = torch.Generator().manual_seed(0)
    tc = thf.init_consts(g, tm, torch.device("cpu"))
    assert tc["primes"].dtype == torch.int64
    np.testing.assert_array_equal(tc["primes"].numpy(),
                                  np.asarray(jc["field"]["primes"]))
    np.testing.assert_array_equal(tc["scales"].numpy(),
                                  np.asarray(jc["field"]["scales"]))
    b = tc["biases"].numpy()
    assert b.shape == (2, 3) and b.min() >= 100.0 and b.max() < 1100.0
    p = thf.init(g, tm, torch.device("cpu"))
    assert p["feat_pool"].shape == (2, 1 << 10, 2)
    assert float(p["feat_pool"].abs().max()) <= 1e-4
    assert thf.init_consts(g, dataclasses.replace(tm, hash_mode="paged"),
                           torch.device("cpu")) == {}
    with pytest.raises(ValueError, match="primes"):
        thf.query(p, torch.zeros(4, 3), tm, consts={})


def _scene(jcfg, seed):
    """JAX params with O(1) features and their consts, both converted."""
    params, consts = jrend.init(jax.random.key(seed), jcfg.model, 4)
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    tree["field"]["feat_pool"] = rng.uniform(
        -1.0, 1.0, tree["field"]["feat_pool"].shape).astype(np.float32)
    tree["field"]["mlp"]["b"] = tree["field"]["mlp"]["b"].copy()
    tree["field"]["mlp"]["b"][0] = 4.0
    ctree = jax.tree.map(np.asarray, consts)
    return dict(jp=jax.tree.map(jnp.asarray, tree), jc=consts, tree=tree,
                ctree=ctree, tp=tree_from_numpy(tree, "cpu"),
                tc=tree_from_numpy(ctree, "cpu"),
                tcfg=TConfig.from_dict(dataclasses.asdict(jcfg)))


@pytest.fixture(scope="module")
def xor_cfg(tiny_cfg):
    return dataclasses.replace(tiny_cfg, model=dataclasses.replace(
        tiny_cfg.model, hash_mode="xor"))


@pytest.fixture(scope="module")
def scene(xor_cfg):
    return _scene(xor_cfg, 0)


def test_field_query(scene, xor_cfg):
    pts = np.random.default_rng(6).uniform(-3, 3, (2000, 3)).astype(
        np.float32)
    ref = jhf.query(scene["jp"]["field"], scene["jc"]["field"],
                    jnp.asarray(pts), xor_cfg.model)
    out = thf.query(scene["tp"]["field"], torch.tensor(pts),
                    scene["tcfg"].model, consts=scene["tc"]["field"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def validate_rays(scene, xor_cfg):
    """256 rays and JAX's VALIDATE render of them."""
    rng = np.random.default_rng(7)
    o = rng.uniform(-0.3, 0.3, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    cfg = xor_cfg.model
    ref = jax.jit(lambda p, c, o_, d_: jrend.render(
        p, c, o_, d_, None, cfg, None, train=False))(
            scene["jp"], scene["jc"], jnp.asarray(o), jnp.asarray(d))
    return o, d, ref


@pytest.mark.parametrize("via", ["convert", "trainer"])
def test_render_validate(scene, validate_rays, via):
    """The JAX params and consts converted, or handed to the port's
    Trainer (``params=``, ``consts=``), render what JAX renders."""
    o, d, ref = validate_rays
    params, consts = scene["tp"], scene["tc"]
    if via == "trainer":
        ds = make_sphere_dataset(n_images=4, h=16, w=16)
        with pytest.raises(ValueError, match="consts="):
            TTrainer(scene["tcfg"], ds, device="cpu", params=scene["tree"])
        tr = TTrainer(scene["tcfg"], ds, device="cpu", params=scene["tree"],
                      consts=scene["ctree"])
        params, consts = tr.params, tr.consts
        for k, v in flatten(scene["tc"]).items():
            assert torch.equal(flatten(consts)[k], v), k
    with torch.no_grad():
        out = trend.render(params, torch.tensor(o), torch.tensor(d),
                           scene["tcfg"].model, consts=consts)
    np.testing.assert_array_equal(out.mask.numpy(), np.asarray(ref.mask))
    for name in ("colors", "depths"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(ref.weights),
                               atol=1e-4, rtol=1e-3)
    assert float(out.weights.sum(-1).max()) > 0.5
    assert float(out.colors.std()) > 1e-2


def test_train_steps(xor_cfg):
    """Three steps of both trainers, xor constants carried over."""
    check_steps(run_steps(xor_cfg, TConfig.from_dict(
        dataclasses.asdict(xor_cfg)), seed=5, step0=14, consts=True))


def test_trainer_checkpoint_and_npz_round_trip(xor_cfg, tmp_path):
    """The trainer draws the JAX Trainer's primes (np_seed =
    cfg.train.seed); state.pt and torch_params.npz carry the constants
    back (the npz's uint32 primes as int64)."""
    tcfg = TConfig.from_dict(dataclasses.asdict(xor_cfg))
    ds = make_sphere_dataset(n_images=4, h=16, w=16)
    run = tmp_path / "run"
    tr = TTrainer(tcfg, ds, result_dir=run, device="cpu")
    c = tr.consts["field"]
    np.testing.assert_array_equal(
        c["primes"].numpy(),
        jhe.init_primes(np.random.default_rng(tcfg.train.seed), 2))
    assert set(tr.optimizer.named) == {"field/feat_pool", "field/mlp/w",
                                       "field/mlp/b", "shader/w0",
                                       "shader/b0", "shader/w1", "shader/b1",
                                       "app_emb"}
    tr.run(2)
    tr.save_checkpoint()
    tr.close()
    state = tckpt.restore(run / "checkpoints")
    assert state["consts"]["field/primes"].dtype == torch.int64
    tr2 = TTrainer(tcfg, ds, result_dir=run, device="cpu")
    tr2.consts = {}
    assert tr2.try_resume()
    for k, v in flatten(tr.consts).items():
        assert torch.equal(flatten(tr2.consts)[k], v), k
    tr2.close()

    loc = tloc.Localizer.from_checkpoint(run, device="cpu")
    assert "haloed" not in loc.params["field"]
    for k, v in flatten(tr.consts).items():
        assert torch.equal(flatten(loc.consts)[k], v), k
    npz_run = tmp_path / "npz"
    npz_run.mkdir()
    for f in ("train_config.yaml", "inference_params.yaml"):
        (npz_run / f).write_text((run / f).read_text())
    flat = {k: v.numpy() for k, v in state["params"].items()}
    flat.update({f"consts/{k}": v.numpy() for k, v in state["consts"].items()})
    flat["consts/field/primes"] = flat["consts/field/primes"].astype(np.uint32)
    np.savez(npz_run / "torch_params.npz", **flat)
    loc2 = tloc.Localizer.from_checkpoint(npz_run, device="cpu")
    for k, v in flatten(tr.consts).items():
        assert torch.equal(flatten(loc2.consts)[k], v), k
    pose = ds.poses[0]
    torch.testing.assert_close(loc2.render_image(pose),
                               loc.render_image(pose), rtol=0, atol=0)


def test_localizer_mode0(scene, xor_cfg):
    """Particle weights of the same particles and pixels (one seed) on
    both localizers."""
    h, w = 16, 16
    intr = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    center, radius = np.zeros(3, np.float32), 1.0
    jl = jloc.Localizer(scene["jp"], scene["jc"], xor_cfg, intr, center,
                        radius, h, w, seed=3)
    tl = tloc.Localizer(scene["tp"], scene["tcfg"], intr, center, radius, h,
                        w, seed=3, device="cpu", consts=scene["tc"])
    assert "haloed" not in tl.params["field"]
    pose = np.eye(3, 4, dtype=np.float32)
    pose[:, 3] = [0.05, 0.0, 0.3]
    image = np.asarray(jl.render_image(pose + 0.01))
    np.testing.assert_allclose(tl.render_image(pose + 0.01).numpy(), image,
                               atol=1e-5)
    pj = jl.optimize_pose_by_random_search(pose, image, 8, 1.0)
    pt = tl.optimize_pose_by_random_search(pose, image, 8, 1.0)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a.pose, b.pose)
    np.testing.assert_allclose([p.weight for p in pt],
                               [p.weight for p in pj], atol=1e-4)
