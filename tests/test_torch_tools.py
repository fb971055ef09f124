"""Port parity for the tools around a map: image undistortion (bitwise),
the LPIPS(vgg) metric (random weights: the real ones need a download)
and ``scripts/export_torch_params.py``, which turns a JAX run directory
into the port's ``torch_params.npz``.

Tolerances: undistort bitwise; LPIPS rtol 1e-6 (the same torch ops on
the same weights); a converted run's render atol 1e-5 against the JAX
renderer on the same params and consts (``test_torch_cli.py``'s).
"""

import dataclasses
import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from f2nerf_tpu.core.config import Config as JConfig
from f2nerf_tpu.data.synthetic import make_sphere_dataset
from f2nerf_tpu.models import renderer as jrend
from f2nerf_tpu.train.loop import Trainer as JTrainer
from f2nerf_tpu.utils import lpips as jlp
from f2nerf_tpu.utils import undistort as jud
from f2nerf_tpu_torch.localize import localizer as tloc
from f2nerf_tpu_torch.utils import lpips as tlp
from f2nerf_tpu_torch.utils import undistort as tud

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _export_script():
    spec = importlib.util.spec_from_file_location(
        "export_torch_params", ROOT / "scripts" / "export_torch_params.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(24, 32, 3), (17, 40, 1)])
def test_undistort_bitwise(shape):
    rng = np.random.default_rng(shape[0])
    h, w = shape[:2]
    k = np.array([[30.0, 0, w / 2 + 0.3], [0, 28.0, h / 2 - 0.2], [0, 0, 1]])
    dist = np.array([-0.21, 0.05, 1e-3, -2e-3])
    img = rng.random(shape).astype(np.float32)
    for a, b in zip(tud.build_undistort_map(k, dist, h, w),
                    jud.build_undistort_map(k, dist, h, w)):
        np.testing.assert_array_equal(a, b)
    mi, mj = jud.build_undistort_map(k, dist, h, w)
    np.testing.assert_array_equal(tud.remap_bilinear(img, mi, mj),
                                  jud.remap_bilinear(img, mi, mj))
    out = tud.undistort_image(img, k, dist)
    np.testing.assert_array_equal(out, jud.undistort_image(img, k, dist))
    assert out.dtype == img.dtype and not np.array_equal(out, img)


def test_lpips_matches_jax_package(tmp_path):
    """One random-weight file (either package writes the same one) read
    by both; the port on the CPU gives the JAX package's distances."""
    pj, pt = tmp_path / "j.pt", tmp_path / "t.pt"
    jlp.make_random_weights(pj, seed=3)
    tlp.make_random_weights(pt, seed=3)
    sj = torch.load(pj, weights_only=True)
    st = torch.load(pt, weights_only=True)
    for k, v in sj["features"].items():
        assert torch.equal(st["features"][k], v), k
    for a, b in zip(st["lin"], sj["lin"]):
        assert torch.equal(a, b)
    mj, mt = jlp.load(pj), tlp.load(pj, device="cpu")
    assert mt.device.type == "cpu"
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    y = torch.rand(2, 3, 32, 32, generator=g) * 2 - 1
    d = mt(x, y)
    assert np.isfinite(d) and d > 0
    np.testing.assert_allclose(d, mj(x, y), rtol=1e-6)
    assert mt(x, x) == 0.0
    assert tlp.load(tmp_path / "nope.pt", device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlp.load(pj)


def _jax_run(root, name, **model):
    """A JAX Trainer run of 3 steps on a 24x24 sphere scene, saved."""
    cfg = JConfig.tiny()
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, n_levels=2,
                                       log2_table_size=11, n_samples=24,
                                       sample_l=1.0 / 6.0, **model),
        train=dataclasses.replace(cfg.train, pts_batch_size=8192))
    ds = make_sphere_dataset(n_images=4, h=24, w=24)
    run = root / name
    tr = JTrainer(cfg, ds, result_dir=run)
    tr.run(3)
    tr.save_checkpoint()
    return run, tr, ds


@pytest.mark.parametrize("mode", ["contract", "perspective", "xor"])
def test_export_torch_params(mode, tmp_path):
    """The port serves a converted JAX run: from_checkpoint on the
    exported file renders what the JAX renderer renders with the
    trainer's params and consts."""
    model = {"perspective": {"warp_mode": "perspective"},
             "xor": {"hash_mode": "xor"}}.get(mode, {})
    run, tr, ds = _jax_run(tmp_path, mode, **model)
    path = _export_script().export(run)
    assert path == run / "torch_params.npz"
    with np.load(path) as data:
        keys = set(data.files)
        if mode == "xor":
            assert data["consts/field/primes"].dtype == np.uint32
    want = {"contract": set(),
            "perspective": {"consts/field/warp_anchors",
                            "consts/field/warp_rows"},
            "xor": {"consts/field/primes", "consts/field/biases",
                    "consts/field/scales"}}[mode]
    assert {k for k in keys if k.startswith("consts/")} == want
    assert "occ_grid" in keys and "field/feat_pool" in keys
    loc = tloc.Localizer.from_checkpoint(run, device="cpu")
    pose = ds.poses[1]
    ref, _ = jrend.render_image(tr.params, tr.consts, jnp.asarray(pose),
                                jnp.asarray(loc.intrinsic.numpy()),
                                loc.infer_height, loc.infer_width,
                                tr.cfg.model)
    out = loc.render_image(pose).numpy()
    assert np.asarray(ref).std() > 1e-4
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
