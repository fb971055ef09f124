"""Port parity for the tools (``f2nerf_tpu_torch/tools/``) against the
JAX package's scripts (``scripts/``, ``examples/``) on the CPU.

What is held, and how:
* every tool's positional arguments, flags, defaults, types and choices
  equal its script's (the parsers are caught as each ``main`` parses);
  the port adds ``--device`` to the tools that run the model;
* the decisions, bitwise: the config and the holdout split of
  ``quality_run``, the perturbation draws of ``localize_validation`` and
  ``localize_envelope`` (their printed reports equal line for line over a
  stub localizer), the interpolated poses, the replay's poses, the dataset
  files (``cams_meta.tsv`` as text, the images decoded), the undistortion
  and the crops;
* the outputs at the tolerance already held for their numeric path:
  ``eval``'s PSNR and SSIM atol 1e-9 and LPIPS rtol 1e-6 (``ssim`` equal
  to 1e-12, ``test_torch_data.py``; LPIPS ``test_torch_tools.py``); a
  resize within one level of 255 (``test_torch_localize.py``);
  ``quality_run``'s ``summary.tsv`` and ``eval_holdout``'s
  ``holdout_summary.tsv`` after 4 steps of both trainers from one init,
  one batch stream and one set of draws (``test_torch_loop.py``'s set-up;
  ``Config.quality``'s model cut to ``tiny_cfg``'s in both packages):
  PSNR atol 1e-3 dB, SSIM atol 1e-4, score rtol 1e-3 (the renders of
  params that agree to 0.05 lr, ``test_torch_loop.py``);
* ``diag_holdout`` and ``eval_appearance_ab`` against the scripts on
  those two runs (the values each script prints, read unrounded from the
  metric and percentile calls); ``bench_scaling``'s lines over stubbed
  rates, and a real run on two gloo ranks;
* each tool family runs in a subprocess where ``jax``, ``PIL``, ``yaml``
  and ``f2nerf_tpu`` raise on import: what the machine with the card has.
"""

import argparse
import dataclasses
import functools
import importlib.util
import json
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_train import jax_noise

from f2nerf_tpu.core.config import Config as JConfig
from f2nerf_tpu.data import dataset as jdata
from f2nerf_tpu.localize import localizer as jloc
from f2nerf_tpu.models import renderer as jrenderer
from f2nerf_tpu.train import checkpoint as jckpt
from f2nerf_tpu.train import loop as jloop
from f2nerf_tpu.utils import lpips as jlp
from f2nerf_tpu.utils import metrics as jmetrics
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.tools import (bench_localize, bench_scaling, common,
                                    concat_inference_images, crop_images,
                                    diag_holdout, eval as teval,
                                    eval_appearance_ab, eval_holdout,
                                    inter_poses, localize_envelope,
                                    localize_validation,
                                    make_synthetic_dataset, quality_run,
                                    rectify_images, replay_dataset,
                                    resize_images, train_synthetic)
from f2nerf_tpu_torch.train import loop as tloop
from f2nerf_tpu_torch.utils.image_io import read_image, write_image

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _script(name: str):
    """A JAX script (``scripts/<name>.py``) as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


@pytest.fixture
def no_jax_cache(monkeypatch):
    """The scripts point JAX's compilation cache at a directory outside
    the checkout; tests leave JAX's config alone."""
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)


def _run_script(monkeypatch, name: str, argv: list[str]):
    """Run the JAX script's ``main`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    return _script(name).main()


# -- flags ---------------------------------------------------------------


def _caught_parser(monkeypatch, run) -> argparse.ArgumentParser:
    """The parser ``run()`` parses with; ``run`` stops right after."""
    caught = {}

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Stop):
            run()
    return caught["parser"]


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     None if a.choices is None else tuple(a.choices),
                     a.nargs, a.required, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


# script name: (the port's tool, whether the tool adds --device)
TOOLS = {
    "eval": (teval, True),
    "make_synthetic_dataset": (make_synthetic_dataset, False),
    "quality_run": (quality_run, True),
    "eval_holdout": (eval_holdout, True),
    "localize_validation": (localize_validation, True),
    "localize_envelope": (localize_envelope, True),
    "bench_localize": (bench_localize, True),
    "inter_poses": (inter_poses, False),
    "replay_dataset": (replay_dataset, False),
    "resize_images": (resize_images, False),
    "crop_images": (crop_images, False),
    "rectify_images": (rectify_images, False),
    "concat_inference_images": (concat_inference_images, False),
    "diag_holdout": (diag_holdout, True),
    "eval_appearance_ab": (eval_appearance_ab, True),
    "bench_scaling": (bench_scaling, True)}


@pytest.mark.parametrize("name", list(TOOLS))
def test_flags_match_the_script(name, monkeypatch, no_jax_cache):
    port, has_device = TOOLS[name]
    jp = _caught_parser(monkeypatch, lambda: _run_script(monkeypatch, name,
                                                          []))
    tp = _caught_parser(monkeypatch, lambda: port.main([]))
    want = _flags(jp)
    got = _flags(tp)
    if has_device:
        assert got.pop("device")[:2] == (("--device",), None)
    assert got == want


# -- decisions -----------------------------------------------------------


class _StopTrainer:
    """A trainer that records what it was built with and stops the run."""
    seen: list = []

    def __init__(self, cfg, ds, *a, **kw):
        type(self).seen.append((cfg, ds, kw))
        raise _Stop


QUALITY_FLAGS = {
    "holdout": ["r", "--scene", "textured", "--n_images", "12", "--hw", "16",
                "--holdout", "4"],
    "overrides": [
        "r", "--scene", "corridor", "--n_images", "9", "--hw", "12",
        "--steps", "3000", "--rays", "1024", "--lr", "2e-3", "--sampler",
        "dense", "--n_levels", "4", "--log2_table_size", "12",
        "--n_channels", "2", "--warp_mode", "perspective", "--warp_blend_k",
        "1", "--occ_thresh", "0.02", "--occ_decay", "0.7",
        "--occ_explore_targeted", "0", "--occ_trans_eps", "1e-5",
        "--sample_near", "0.1", "--occ_explore_slots", "2",
        "--var_loss_weight", "1e-3", "--var_loss_mode", "weight_var",
        "--var_loss_start", "10", "--var_loss_end", "20",
        "--grad_clip_norm", "1.0", "--feat_pool_weight_decay", "1e-6",
        "--explore_sparsity_weight", "0.0", "--global_sparsity_weight",
        "1e-4", "--occ_reg_weight", "0.1", "--occ_reg_t", "0.2",
        "--train_app_emb", "0", "--level_anneal_end", "100"]}


@pytest.mark.parametrize("which", list(QUALITY_FLAGS))
def test_quality_run_config_and_split(which, monkeypatch, tmp_path,
                                      no_jax_cache):
    argv = QUALITY_FLAGS[which]
    argv = [str(tmp_path / "r"), *argv[1:]]
    _StopTrainer.seen = []
    monkeypatch.setattr(jloop, "Trainer", _StopTrainer)
    monkeypatch.setattr(quality_run, "Trainer", _StopTrainer)
    with pytest.raises(_Stop):
        _run_script(monkeypatch, "quality_run", argv)
    with pytest.raises(_Stop):
        quality_run.main([*argv, "--device", "cpu"])
    (jcfg, jds, _), (tcfg, tds, tkw) = _StopTrainer.seen
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tkw == {"result_dir": pathlib.Path(argv[0]), "device": "cpu"}
    for f in ("poses", "intrinsics", "dist_params", "bounds", "images"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f))
    assert tds.n_images == 9          # 12 views less 3 held out; 9 views


def test_train_synthetic_config(monkeypatch, tmp_path):
    """``tools.train_synthetic`` builds the example's config and dataset."""
    spec = importlib.util.spec_from_file_location(
        "jax_example_train_synthetic", ROOT / "examples" / "train_synthetic.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    _StopTrainer.seen = []
    monkeypatch.setattr(example, "Trainer", _StopTrainer)
    monkeypatch.setattr(train_synthetic, "Trainer", _StopTrainer)
    with pytest.raises(_Stop):
        example.main(str(tmp_path / "j"), 40)
    with pytest.raises(_Stop):
        train_synthetic.main([str(tmp_path / "t"), "40", "--device", "cpu"])
    (jcfg, jds, _), (tcfg, tds, tkw) = _StopTrainer.seen
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.poses, jds.poses)
    assert tkw == {"result_dir": tmp_path / "t", "device": "cpu"}


class _StubLocalizer:
    """Records each ``localize`` call and answers the pose it was given
    moved by a fixed step, so both reports print the same numbers."""

    def __init__(self, *a, **kw):
        self.calls = []
        _StubLocalizer.last = self

    def localize(self, pose, image, **kw):
        self.calls.append((np.array(pose), np.array(image), kw))
        search = np.array(pose)
        search[:3, 3] += 0.001
        final = np.array(pose)
        final[:3, 3] *= 0.5
        return {"search_pose": search, "pose": final, "backtracks": 1,
                "lr_final": 1.5e-3, "loss": 0.0}


class _JaxStubTrainer:
    seen: list = []

    def __init__(self, cfg, ds, result_dir=None, **kw):
        type(self).seen.append(ds)
        self.cfg = cfg
        self.params = self.opt_state = self.consts = self.occ_grid = None


def _localize_both(script, port, argv, monkeypatch, tmp_path, capsys):
    """The JAX script and the port's tool on one stub localizer each:
    their reports, the localizers' calls and the training views."""
    run = tmp_path / "run"
    run.mkdir()
    jcfg = JConfig()
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, sampler_mode="dense"))
    jcfg.save(run / "train_config.yaml")
    _JaxStubTrainer.seen = []
    monkeypatch.setattr(jloop, "Trainer", _JaxStubTrainer)
    monkeypatch.setattr(jckpt, "restore", lambda *a, **k: {
        "params": None, "consts": None, "step": 7,
        "extra": {"occ_grid": None}})
    monkeypatch.setattr(jloc, "Localizer", _StubLocalizer)
    capsys.readouterr()
    jrc = _run_script(monkeypatch, script, [str(run), *argv])
    jout = capsys.readouterr().out
    jcalls = _StubLocalizer.last.calls

    seen = {}

    def fake(result_dir, train_ds, intrinsic, hw, device):
        seen.update(result_dir=result_dir, ds=train_ds, intr=intrinsic,
                    hw=hw, device=device)
        return _StubLocalizer(), 7

    monkeypatch.setattr(port, "checkpoint_localizer", fake)
    trc = port.main([str(run), *argv, "--device", "cpu"])
    tout = capsys.readouterr().out
    tcalls = _StubLocalizer.last.calls
    assert trc == jrc
    assert tout == jout
    assert len(tcalls) == len(jcalls) > 0
    for (tp, ti, tk), (jp, ji, jk) in zip(tcalls, jcalls):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ti, ji)
        assert tk == jk
    jds = _JaxStubTrainer.seen[0]
    np.testing.assert_array_equal(seen["ds"].poses, jds.poses)
    np.testing.assert_array_equal(seen["ds"].images, jds.images)
    assert seen["device"] == "cpu" and seen["result_dir"] == run
    return jout


def test_localize_validation_draws(monkeypatch, tmp_path, capsys,
                                   no_jax_cache):
    out = _localize_both(
        "localize_validation", localize_validation,
        ["--scene", "sphere", "--n_images", "10", "--hw", "12",
         "--holdout_every", "3", "--pos_noise", "0.05", "--particles", "9",
         "--diff_iters", "4"], monkeypatch, tmp_path, capsys)
    assert out.count("holdout view") == 4 and out.endswith("FAIL\n")


def test_localize_envelope_draws(monkeypatch, tmp_path, capsys,
                                 no_jax_cache):
    out = _localize_both(
        "localize_envelope", localize_envelope,
        ["--scene", "checker", "--n_images", "9", "--hw", "12",
         "--holdout_every", "4", "--pos_noises", "0.02,0.2",
         "--lrs", "1e-3,3e-2", "--views", "2"], monkeypatch, tmp_path,
        capsys)
    assert len(out.strip().splitlines()) == 2 + 4


def test_inter_poses_bitwise(tmp_path, monkeypatch):
    ds = common.make_scene("sphere", 5, 8)
    jdata.save_dataset(ds, tmp_path / "d")
    jpath, tpath = tmp_path / "j.npy", tmp_path / "t.npy"
    _run_script(monkeypatch, "inter_poses",
                ["--data_dir", str(tmp_path / "d"), "--n_out", "17",
                 "--key_stride", "2", "--out", str(jpath)])
    inter_poses.main(["--data_dir", str(tmp_path / "d"), "--n_out", "17",
                      "--key_stride", "2", "--out", str(tpath)])
    a, b = np.load(tpath), np.load(jpath)
    assert a.shape == (17, 3, 4) and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    keys = np.stack([p for p in ds.poses[::2]])
    np.testing.assert_array_equal(inter_poses.interpolate_poses(keys, 5),
                                  _script("inter_poses").interpolate_poses(
                                      keys, 5))


def test_replay_poses_bitwise(tmp_path):
    jrd = _script("replay_dataset")
    rows = ["timestamp\tx\ty\tz\tqx\tqy\tqz\tqw",
            "0.0\t1\t2\t3\t0.1\t0.2\t0.3\t0.9",
            "1.0\t4\t5\t6\t0\t0\t0.7071068\t0.7071068"]
    (tmp_path / "pose.tsv").write_text("\n".join(rows) + "\n")
    cams = np.random.default_rng(0).normal(size=(3, 27)).astype(np.float32)
    np.save(tmp_path / "cams_meta.npy", cams)
    for source in ("auto", "pose_tsv", "cams_meta"):
        a = replay_dataset.load_poses(tmp_path, source)
        b = jrd.load_poses(tmp_path, source)
        np.testing.assert_array_equal(a, b)
        ta, ia = replay_dataset.apply_test_mode(a, ["x.png", "y.png"])
        tb, ib = jrd.apply_test_mode(b, ["x.png", "y.png"])
        np.testing.assert_array_equal(ta, tb)
        assert ia == ib


@pytest.mark.parametrize("holdout", [0, 3])
def test_make_synthetic_dataset_files(holdout, tmp_path, monkeypatch):
    argv = ["--scene", "textured", "--n_images", "7", "--hw", "10",
            "--holdout", str(holdout)]
    _run_script(monkeypatch, "make_synthetic_dataset",
                [str(tmp_path / "j" / "ds"), *argv])
    make_synthetic_dataset.main([str(tmp_path / "t" / "ds"), *argv])
    jfiles = sorted(p.relative_to(tmp_path / "j")
                    for p in (tmp_path / "j").rglob("*") if p.is_file())
    tfiles = sorted(p.relative_to(tmp_path / "t")
                    for p in (tmp_path / "t").rglob("*") if p.is_file())
    assert tfiles == jfiles
    assert len(jfiles) == (2 + 7 if holdout else 1 + 7)
    for rel in jfiles:
        a, b = tmp_path / "t" / rel, tmp_path / "j" / rel
        if rel.suffix == ".png":
            np.testing.assert_array_equal(read_image(a), read_image(b))
        else:
            assert a.read_text() == b.read_text()


def _images(d: pathlib.Path, n: int, h: int, w: int, seed: int):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        write_image(d / f"{i:04d}.png",
                    rng.random((h, w, 3)).astype(np.float32))


def _decoded(d: pathlib.Path) -> dict:
    return {p.name: read_image(p) for p in sorted(d.glob("*.png"))}


@pytest.mark.parametrize("convention", ["K", "camera_matrix"])
def test_rectify_bitwise(convention, tmp_path, monkeypatch):
    k = [30.0, 0, 12.3, 0, 28.0, 8.1, 0, 0, 1]
    d = [-0.21, 0.05, 1e-3, -2e-3, 0.0]
    info = ({"K": k, "D": d} if convention == "K" else
            {"camera_matrix": {"rows": 3, "cols": 3, "data": k},
             "distortion_coefficients": {"rows": 1, "cols": 5, "data": d},
             "distortion_model": "plumb_bob", "image_width": 24})
    for side in ("j", "t"):
        _images(tmp_path / side / "images_original", 2, 17, 24, seed=1)
        (tmp_path / side / "camera_info.yaml").write_text(
            yaml.safe_dump(info))
    _run_script(monkeypatch, "rectify_images", [str(tmp_path / "j")])
    rectify_images.main([str(tmp_path / "t")])
    a, b = _decoded(tmp_path / "t" / "images"), _decoded(
        tmp_path / "j" / "images")
    assert a.keys() == b.keys() and len(a) == 2
    for name in a:
        np.testing.assert_array_equal(a[name], b[name])
    for x, y in zip(rectify_images.load_camera_info(
            tmp_path / "t" / "camera_info.yaml"),
            _script("rectify_images").load_camera_info(
                tmp_path / "j" / "camera_info.yaml")):
        np.testing.assert_array_equal(x, y)


def test_crop_resize_concat(tmp_path, monkeypatch):
    """Crops bitwise; resizes (the port's torch bilinear against PIL's)
    within one level of 255; the concatenation of both, likewise."""
    for side in ("j", "t"):
        _images(tmp_path / side / "images_original", 3, 20, 14, seed=2)
    _run_script(monkeypatch, "crop_images",
                [str(tmp_path / "j"), "--top", "3", "--bottom", "15"])
    crop_images.main([str(tmp_path / "t"), "--top", "3", "--bottom", "15"])
    a, b = _decoded(tmp_path / "t" / "images"), _decoded(
        tmp_path / "j" / "images")
    assert a.keys() == b.keys() and len(a) == 3
    for name in a:
        assert a[name].shape == (12, 14, 3)
        np.testing.assert_array_equal(a[name], b[name])
    _run_script(monkeypatch, "resize_images",
                [str(tmp_path / "j" / "images_original"),
                 str(tmp_path / "j" / "small"), "--resize_factor", "2"])
    resize_images.main([str(tmp_path / "t" / "images_original"),
                        str(tmp_path / "t" / "small"), "--resize_factor",
                        "2"])
    for side in ("j", "t"):
        (tmp_path / side / "plots" / "a").mkdir(parents=True)
        (tmp_path / side / "plots" / "b").mkdir()
        for i, sub in enumerate("ab"):
            write_image(tmp_path / side / "plots" / sub /
                        "plot_result_last.png",
                        np.full((5, 6, 3), 0.2 * (i + 1), np.float32))
    _run_script(monkeypatch, "concat_inference_images",
                [str(tmp_path / "j" / "plots"), str(tmp_path / "j" / "small"),
                 str(tmp_path / "j" / "cat")])
    concat_inference_images.main(
        [str(tmp_path / "t" / "plots"), str(tmp_path / "t" / "small"),
         str(tmp_path / "t" / "cat")])
    for sub, shape in (("small", (10, 7, 3)), ("cat", (10, 19, 3))):
        a, b = _decoded(tmp_path / "t" / sub), _decoded(
            tmp_path / "j" / sub)
        assert a.keys() == b.keys() and len(a) == (3 if sub == "small"
                                                   else 2)
        for name in a:
            assert a[name].shape == b[name].shape == shape
            assert np.abs(a[name] - b[name]).max() <= 1.0 / 255 + 1e-6


def test_eval_matches_the_script(tmp_path, monkeypatch):
    _images(tmp_path / "gt", 3, 16, 20, seed=3)
    rng = np.random.default_rng(4)
    (tmp_path / "pred").mkdir()
    for p in sorted((tmp_path / "gt").glob("*.png")):
        x = read_image(p)
        write_image(tmp_path / "pred" / p.name,
                    np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1))
    weights = tmp_path / "lpips.pt"
    jlp.make_random_weights(weights, seed=0)
    common_argv = ["--gt_dir", str(tmp_path / "gt"), "--pred_dir",
                   str(tmp_path / "pred"), "--lpips_weights", str(weights)]
    _run_script(monkeypatch, "eval",
                [*common_argv, "--out", str(tmp_path / "j.json")])
    teval.main([*common_argv, "--out", str(tmp_path / "t.json"),
                "--device", "cpu"])
    a = json.loads((tmp_path / "t.json").read_text())
    b = json.loads((tmp_path / "j.json").read_text())
    assert a.keys() == b.keys() and a["n_images"] == b["n_images"] == 3
    for key, tol in (("psnr", 1e-9), ("ssim", 1e-9)):
        np.testing.assert_allclose(a[key], b[key], rtol=0, atol=tol)
    np.testing.assert_allclose(a["lpips_vgg"], b["lpips_vgg"], rtol=1e-6)
    assert a["lpips_vgg"] > 0
    # without weights the column is null, as in the script
    teval.main(common_argv[:4] + ["--out", str(tmp_path / "n.json"),
                                  "--device", "cpu"])
    assert json.loads((tmp_path / "n.json").read_text())["lpips_vgg"] is None


# -- a run of both: quality_run, then eval_holdout -------------------------

RUN_ARGV = ["--scene", "sphere", "--n_images", "6", "--hw", "16",
            "--holdout", "3", "--steps", "4", "--rays", "16"]
# the quality preset's model cut to tiny_cfg's: JAX compiles the
# 1024-sample step and render for minutes on the CPU
SMALL_MODEL = dict(n_levels=2, n_channels=2, log2_table_size=10,
                   n_samples=32, sample_l=1.0 / 8.0, bf16_features=False,
                   sampler_mode="dense", encode_chunk=65536)


def _small_quality(config_cls):
    full = config_cls.quality

    def quality(end_iter=20000):
        cfg = full(end_iter)
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, **SMALL_MODEL))
    return staticmethod(quality)


class _JaxTrainer(jloop.Trainer):
    """The JAX trainer on one device (the tests' CPU mesh has 8), its
    initial params kept for the port."""
    last = None

    def __init__(self, *a, **kw):
        super().__init__(*a, use_mesh=False, **kw)
        self.init_tree = jax.tree.map(np.asarray, self.params)
        _JaxTrainer.last = self


def _summary(path: pathlib.Path) -> list[list[str]]:
    return [line.split("\t") for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """``quality_run`` of the script and of the port on the same flags
    and ``SMALL_MODEL``, the port given the JAX trainer's init, batches and
    draws; then ``eval_holdout`` of each on the held-out views."""
    tmp = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        mp.setattr(JConfig, "quality", _small_quality(JConfig))
        mp.setattr(TConfig, "quality", _small_quality(TConfig))
        mp.setattr(jloop, "Trainer", _JaxTrainer)
        mp.setattr(sys, "argv", ["quality_run", str(tmp / "j"), *RUN_ARGV])
        assert _script("quality_run").main() == 0
        jtr = _JaxTrainer.last
        mp.setattr(quality_run, "Trainer", functools.partial(
            tloop.Trainer, params=jtr.init_tree,
            noise_fn=lambda step, n: jax_noise(jtr.cfg, step, n)))
        assert quality_run.main([str(tmp / "t"), *RUN_ARGV,
                                 "--device", "cpu"]) == 0
        make_synthetic_dataset.main([str(tmp / "ds"), "--scene", "sphere",
                                     "--n_images", "6", "--hw", "16",
                                     "--holdout", "3"])
        mp.setattr(sys, "argv", ["eval_holdout", str(tmp / "j"),
                                 str(tmp / "ds_holdout")])
        assert _script("eval_holdout").main() == 0
        assert eval_holdout.main([str(tmp / "t"), str(tmp / "ds_holdout"),
                                  "--device", "cpu", "--save_images"]) == 0
    finally:
        mp.undo()
    return tmp


def test_quality_run_summary_matches(both_runs):
    a = _summary(both_runs / "t" / "summary.tsv")
    b = _summary(both_runs / "j" / "summary.tsv")
    assert a[0] == b[0] == ["image_idx", "score", "psnr", "ssim", "lpips",
                            "time_s", "split"]
    assert [(r[0], r[6]) for r in a[1:]] == [(r[0], r[6]) for r in b[1:]]
    assert [r[6] for r in a[1:]] == ["holdout", "train", "train", "holdout",
                                     "train", "train"]
    for ra, rb in zip(a[1:], b[1:]):
        np.testing.assert_allclose(float(ra[1]), float(rb[1]), rtol=1e-3)
        np.testing.assert_allclose(float(ra[2]), float(rb[2]), atol=1e-3)
        np.testing.assert_allclose(float(ra[3]), float(rb[3]), atol=1e-4)
        assert ra[4] == rb[4] == "nan"
    assert (both_runs / "t" / "checkpoints" / "step_00000004").is_dir()


def test_eval_holdout_matches(both_runs):
    a = _summary(both_runs / "t" / "holdout_summary.tsv")
    b = _summary(both_runs / "j" / "holdout_summary.tsv")
    assert a[0] == b[0] == ["image_idx", "psnr", "ssim", "time_s"]
    assert len(a) == len(b) == 3
    for ra, rb in zip(a[1:], b[1:]):
        assert ra[0] == rb[0]
        np.testing.assert_allclose(float(ra[1]), float(rb[1]), atol=1e-3)
        np.testing.assert_allclose(float(ra[2]), float(rb[2]), atol=1e-4)
    strip = read_image(both_runs / "t" / "holdout_00.png")
    assert strip.shape == (16, 32, 3)


def test_checkpoint_localizer(both_runs):
    """The localizer of ``localize_validation`` over the port's run: the
    checkpoint's step, its params, and the view's render at 16x16."""
    ds = common.make_scene("sphere", 6, 16)
    held, keep = common.holdout_split(6, 3)
    assert held == [0, 3] and keep == [1, 2, 4, 5]
    loc, step = common.checkpoint_localizer(both_runs / "t",
                                            common.subset(ds, keep),
                                            ds.intrinsics[0], 16, "cpu")
    assert step == 4 and loc.infer_height == loc.infer_width == 16
    rgb = loc.render_image(ds.poses[0]).numpy()
    assert rgb.shape == (16, 16, 3) and np.isfinite(rgb).all()
    assert (both_runs / "t" / "diag_tmp" / "train_config.yaml").is_file()


# -- the held-out diagnostics on both runs --------------------------------

DIAG_ARGV = ["--scene", "sphere", "--n_images", "6", "--hw", "16",
             "--holdout_every", "3"]
NUMBER = r"-?\d+\.\d+"


@pytest.fixture
def jax_run_patches(monkeypatch):
    """``both_runs``' patches, again while a JAX script runs on its run:
    the one-device trainer, the small quality preset, JAX's config left
    alone."""
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(JConfig, "quality", _small_quality(JConfig))
    monkeypatch.setattr(jloop, "Trainer", _JaxTrainer)


def _record(monkeypatch, owner, name: str, store: list, keep=None):
    """Wrap ``owner.name`` so that each call's result (when ``keep(result,
    *args)`` holds) is appended to ``store`` as a numpy array."""
    real = getattr(owner, name)

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        if keep is None or keep(out, *a):
            store.append(np.asarray(out))
        return out
    monkeypatch.setattr(owner, name, wrapped)


def _shape(lines: list[str]) -> list[str]:
    """The printed lines with their numbers blanked."""
    return [re.sub(NUMBER, "#", line) for line in lines]


def test_diag_holdout_matches_the_script(both_runs, monkeypatch, capsys,
                                         jax_run_patches):
    """Each of the four renders: PSNR within 1e-3 dB and depth
    percentiles within 1e-4 (the VALIDATE render's tolerance after 4
    steps of both trainers, ``test_eval_holdout_matches``); the same
    printed lines and PNGs."""
    psnrs = {"j": [], "t": []}
    pcts = {"j": [], "t": []}

    def pct_keep(out, a, q=None):
        return np.ndim(q) == 1 and list(q) == [10, 50, 90]

    argv = [*DIAG_ARGV, "--holdout_view", "3", "--train_view", "1"]
    with monkeypatch.context() as mp:
        _record(mp, jmetrics, "psnr", psnrs["j"])
        _record(mp, np, "percentile", pcts["j"], pct_keep)
        capsys.readouterr()
        assert _run_script(mp, "diag_holdout",
                           [str(both_runs / "j"), *argv]) == 0
        jout = capsys.readouterr().out.splitlines()
    with monkeypatch.context() as mp:
        _record(mp, diag_holdout, "psnr", psnrs["t"])
        _record(mp, np, "percentile", pcts["t"], pct_keep)
        assert diag_holdout.main([str(both_runs / "t"), *argv,
                                  "--device", "cpu"]) == 0
        tout = capsys.readouterr().out.splitlines()
    assert _shape(tout) == _shape(jout)
    assert [line.split(":")[0] for line in tout[1:]] == [
        "view 1 train", "view 3 holdout", "view 3 holdout_fixdir",
        "view 1 train_fixdir"]
    assert len(psnrs["t"]) == len(psnrs["j"]) == 4
    np.testing.assert_allclose(psnrs["t"], psnrs["j"], rtol=0, atol=1e-3)
    assert len(pcts["t"]) == len(pcts["j"]) == 4
    np.testing.assert_allclose(pcts["t"], pcts["j"], rtol=0, atol=1e-4)
    # the frozen direction moves the colors, not the geometry
    np.testing.assert_array_equal(pcts["t"][1], pcts["t"][2])
    names = sorted(p.name for p in (both_runs / "j").glob("diag_*.png"))
    assert len(names) == 8
    assert sorted(p.name for p in (both_runs / "t").glob("diag_*.png")) \
        == names
    for n in names:
        assert read_image(both_runs / "t" / n).shape == \
            read_image(both_runs / "j" / n).shape == (16, 16, 3)


def test_eval_appearance_ab_matches_the_script(both_runs, monkeypatch,
                                               capsys, jax_run_patches):
    """The ``app_emb`` norms within 1e-5; every view of every arm (the
    mean, own and no embedding, at supersample 1 and 2): PSNR within
    1e-3 dB, SSIM within 1e-4 (``test_quality_run_summary_matches``'
    tolerances). The script renders in chunks of 16384 rays, each padded
    to that size; JAX's renders here take chunks of 256, the rays of one
    view (a VALIDATE render's rays are independent), which saves the CPU
    63 padded chunks a view."""
    got = {side: {"psnr": [], "ssim": [], "norm": []} for side in "jt"}
    real_render = jrenderer.render_image

    def emb_rows(out, x, *a):
        return not isinstance(out, jax.core.Tracer) and x.shape[-1] == 16

    argv = [*DIAG_ARGV, "--embs", "none,mean,own"]
    with monkeypatch.context() as mp:
        for metric in ("psnr", "ssim"):
            _record(mp, jmetrics, metric, got["j"][metric])
        _record(mp, jnp.linalg, "norm", got["j"]["norm"], emb_rows)
        mp.setattr(jrenderer, "render_image", lambda *a, **kw: real_render(
            *a, **{**kw, "chunk": 256}))
        capsys.readouterr()
        assert _run_script(mp, "eval_appearance_ab",
                           [str(both_runs / "j"), *argv]) == 0
        jout = capsys.readouterr().out.splitlines()
    with monkeypatch.context() as mp:
        for metric in ("psnr", "ssim"):
            _record(mp, eval_appearance_ab, metric, got["t"][metric])
        _record(mp, torch.linalg, "vector_norm", got["t"]["norm"], emb_rows)
        assert eval_appearance_ab.main([str(both_runs / "t"), *argv,
                                        "--device", "cpu"]) == 0
        tout = capsys.readouterr().out.splitlines()
    assert _shape(tout) == _shape(jout) and len(tout) == 3 + 6
    assert [line.split()[:2] for line in tout[3:]] == [
        [f"emb={e}", f"ss={s}"] for s in (1, 2)
        for e in ("none", "mean", "own")]
    norms = {side: (float(got[side]["norm"][0]),
                    float(np.mean(got[side]["norm"][1])))
             for side in "jt"}
    assert [n.shape for n in got["t"]["norm"]] == [(), (4,)]
    np.testing.assert_allclose(norms["t"], norms["j"], rtol=0, atol=1e-5)
    for metric, tol in (("psnr", 1e-3), ("ssim", 1e-4)):
        assert len(got["t"][metric]) == len(got["j"][metric]) == 6 * 6
        np.testing.assert_allclose(got["t"][metric], got["j"][metric],
                                   rtol=0, atol=tol)


def test_bench_scaling_summary_matches_the_script(monkeypatch, capsys):
    """With the bench functions stubbed to given rates, the port prints
    the script's lines: at one count through ``main``, at three through
    :func:`bench_scaling.summary`."""
    rates = {1: 1000.0, 2: 1900.4, 4: 3456.78}
    script = _script("bench_scaling")
    monkeypatch.setattr(script, "bench_devices",
                        lambda n, cfg, iters: rates[n])
    monkeypatch.setattr(bench_scaling, "bench_devices",
                        lambda mesh, cfg, iters: rates[mesh.size])
    capsys.readouterr()
    want = {}
    for counts in ("1", "1,2,4"):
        monkeypatch.setattr(sys, "argv", ["bench_scaling", "--quick",
                                          "--counts", counts])
        script.main()
        want[counts] = capsys.readouterr().out.splitlines()
    bench_scaling.main(["--quick", "--counts", "1", "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want["1"]
    assert len(want["1,2,4"]) == 4
    assert json.dumps(bench_scaling.summary(rates)) == want["1,2,4"][-1]


def test_bench_scaling_gloo_ranks(capsys):
    """Two gloo ranks of the tool on the CPU: a line per count of the
    default sweep (1, 2) from rank 0, then the summary."""
    capsys.readouterr()
    bench_scaling.main(["--multiprocess", "2", "--quick", "--iters", "1",
                        "--rays", "256"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x.get("devices") for x in lines] == [1, 2, None]
    assert all(x["rays_per_s"] > 0 for x in lines[:2])
    assert lines[2]["metric"] == "scaling_efficiency"
    assert set(lines[2]["per_devices"]) == {"1", "2"}
    assert lines[2]["per_devices"]["1"] == 1.0 and lines[2]["value"] > 0


# -- the families without jax, PIL or yaml --------------------------------

_BLOCKED = r"""
import importlib.abc, json, runpy, sys, threading
BLOCKED = ("yaml", "PIL", "jax", "f2nerf_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

for m in list(sys.modules):
    if m.split(".")[0] in BLOCKED:
        del sys.modules[m]
sys.meta_path.insert(0, Block())
sys.path.insert(0, ROOT)
work = sys.argv[1]
rcs = {}

def tool(name, *argv):
    sys.argv = [name, *[a.replace("@", work) for a in argv]]
    try:
        runpy.run_module("f2nerf_tpu_torch.tools." + name,
                         run_name="__main__")
        rcs[name] = 0
    except SystemExit as e:
        rcs[name] = e.code or 0

STEPS

print(json.dumps({"rcs": rcs, "loaded": sorted(
    m for m in sys.modules if m.split(".")[0] in BLOCKED)}))
"""

FAMILIES = {
    "data": r"""
tool("make_synthetic_dataset", "@/ds", "--scene", "checker", "--n_images",
     "5", "--hw", "12", "--holdout", "2")
tool("inter_poses", "--data_dir", "@/ds", "--n_out", "6")
import numpy as np
from f2nerf_tpu_torch.utils.image_io import write_image
import os
os.makedirs(work + "/raw/images_original")
for i in range(2):
    write_image(f"{work}/raw/images_original/{i}.png",
                np.full((20, 16, 3), 0.1 * i, np.float32))
with open(work + "/raw/camera_info.yaml", "w") as f:
    f.write("D:\n- -0.1\n- 0.01\n- 0.0\n- 0.0\n- 0.0\n"
            "K:\n- 20.0\n- 0.0\n- 8.0\n- 0.0\n- 20.0\n- 10.0\n- 0.0\n"
            "- 0.0\n- 1.0\n")
tool("rectify_images", "@/raw")
tool("crop_images", "@/raw", "--bottom", "12")
tool("resize_images", "@/raw/images", "@/small")
tool("concat_inference_images", "@/ds", "@/small", "@/cat", "--glob1",
     "images/*.png")
""",
    "map": r"""
tool("make_synthetic_dataset", "@/ds", "--scene", "sphere", "--n_images",
     "6", "--hw", "12", "--holdout", "3")
flags = ["--scene", "sphere", "--n_images", "6", "--hw", "12"]
tool("quality_run", "@/run", *flags, "--holdout", "3", "--steps", "2",
     "--rays", "16", "--sampler", "dense", "--n_levels", "2",
     "--log2_table_size", "10", "--n_channels", "2", "--device", "cpu")
tool("eval_holdout", "@/run", "@/ds_holdout", "--device", "cpu")
tool("diag_holdout", "@/run", *flags, "--holdout_every", "3",
     "--holdout_view", "3", "--train_view", "1", "--device", "cpu")
tool("eval_appearance_ab", "@/run", *flags, "--holdout_every", "3",
     "--supersamples", "1", "--embs", "none,own", "--device", "cpu")
tool("bench_scaling", "--quick", "--iters", "1", "--rays", "64",
     "--device", "cpu")
from f2nerf_tpu_torch.utils import lpips
lpips.make_random_weights(work + "/lpips.pt")
import os
import numpy as np
from f2nerf_tpu_torch.utils.image_io import write_image
rng = np.random.default_rng(0)
for d in ("gt", "pred"):
    os.makedirs(f"{work}/{d}")
    for i in range(2):      # LPIPS's VGG pools need 32 x 32 or more
        write_image(f"{work}/{d}/{i}.png",
                    rng.random((32, 32, 3)).astype(np.float32))
tool("eval", "--gt_dir", "@/gt", "--pred_dir", "@/pred", "--lpips_weights",
     "@/lpips.pt", "--device", "cpu")
tool("localize_validation", "@/run", *flags, "--holdout_every", "3",
     "--particles", "4", "--search_rounds", "1", "--diff_iters", "1",
     "--device", "cpu")
tool("localize_envelope", "@/run", *flags, "--holdout_every", "3",
     "--pos_noises", "0.02", "--lrs", "1e-3", "--views", "1",
     "--particles", "4", "--search_rounds", "1", "--diff_iters", "1",
     "--device", "cpu")
tool("bench_localize", "--resize", "128", "--particles", "2", "--device",
     "cpu")
# the JAX system's two entry points: bench.py's CLI, __graft_entry__'s dry
# run on one rank (its tiny arms: the flagship is Config()'s full table)
sys.argv = ["bench", "--quick", "--iters", "2", "--device", "cpu"]
runpy.run_module("f2nerf_tpu_torch.bench", run_name="__main__")
rcs["bench"] = 0
from f2nerf_tpu_torch import graft_entry
graft_entry.dryrun_multichip(1, device="cpu",
                             arms=("dense", "occ", "localize"))
rcs["graft_entry"] = 0
# the example's model cut to two levels (its own config is held against
# the JAX example in test_train_synthetic_config): main, not runpy, so
# that the cut applies
import dataclasses
from f2nerf_tpu_torch.tools import train_synthetic
full = train_synthetic.example_config
train_synthetic.example_config = lambda steps: dataclasses.replace(
    full(steps), model=dataclasses.replace(
        full(steps).model, n_levels=2, log2_table_size=10,
        occ_grid_res=16, occ_segments=16))
train_synthetic.main([work + "/example", "2", "--device", "cpu"])
from f2nerf_tpu_torch.apps import serve
from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
srv = serve.serve(Localizer.from_checkpoint(
    work + "/run", LocalizerParam(resize_factor=4), device="cpu"))
threading.Thread(target=srv.serve_forever, daemon=True).start()
import numpy as np
from f2nerf_tpu_torch.data.dataset import load_dataset
ds = load_dataset(work + "/ds_holdout")
cams = np.zeros((ds.n_images, 27), np.float32)
cams[:, :12] = ds.poses.reshape(ds.n_images, 12)
np.save(work + "/ds_holdout/cams_meta.npy", cams)
tool("replay_dataset", "@/ds_holdout", "--port",
     str(srv.server_address[1]), "--particle_num", "4")
srv.shutdown()
""",
}

FAMILY_FILES = {
    "data": ["ds/cams_meta.tsv", "ds_holdout/cams_meta.tsv",
             "ds/poses_render.npy", "raw/images/0.png", "small/1.png",
             "cat/1.png"],
    "map": ["run/summary.tsv", "run/holdout_summary.tsv", "pred/info.json",
            "run/diag_holdout_fixdir_3_depth.png", "run/diag_train_1.png",
            "run/diag_tmp/train_config.yaml", "example/train_log.txt",
            "ds_holdout/replay_log.tsv"],
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tools_without_jax_pil_or_yaml(family, tmp_path):
    code = _BLOCKED.replace("ROOT", repr(str(ROOT)), 1).replace(
        "STEPS", FAMILIES[family])
    # two threads: the tests' other workers share the cores
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, timeout=600,
                         cwd=tmp_path,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    # localize_validation exits 1 when the error did not fall: 2 steps
    # of training make no map
    rcs = {k: v for k, v in res["rcs"].items() if k != "localize_validation"}
    assert set(rcs.values()) == {0}, res["rcs"]
    for rel in FAMILY_FILES[family]:
        assert (tmp_path / rel).is_file(), rel
    if family == "map":
        info = json.loads((tmp_path / "pred" / "info.json").read_text())
        assert info["n_images"] == 2 and info["lpips_vgg"] > 0
        log = (tmp_path / "ds_holdout" / "replay_log.tsv").read_text()
        assert len(log.splitlines()) == 3
