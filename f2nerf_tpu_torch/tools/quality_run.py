"""Resumable long-horizon quality run on a synthetic scene (port of
``scripts/quality_run.py``).

    python -m f2nerf_tpu_torch.tools.quality_run RESULT_DIR \\
        [--scene checker] [--steps 8000] [--holdout 8] [--device cpu] ...

Each invocation resumes from the newest checkpoint, trains in tranches
of 50 steps until the step target (``--stop_at``, else ``--steps``) or
the wall budget (``--budget_s``), checkpoints every ``--slice_steps``
and at the end, and exits 1 while work remains; re-run until it reaches
the target. Then it renders every view and writes ``summary.tsv``
(``image_idx score psnr ssim lpips time_s split``; score = H*W*3 / sum
of squared errors, like the reference test driver). ``--holdout k``
withholds every k-th view from training and scores it separately.

The operating point is ``Config.quality(steps)`` with the flags applied
by ``dataclasses.replace``, as in the JAX script. The LPIPS column is
filled when real LPIPS(vgg) weights are present (``utils/lpips.py``),
else NaN.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import signal
import time

import numpy as np
import torch

from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.models import renderer
from f2nerf_tpu_torch.tools.common import (SCENES, add_device_flag,
                                           holdout_split, make_scene, subset)
from f2nerf_tpu_torch.tools.eval import to_lpips_input
from f2nerf_tpu_torch.train.loop import Trainer
from f2nerf_tpu_torch.utils import lpips as lpips_lib
from f2nerf_tpu_torch.utils.metrics import psnr, ssim

# TrainConfig fields that a flag of the same name overrides
TRAIN_FLAGS = ("var_loss_weight", "var_loss_mode", "var_loss_start",
               "var_loss_end", "grad_clip_norm", "feat_pool_weight_decay",
               "explore_sparsity_weight", "global_sparsity_weight",
               "level_anneal_end", "occ_reg_weight", "occ_reg_t")
# (flag, ModelConfig field)
MODEL_FLAGS = (("sampler", "sampler_mode"), ("n_levels", "n_levels"),
               ("log2_table_size", "log2_table_size"),
               ("n_channels", "n_channels"), ("warp_mode", "warp_mode"),
               ("warp_blend_k", "warp_blend_k"),
               ("occ_thresh", "occ_thresh"), ("occ_decay", "occ_decay"),
               ("occ_trans_eps", "occ_trans_eps"),
               ("sample_near", "sample_near"),
               ("occ_explore_slots", "occ_explore_slots"))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("result_dir", type=pathlib.Path)
    ap.add_argument("--scene", choices=SCENES, default="checker")
    ap.add_argument("--n_images", type=int, default=16)
    ap.add_argument("--hw", type=int, default=128)
    ap.add_argument("--steps", type=int, default=8000)
    ap.add_argument("--stop_at", type=int, default=None,
                    help="train only to this step but keep --steps as "
                         "the schedule length (LR cosine / var-loss ramp)")
    ap.add_argument("--rays", type=int, default=None,
                    help="override; default from Config.quality()")
    ap.add_argument("--lr", type=float, default=None,
                    help="override; default from Config.quality()")
    ap.add_argument("--holdout", type=int, default=0,
                    help="withhold every k-th view from training and "
                         "score it separately (0 = train on all views)")
    ap.add_argument("--sampler", default=None, choices=("occ", "dense"),
                    help="override ModelConfig.sampler_mode")
    ap.add_argument("--n_levels", type=int, default=None)
    ap.add_argument("--log2_table_size", type=int, default=None)
    ap.add_argument("--n_channels", type=int, default=None)
    ap.add_argument("--warp_mode", default=None,
                    choices=("contract", "perspective"))
    ap.add_argument("--warp_blend_k", type=int, default=None,
                    help="smooth chart blending: k nearest anchors "
                         "(1 = hard regions; models/warp.py)")
    ap.add_argument("--occ_thresh", type=float, default=None)
    ap.add_argument("--occ_decay", type=float, default=None)
    ap.add_argument("--occ_explore_targeted", type=int, default=None,
                    help="1/0: stratify explore slots over the "
                         "ineligible set only (models/occupancy.py)")
    ap.add_argument("--occ_trans_eps", type=float, default=None)
    ap.add_argument("--sample_near", type=float, default=None,
                    help="march start offset (ModelConfig.sample_near)")
    ap.add_argument("--occ_explore_slots", type=int, default=None)
    ap.add_argument("--var_loss_weight", type=float, default=None,
                    help="override; default keeps the reference value")
    ap.add_argument("--var_loss_mode", default=None,
                    choices=("weight_var", "distortion"))
    ap.add_argument("--var_loss_start", type=int, default=None,
                    help="ramp start step (0 with --var_loss_end 1 = "
                         "constant weight from step 0)")
    ap.add_argument("--var_loss_end", type=int, default=None)
    ap.add_argument("--grad_clip_norm", type=float, default=None)
    ap.add_argument("--feat_pool_weight_decay", type=float, default=None)
    ap.add_argument("--explore_sparsity_weight", type=float, default=None)
    ap.add_argument("--global_sparsity_weight", type=float, default=None)
    ap.add_argument("--occ_reg_weight", type=float, default=None,
                    help="occlusion regularizer weight "
                         "(TrainConfig.occ_reg_weight)")
    ap.add_argument("--occ_reg_t", type=float, default=None,
                    help="penalize density at t < this march distance")
    ap.add_argument("--train_app_emb", type=int, default=None,
                    help="1/0: per-image appearance embedding in TRAIN "
                         "renders (TrainConfig.train_app_emb)")
    ap.add_argument("--level_anneal_end", type=int, default=None,
                    help="coarse-to-fine: unmask hash levels over the "
                         "first N steps (TrainConfig.level_anneal_end)")
    ap.add_argument("--eval_emb", default="none", choices=("none", "mean"),
                    help="appearance for the summary renders: 'mean' adds "
                         "the mean trained per-image embedding")
    ap.add_argument("--supersample", type=int, default=1,
                    help="render summary views at k x resolution and "
                         "box-average down (exact area supersampling)")
    ap.add_argument("--budget_s", type=float, default=540.0,
                    help="wall budget for this invocation's training")
    ap.add_argument("--slice_steps", type=int, default=500,
                    help="steps between budget checks/checkpoints")
    add_device_flag(ap)
    return ap


def build_config(args: argparse.Namespace) -> Config:
    """``Config.quality(args.steps)`` with the flags' overrides."""
    cfg = Config.quality(args.steps)
    tkw = dict(report_freq=250, vis_freq=max(args.steps // 4, 1),
               save_freq=10 ** 9)
    if args.rays is not None:
        tkw["pts_batch_size"] = args.rays * 512
    if args.lr is not None:
        tkw["learning_rate"] = args.lr
    for name in TRAIN_FLAGS:
        if getattr(args, name) is not None:
            tkw[name] = getattr(args, name)
    if args.train_app_emb is not None:
        tkw["train_app_emb"] = bool(args.train_app_emb)
    mkw = {dst: getattr(args, src) for src, dst in MODEL_FLAGS
           if getattr(args, src) is not None}
    if args.occ_explore_targeted is not None:
        mkw["occ_explore_targeted"] = bool(args.occ_explore_targeted)
    return Config(train=dataclasses.replace(cfg.train, **tkw),
                  model=dataclasses.replace(cfg.model, **mkw))


def lpips_or_none(device):
    """A (pred, gt) -> LPIPS function when real weights are present
    (``utils/lpips.default_weights_path``), else None."""
    try:
        net = (lpips_lib.load(device=device)
               if lpips_lib.default_weights_path() is not None else None)
    except Exception:  # noqa: BLE001 — the column is optional
        net = None
    if net is None:
        return None
    return lambda a, b: net(to_lpips_input(a), to_lpips_input(b))


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    ds = make_scene(args.scene, args.n_images, args.hw)
    held, train_ds = [], ds
    if args.holdout > 0:
        held, keep = holdout_split(ds.n_images, args.holdout)
        train_ds = subset(ds, keep)
        print(f"holding out views {held} ({len(keep)} train views)")

    cfg = build_config(args)
    tr = Trainer(cfg, train_ds, result_dir=args.result_dir,
                 device=args.device)
    try:
        return _run(args, ds, held, tr)
    finally:
        tr.close()


def _run(args, ds, held: list[int], tr: Trainer) -> int:
    if tr.try_resume():
        print(f"resumed at step {tr.step}")

    # SIGTERM (what `timeout` sends first): finish the current 50-step
    # tranche, checkpoint and exit
    got_term = {"v": False}
    old_handler = signal.signal(signal.SIGTERM,
                                lambda *_: got_term.update(v=True))
    try:
        stop = min(args.stop_at or args.steps, args.steps)
        t0 = time.monotonic()
        last_ckpt = tr.step
        while (tr.step < stop and not got_term["v"]
               and time.monotonic() - t0 < args.budget_s):
            tr.run(min(50, stop - tr.step))
            if tr.step - last_ckpt >= args.slice_steps or got_term["v"]:
                tr.save_checkpoint()
                last_ckpt = tr.step
                print(f"checkpointed at step {tr.step} "
                      f"({time.monotonic() - t0:.0f}s elapsed)", flush=True)
        if tr.step > last_ckpt:
            tr.save_checkpoint()
            print(f"checkpointed at step {tr.step} "
                  f"({time.monotonic() - t0:.0f}s elapsed)", flush=True)
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    if got_term["v"]:
        print(f"SIGTERM: checkpointed at step {tr.step}, exiting")
        return 1
    if tr.step < stop:
        print(f"budget reached at step {tr.step}/{stop}; re-run "
              "to continue")
        return 1

    # the summary render needs room: with the budget nearly spent it is
    # left to the next invocation, which resumes at the target and renders
    summary_s = 150.0 + 3.0 * ds.n_images
    if time.monotonic() - t0 > args.budget_s - summary_s:
        print(f"training done at step {tr.step}; deferring summary "
              f"render to a fresh window (needs ~{summary_s:.0f}s)")
        return 1

    # field health: the occupied share and the mean-sigma EMA
    ob = tr.occ_bits()
    if ob is not None:
        b = ob.cpu().numpy()
        occ = b[0] > 0
        q50, q90 = np.percentile(b[1][occ], [50, 90])
        print(f"occ diag: occupied {occ.mean():.3f} "
              f"mean-sigma p50 {q50:.2f} p90 {q90:.2f}")

    eval_emb = None
    if args.eval_emb == "mean":
        eval_emb = torch.mean(tr.params["app_emb"].detach(), dim=0)
    lpips_model = lpips_or_none(tr.device)
    rows = []
    for i in range(ds.n_images):
        ts = time.monotonic()
        rgb, _ = renderer.render_image(
            tr.params, torch.as_tensor(ds.poses[i], device=tr.device),
            torch.as_tensor(ds.intrinsics[i], device=tr.device),
            ds.height, ds.width, tr.cfg.model, chunk=16384,
            occ_vals=tr.occ_bits(), eval_emb=eval_emb,
            supersample=args.supersample, consts=tr.consts)
        rgb = rgb.cpu().numpy()
        dt = time.monotonic() - ts
        mse = float(((rgb - ds.images[i]) ** 2).sum())
        score = rgb.size / max(mse, 1e-12)
        tag = "holdout" if i in held else "train"
        lp = (lpips_model(rgb, ds.images[i])
              if lpips_model is not None else float("nan"))
        rows.append((i, score, psnr(rgb, ds.images[i]),
                     ssim(rgb, ds.images[i]), lp, dt, tag))
        print(f"view {i:02d} [{tag}] score={score:.2f} "
              f"psnr={rows[-1][2]:.2f} ssim={rows[-1][3]:.3f} "
              f"lpips={lp:.3f} {dt * 1e3:.0f} ms", flush=True)

    out = args.result_dir / "summary.tsv"
    with open(out, "w") as f:
        f.write("image_idx\tscore\tpsnr\tssim\tlpips\ttime_s\tsplit\n")
        for r in rows:
            f.write(f"{r[0]}\t{r[1]:.4f}\t{r[2]:.4f}\t{r[3]:.4f}"
                    f"\t{r[4]:.4f}\t{r[5]:.4f}\t{r[6]}\n")
    for tag in ("train", "holdout"):
        ps = [r[2] for r in rows if r[6] == tag]
        ss = [r[3] for r in rows if r[6] == tag]
        if ps:
            print(f"done: mean {tag} render PSNR {np.mean(ps):.2f} dB "
                  f"(min {np.min(ps):.2f}, max {np.max(ps):.2f}) "
                  f"SSIM {np.mean(ss):.3f} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
