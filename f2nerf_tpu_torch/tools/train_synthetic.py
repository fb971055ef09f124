"""Example: train the synthetic sphere scene with the occupancy sampler,
render view 0, report its PSNR, and resume from the run's checkpoint on
a second call (port of ``examples/train_synthetic.py``).

    python -m f2nerf_tpu_torch.tools.train_synthetic [RESULT_DIR [STEPS]] \\
        [--device cpu]

RESULT_DIR defaults to ``f2nerf_example`` under the temporary directory
(``$TMPDIR``), STEPS to 600.
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile

from f2nerf_tpu_torch.core.config import Config, ModelConfig, TrainConfig
from f2nerf_tpu_torch.data.synthetic import make_sphere_dataset
from f2nerf_tpu_torch.models import renderer
from f2nerf_tpu_torch.tools.common import add_device_flag
from f2nerf_tpu_torch.train.loop import Trainer
from f2nerf_tpu_torch.utils.metrics import psnr


def example_config(steps: int) -> Config:
    return Config(
        model=ModelConfig(n_levels=8, log2_table_size=16,
                          sampler_mode="occ", occ_warmup_steps=128),
        train=TrainConfig(end_iter=steps, report_freq=100,
                          vis_freq=max(steps // 2, 1), save_freq=steps,
                          learning_rate_warm_up_end_iter=50,
                          var_loss_start=150, var_loss_end=300))


def train(result_dir: str | pathlib.Path, steps: int = 600,
          device=None) -> float:
    ds = make_sphere_dataset(n_images=10, h=64, w=64)
    cfg = example_config(steps)
    tr = Trainer(cfg, ds, result_dir=pathlib.Path(result_dir), device=device)
    try:
        if tr.try_resume():
            print(f"resumed from step {tr.step}")
        tr.run()
        tr.save_checkpoint()
        rgb, _ = renderer.render_image(
            tr.params, tr.poses[0], tr.intrinsics[0], ds.height, ds.width,
            tr.cfg.model, chunk=4096, occ_vals=tr.occ_bits(),
            consts=tr.consts)
    finally:
        tr.close()
    p = psnr(rgb.cpu().numpy(), ds.images[0])
    print(f"render PSNR vs view 0: {p:.2f} dB")
    return p


def main(argv: list[str] | None = None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("result_dir", nargs="?",
                    default=str(pathlib.Path(tempfile.gettempdir())
                                / "f2nerf_example"))
    ap.add_argument("steps", nargs="?", type=int, default=600)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    return train(args.result_dir, args.steps, args.device)


if __name__ == "__main__":
    main()
