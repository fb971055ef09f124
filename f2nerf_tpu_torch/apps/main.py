"""CLI entry point: train / test / infer / walk / render (port of
``f2nerf_tpu/apps/main.py``).

Mirrors the reference ``main.cpp:19-34`` dispatch
(``main {train,infer,walk,test} <result_dir> [dataset_dir]``) plus a
``render`` batch novel-view command. Every command runs on ``cuda``
unless ``--device`` says otherwise (``--device cpu`` runs the plain
PyTorch path). ``train`` launched by ``torchrun`` trains across its
processes (``parallel/mesh.py``), one card each:

  torchrun --nproc_per_node=k -m f2nerf_tpu_torch.apps.main train <result_dir> <dataset_dir>

``--device`` then names every rank's device and ``--backend`` the
process group's (default: NCCL on cards, gloo on the CPU); ``test``,
``infer``, ``walk`` and ``render`` stay single-process, as in JAX.

Usage:
  python -m f2nerf_tpu_torch.apps.main train <result_dir> <dataset_dir>
  python -m f2nerf_tpu_torch.apps.main test <result_dir> <dataset_dir>
  python -m f2nerf_tpu_torch.apps.main infer <result_dir> <dataset_dir> [resize_factor]
  python -m f2nerf_tpu_torch.apps.main walk <result_dir>
  python -m f2nerf_tpu_torch.apps.main render <result_dir> <poses.npy> <out_dir>

The run directory holds ``train_config.yaml``, ``inference_params.yaml``,
``train_log.txt``, ``images/`` and ``checkpoints/step_*``; the commands
after ``train`` read it through ``Localizer.from_checkpoint``.
"""

from __future__ import annotations

import argparse
import pathlib
import signal
import sys
import time

import numpy as np

from f2nerf_tpu_torch.core.config import Config


def cmd_train(result_dir: str, dataset_dir: str,
              device: str | None = None, backend: str | None = None
              ) -> None:
    """Reference TrainManager (src/main_functions/train_manager.cpp):
    reads <result_dir>/train_config.yaml if present (else defaults),
    trains end_iter steps with logging, vis and checkpoints, and resumes
    from the newest checkpoint if one exists. Under ``torchrun`` it joins
    the process group (``backend``) and trains on a mesh of its ranks."""
    import torch.distributed as dist

    from f2nerf_tpu_torch.data.dataset import load_dataset
    from f2nerf_tpu_torch.parallel.mesh import (any_rank, make_mesh,
                                                maybe_initialize_distributed)
    from f2nerf_tpu_torch.train.loop import Trainer

    rank_dev = maybe_initialize_distributed(backend=backend, device=device)
    if rank_dev is None and backend is not None:
        raise SystemExit("--backend needs a torchrun launch (WORLD_SIZE "
                         "is not set)")
    mesh = None if rank_dev is None else make_mesh(device=rank_dev)
    try:
        rd = pathlib.Path(result_dir)
        conf = rd / "train_config.yaml"
        cfg = Config.load(conf) if conf.exists() else Config()
        ds = load_dataset(dataset_dir)
        tr = Trainer(cfg, ds, result_dir=rd, device=device, mesh=mesh)
        # graceful SIGTERM: finish the current tranche, checkpoint, exit
        # rc 1, so a time-limited train window never loses progress and
        # never kills the process mid-dispatch; the in-loop checkpoints
        # still come every save_freq steps. Every rank stops at the same
        # tranche (a SIGTERM on any rank stops them all).
        got_term = {"v": False}
        try:
            if tr.try_resume():
                print(f"resumed from step {tr.step}")
            prev = signal.signal(signal.SIGTERM,
                                 lambda *_: got_term.update(v=True))
            try:
                end = cfg.train.end_iter
                while (tr.step < end
                       and not any_rank(mesh, got_term["v"])):
                    tr.run(min(100, end - tr.step))
            finally:
                signal.signal(signal.SIGTERM, prev)
            tr.save_checkpoint()
            stop = any_rank(mesh, got_term["v"])
        finally:
            tr.close()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if stop:
        print(f"SIGTERM: checkpointed at step {tr.step}")
        raise SystemExit(1)
    print("Train done")


def cmd_test(result_dir: str, dataset_dir: str,
             device: str | None = None) -> None:
    """Reference test (src/main_functions/test.cpp:11-58): render every
    dataset pose at 1/8 resolution, score = H*W / sum(MSE), write
    summary.tsv (average_time, average_score)."""
    from f2nerf_tpu_torch.data.dataset import load_dataset
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
    from f2nerf_tpu_torch.utils.image_io import resize_image, write_image
    from f2nerf_tpu_torch.utils.metrics import image_score

    ds = load_dataset(dataset_dir)
    core = Localizer.from_checkpoint(
        result_dir, LocalizerParam(resize_factor=8), device=device)
    save_dir = pathlib.Path(result_dir) / "test_result"
    save_dir.mkdir(parents=True, exist_ok=True)

    scores, times = [], []
    for i in range(ds.n_images):
        gt = resize_image(ds.images[i], core.infer_height,
                          core.infer_width)
        t0 = time.monotonic()
        pred = core.render_image(ds.poses[i]).cpu().numpy()
        times.append(time.monotonic() - t0)
        scores.append(image_score(pred, gt))
        write_image(save_dir / f"{i:08d}.png",
                    np.concatenate([gt, pred], axis=1))
        print(f"\r{i + 1}/{ds.n_images} score={scores[-1]:.2f}",
              end="", flush=True)
    print()
    with open(save_dir / "summary.tsv", "w") as f:
        f.write("average_time\taverage_score\n")
        f.write(f"{np.mean(times):.6f}\t{np.mean(scores):.6f}\n")
    print(f"average_time={np.mean(times):.3f}s "
          f"average_score={np.mean(scores):.3f}")


def cmd_infer(result_dir: str, dataset_dir: str, resize_factor: int = 32,
              device: str | None = None) -> None:
    """Reference infer (src/main_functions/infer.cpp:15-102): per image,
    perturb the pose in 8 directions and recover it with 10 iterations
    of differentiable optimization; write position.tsv + step images.
    resize_factor defaults to the reference's hardcoded 32 (sized for
    ~2k-pixel vehicle footage); pass a smaller value as the third CLI
    arg for lower-resolution datasets."""
    from f2nerf_tpu_torch.data.dataset import load_dataset
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
    from f2nerf_tpu_torch.utils.image_io import resize_image, write_image
    from f2nerf_tpu_torch.utils.metrics import image_score

    k_dx = [0, 1, 1, 1, 0, -1, -1, -1]
    k_dz = [1, 1, 0, -1, -1, -1, 0, 1]
    iteration_num = 10

    ds = load_dataset(dataset_dir)
    core = Localizer.from_checkpoint(
        result_dir, LocalizerParam(resize_factor=resize_factor),
        device=device)
    save_dir = pathlib.Path(result_dir) / "inference_result"
    noise = 0.5 / core.radius
    opt_times = []

    def render(pose):
        return core.render_image(pose).cpu().numpy()

    for i in range(ds.n_images):
        curr_dir = save_dir / f"{i:04d}"
        curr_dir.mkdir(parents=True, exist_ok=True)
        initial_pose = ds.poses[i]
        image = resize_image(ds.images[i], core.infer_height,
                             core.infer_width)
        write_image(curr_dir / "image_01_gt.png", image)

        rows = ["name\tx\ty\tz\tscore"]

        def out(name, pose, score):
            w = core.camera2world(pose)
            rows.append(f"{name}\t{w[0, 3]:.6f}\t{w[1, 3]:.6f}"
                        f"\t{w[2, 3]:.6f}\t{score:.6f}")

        before = render(initial_pose)
        write_image(curr_dir / "image_02_before.png", before)
        out("original", initial_pose, image_score(before, image))

        for d in range(8):
            pose = initial_pose.copy()
            pose[0, 3] += noise * k_dx[d]
            pose[2, 3] += noise * k_dz[d]
            noised = render(pose)
            write_image(curr_dir / f"image_03_noised{d}.png", noised)
            out(f"noised_{d}", pose, image_score(noised, image))

            t0 = time.monotonic()
            optimized = core.optimize_pose_by_differential(
                pose, image, iteration_num)
            opt_times.append(time.monotonic() - t0)
            for itr, opt_pose in enumerate(optimized):
                after = render(opt_pose)
                write_image(
                    curr_dir / f"image_04_after_{d}_{itr:02d}.png", after)
                out(f"optimized_{d}_{itr:02d}", opt_pose,
                    image_score(after, image))

        (curr_dir / "position.tsv").write_text("\n".join(rows) + "\n")
        print(f"\r{i + 1}/{ds.n_images}", end="", flush=True)
    print(f"\nAverage Time = {np.mean(opt_times):.3f} sec")


def _read_key() -> str:
    """One keypress without Enter — the reference's kbhit loop
    (src/main_functions/walk.cpp:16-54 uses termios cbreak + select).
    Falls back to line input when stdin is not a TTY (tests, pipes)."""
    if not sys.stdin.isatty():
        return sys.stdin.readline().strip()[:1]
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    try:
        tty.setcbreak(fd)
        return sys.stdin.read(1)
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)


def cmd_walk(result_dir: str, device: str | None = None) -> None:
    """Reference walk (src/main_functions/walk.cpp:56-133): interactive
    WASD/QE translate + JKLIOU rotate fly-through writing image.png."""
    from f2nerf_tpu_torch.localize.localizer import (Localizer,
                                                     LocalizerParam,
                                                     _euler_rotations)
    from f2nerf_tpu_torch.utils.image_io import write_image

    core = Localizer.from_checkpoint(
        result_dir, LocalizerParam(resize_factor=8), device=device)
    pose = np.eye(3, 4, dtype=np.float32)
    step = 0.1
    ang = np.deg2rad(10.0)
    print("keys: wasd/qe translate, jl/ik/ou rotate, p quit; renders to "
          f"{result_dir}/image.png")
    while True:
        img = core.render_image(pose).cpu().numpy()
        write_image(pathlib.Path(result_dir) / "image.png", img)
        print("> ", end="", flush=True)
        c = _read_key()
        print(c)
        if c == "p" or c == "":
            break
        dt = {"w": [0, 0, -step], "s": [0, 0, step],
              "a": [-step, 0, 0], "d": [step, 0, 0],
              "q": [0, step, 0], "e": [0, -step, 0]}
        dr = {"j": [0, ang, 0], "l": [0, -ang, 0],
              "i": [ang, 0, 0], "k": [-ang, 0, 0],
              "o": [0, 0, ang], "u": [0, 0, -ang]}
        if c in dt:
            pose[:3, 3] += pose[:3, :3] @ np.array(dt[c], dtype=np.float32)
        elif c in dr:
            pose[:3, :3] = (_euler_rotations(np.array(dr[c]))
                            @ pose[:3, :3]).astype(np.float32)


def cmd_render(result_dir: str, poses_path: str, out_dir: str,
               device: str | None = None) -> None:
    """Batch novel-view render from an [N, 3, 4] poses .npy."""
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam
    from f2nerf_tpu_torch.utils.image_io import write_image

    core = Localizer.from_checkpoint(result_dir, LocalizerParam(),
                                     device=device)
    poses = np.load(poses_path)
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, pose in enumerate(poses):
        img = core.render_image(pose.astype(np.float32)).cpu().numpy()
        write_image(out / f"{i:05d}.png", img)
        print(f"\r{i + 1}/{len(poses)}", end="", flush=True)
    print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="f2nerf_tpu_torch")
    ap.add_argument("command",
                    choices=["train", "test", "infer", "walk", "render"])
    ap.add_argument("result_dir")
    ap.add_argument("extra", nargs="*")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, under torchrun "
                         "cuda:LOCAL_RANK; 'cpu' runs the plain PyTorch "
                         "path)")
    ap.add_argument("--backend", default=None,
                    help="train under torchrun: the process group's "
                         "backend (default: nccl on cards, gloo on the "
                         "CPU)")
    args = ap.parse_args(argv)
    need = {"train": 1, "test": 1, "infer": 1, "walk": 0, "render": 2}
    if len(args.extra) < need[args.command]:
        ap.error(f"{args.command} needs {need[args.command]} more "
                 f"argument(s) after result_dir")

    dev = args.device
    if args.command == "train":
        cmd_train(args.result_dir, args.extra[0], device=dev,
                  backend=args.backend)
    elif args.command == "test":
        cmd_test(args.result_dir, args.extra[0], device=dev)
    elif args.command == "infer":
        cmd_infer(args.result_dir, args.extra[0],
                  *(int(a) for a in args.extra[1:2]), device=dev)
    elif args.command == "walk":
        cmd_walk(args.result_dir, device=dev)
    elif args.command == "render":
        cmd_render(args.result_dir, args.extra[0], args.extra[1],
                   device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
