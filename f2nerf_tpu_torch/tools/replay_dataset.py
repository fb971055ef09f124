"""Replay a dataset's (image, pose) stream into the localizer service,
``python -m f2nerf_tpu_torch.apps.serve`` (port of
``scripts/replay_dataset.py``; the counterpart of the reference's
``pose_and_image_publisher`` node).

    python -m f2nerf_tpu_torch.tools.replay_dataset DATA_DIR \\
        [--host 127.0.0.1] [--port 7011] [--mode 0] [--test_mode] ...

Lock-step, as the node: for each frame an ``init_pose`` with the frame's
pose, then a ``localize`` with its image, then the next frame. Poses
come from ``pose.tsv`` (timestamped x/y/z/qx/qy/qz/qw rows) or
``cams_meta.npy`` (rows[:12] as 3x4 matrices). ``--test_mode`` sends 7
copies of frame 0 whose initial poses are moved by +1 m x, +2 m y,
+0.6 m z and turned by pi/4 about each axis. Writes ``replay_log.tsv``
(frame, score, noise_coeff, m00..m23 of the returned world pose).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import pathlib
import socket
import time

import numpy as np

from f2nerf_tpu_torch.localize.localizer import quat_xyzw_to_matrix
from f2nerf_tpu_torch.utils.image_io import read_image


def _rotvec_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def load_poses(data_dir: pathlib.Path, source: str) -> np.ndarray:
    """-> [N, 4, 4] world poses."""
    tsv = data_dir / "pose.tsv"
    npy = data_dir / "cams_meta.npy"
    if source == "auto":
        source = "pose_tsv" if tsv.exists() else "cams_meta"
    if source == "pose_tsv":
        rows = []
        with open(tsv) as f:
            for row in csv.DictReader(f, delimiter="\t"):
                rows.append([float(row[k]) for k in
                             ("x", "y", "z", "qx", "qy", "qz", "qw")])
        out = np.tile(np.eye(4), (len(rows), 1, 1))
        for i, r in enumerate(rows):
            out[i, :3, :3] = quat_xyzw_to_matrix(np.array(r[3:7]))
            out[i, :3, 3] = r[:3]
        return out
    cams = np.load(npy)
    out = np.tile(np.eye(4), (len(cams), 1, 1))
    out[:, :3, :4] = cams[:, :12].reshape(-1, 3, 4)
    return out


def apply_test_mode(poses: np.ndarray, images: list) -> tuple:
    """7 perturbed copies of frame 0 (reference main.py test_mode)."""
    p0 = poses[0]
    out = [p0.copy() for _ in range(7)]
    out[1][0, 3] += 1.0
    out[2][1, 3] += 2.0
    out[3][2, 3] += 0.6
    for i, ax in enumerate((np.array([1.0, 0, 0]), np.array([0, 1.0, 0]),
                            np.array([0, 0, 1.0]))):
        r = _rotvec_matrix(ax, np.pi / 4)
        out[4 + i][:3, :3] = r @ out[4 + i][:3, :3]
    return np.stack(out), [images[0]] * 7


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("data_dir", type=pathlib.Path)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7011)
    ap.add_argument("--source", choices=("auto", "pose_tsv", "cams_meta"),
                    default="auto")
    ap.add_argument("--mode", type=int, default=0,
                    help="0=particle search, 1=differential")
    ap.add_argument("--particle_num", type=int, default=64)
    ap.add_argument("--limit", type=int, default=0)
    ap.add_argument("--rate_limit_s", type=float, default=0.0,
                    help="min seconds between frames")
    ap.add_argument("--test_mode", action="store_true")
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="replay_log.tsv path (default: data_dir)")
    args = ap.parse_args(argv)

    image_files = sorted(glob.glob(str(args.data_dir / "images" / "*.png")))
    poses = load_poses(args.data_dir, args.source)
    n = min(len(image_files), len(poses))
    image_files, poses = image_files[:n], poses[:n]
    if args.test_mode:
        poses, image_files = apply_test_mode(poses, image_files)
    if args.limit:
        poses, image_files = poses[:args.limit], image_files[:args.limit]
    print(f"replaying {len(poses)} frames -> {args.host}:{args.port}")

    out_path = args.out or (args.data_dir / "replay_log.tsv")
    cols = ["frame", "score", "noise_coeff"] + [
        f"m{i}{j}" for i in range(3) for j in range(4)]
    log_rows = []

    with socket.create_connection((args.host, args.port)) as s:
        f = s.makefile("rw")

        def rpc(req: dict) -> dict:
            f.write(json.dumps(req) + "\n")
            f.flush()
            return json.loads(f.readline())

        for idx, (pose, img_path) in enumerate(zip(poses, image_files)):
            # the initial pose for frame i is frame i's own pose, as the
            # node's pose queue gives it
            r = rpc({"cmd": "init_pose", "pose": pose.tolist()})
            if not r.get("ok"):
                raise SystemExit(f"init_pose failed: {r}")
            image = np.asarray(read_image(img_path), dtype=np.float32)
            t0 = time.monotonic()
            r = rpc({"cmd": "localize", "image": image.tolist(),
                     "mode": args.mode, "particle_num": args.particle_num})
            if not r.get("ok"):
                raise SystemExit(f"localize failed at frame {idx}: {r}")
            dt = time.monotonic() - t0
            world = np.asarray(r["pose"])[:3, :4]
            print(f"frame {idx:04d} score={r['score']:.3f} "
                  f"noise={r['noise_coeff']:.2f} {dt * 1e3:.0f} ms")
            log_rows.append(
                [idx, r["score"], r["noise_coeff"]]
                + [float(v) for v in world.ravel()])
            if args.rate_limit_s:
                time.sleep(max(0.0, args.rate_limit_s - dt))

    with open(out_path, "w") as fh:
        fh.write("\t".join(cols) + "\n")
        for row in log_rows:
            fh.write("\t".join(
                str(v) if i == 0 else f"{v:.6f}"
                for i, v in enumerate(row)) + "\n")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
