"""Interpolate a smooth camera trajectory between dataset poses (port of
``scripts/inter_poses.py``; reference ``scripts/inter_poses.py:12-40``):
slerp on rotations and linear interpolation on positions between key
poses, written as ``poses_render.npy`` ([N, 3, 4]) for ``python -m
f2nerf_tpu_torch.apps.main render``.

    python -m f2nerf_tpu_torch.tools.inter_poses --data_dir DATA \\
        [--n_out 120] [--key_stride 1] [--out poses.npy]
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

from f2nerf_tpu_torch.data.dataset import load_dataset
from f2nerf_tpu_torch.localize.localizer import (matrix_to_quat_xyzw,
                                                 quat_xyzw_to_matrix)


def slerp(q0: np.ndarray, q1: np.ndarray, t: float) -> np.ndarray:
    if np.dot(q0, q1) < 0:
        q1 = -q1
    d = np.clip(np.dot(q0, q1), -1.0, 1.0)
    if d > 0.9995:
        q = q0 + t * (q1 - q0)
        return q / np.linalg.norm(q)
    th = np.arccos(d)
    return (np.sin((1 - t) * th) * q0 + np.sin(t * th) * q1) / np.sin(th)


def interpolate_poses(key_poses: np.ndarray, n_out: int) -> np.ndarray:
    """[K, 3, 4] key poses -> [n_out, 3, 4] interpolated trajectory."""
    k = len(key_poses)
    quats = [matrix_to_quat_xyzw(p[:3, :3].astype(np.float64))
             for p in key_poses]
    out = []
    for i in range(n_out):
        u = i * (k - 1) / max(n_out - 1, 1)
        a = min(int(u), k - 2)
        t = u - a
        q = slerp(quats[a], quats[a + 1], t)
        pose = np.zeros((3, 4), dtype=np.float32)
        pose[:3, :3] = quat_xyzw_to_matrix(q)
        pose[:3, 3] = ((1 - t) * key_poses[a][:3, 3]
                       + t * key_poses[a + 1][:3, 3])
        out.append(pose)
    return np.stack(out)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_dir", required=True,
                    help="dataset dir with cams_meta.tsv")
    ap.add_argument("--n_out", type=int, default=120)
    ap.add_argument("--key_stride", type=int, default=1,
                    help="use every k-th dataset pose as a key pose")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    ds = load_dataset(args.data_dir)
    traj = interpolate_poses(ds.poses[::args.key_stride], args.n_out)
    out = args.out or str(pathlib.Path(args.data_dir) / "poses_render.npy")
    np.save(out, traj)
    print(f"wrote {len(traj)} poses to {out}")


if __name__ == "__main__":
    main()
