"""Dataset: cams_meta.tsv + images, scene normalization, ray batches (port
of ``f2nerf_tpu/data/dataset.py``).

Reference ``src/dataset.{hpp,cpp}``: the 27-column ``cams_meta.tsv`` (12
pose + 9 intrinsic + 4 distortion + 2 near/far, src/dataset.cpp:40-44),
the scene normalized by centering the camera cloud and dividing positions
by the max radius (:77-86), sorted ``images/*.png``, uniform random
(image, i, j) ray batches (:150-171), and the ``inference_params.yaml``
sidecar the localizer reads (:106-133).

Images stay in host memory as one numpy array; a batch is (cam_idx, ij,
gt_color) and the train step makes the rays on the device. PNG files are
read and written by the port's own codec (``utils/image_io.py``) and the
sidecar by its own YAML writer (``core/yaml_io.py``), so neither PIL nor
``yaml`` is needed.
"""

from __future__ import annotations

import dataclasses
import glob
import pathlib

import numpy as np

from f2nerf_tpu_torch.core import yaml_io
from f2nerf_tpu_torch.core.cameras import normalize_poses
from f2nerf_tpu_torch.utils.image_io import read_image, write_image

CAMS_META_COLS = 27  # 12 pose + 9 intrinsic + 4 distortion + 2 bounds


@dataclasses.dataclass
class Dataset:
    poses: np.ndarray        # [N, 3, 4] normalized camera-to-world
    intrinsics: np.ndarray   # [N, 3, 3]
    dist_params: np.ndarray  # [N, 4] (loaded, never applied — like ref N12)
    bounds: np.ndarray       # [N, 2] near/far
    images: np.ndarray       # [N, H, W, 3] float32
    center: np.ndarray       # [3] normalization center (pre-normalization)
    radius: float            # normalization radius

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]

    @property
    def height(self) -> int:
        return self.images.shape[1]

    @property
    def width(self) -> int:
        return self.images.shape[2]

    def sample_batch(self, rng: np.random.Generator, batch_size: int
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Uniform random (cam, i, j) ray batch.

        Returns (cam_idx [B] int32, ij [B, 2] int32, gt_colors [B, 3] f32)
        — reference Dataset::sample_random_rays (src/dataset.cpp:150-171).
        """
        cam = rng.integers(0, self.n_images, batch_size)
        i = rng.integers(0, self.height, batch_size)
        j = rng.integers(0, self.width, batch_size)
        gt = self.images[cam, i, j]
        ij = np.stack([i, j], axis=-1).astype(np.int32)
        return cam.astype(np.int32), ij, gt.astype(np.float32)

    def save_inference_params(self, out_dir: str | pathlib.Path) -> None:
        """Write inference_params.yaml (src/dataset.cpp:106-133), the same
        text as the JAX package writes."""
        k = self.intrinsics[0]
        yaml_io.dump({"n_images": int(self.n_images),
                      "height": int(self.height),
                      "width": int(self.width),
                      "intrinsic": [float(v) for v in k.reshape(-1)],
                      "normalizing_center": [float(v) for v in self.center],
                      "normalizing_radius": float(self.radius)},
                     pathlib.Path(out_dir) / "inference_params.yaml",
                     float_format="{:.6f}", header="%YAML 1.2\n---\n")


def load_dataset(data_dir: str | pathlib.Path) -> Dataset:
    """Load a dataset directory: cams_meta.tsv + images/*.png (a
    directory of .jpg files only raises: the PNG reader names the gap)."""
    data_dir = pathlib.Path(data_dir)
    meta_path = data_dir / "cams_meta.tsv"
    rows = []
    with open(meta_path) as f:
        next(f)  # header
        for line in f:
            vals = [float(t) for t in line.strip().split("\t")]
            if len(vals) != CAMS_META_COLS:
                raise ValueError(
                    f"cams_meta.tsv row has {len(vals)} columns, "
                    f"expected {CAMS_META_COLS}")
            rows.append(vals)
    arr = np.array(rows, dtype=np.float32)
    poses = arr[:, 0:12].reshape(-1, 3, 4)
    intrinsics = arr[:, 12:21].reshape(-1, 3, 3)
    dist_params = arr[:, 21:25]
    bounds = arr[:, 25:27]

    poses, center, radius = normalize_poses(poses)

    image_paths = sorted(glob.glob(str(data_dir / "images" / "*.png")))
    if not image_paths:  # jpg as the JAX package does; read_image raises
        image_paths = sorted(glob.glob(str(data_dir / "images" / "*.jpg")))
    if len(image_paths) < poses.shape[0]:
        raise FileNotFoundError(
            f"found {len(image_paths)} images for {poses.shape[0]} poses "
            f"in {data_dir}/images")
    images = np.stack(
        [read_image(p) for p in image_paths[: poses.shape[0]]], axis=0)

    return Dataset(poses=poses, intrinsics=intrinsics,
                   dist_params=dist_params, bounds=bounds, images=images,
                   center=center, radius=radius)


def save_dataset(ds: Dataset, data_dir: str | pathlib.Path,
                 denormalize: bool = True) -> None:
    """Write a dataset in the reference's on-disk format (for tests and
    synthetic data)."""
    data_dir = pathlib.Path(data_dir)
    (data_dir / "images").mkdir(parents=True, exist_ok=True)
    poses = ds.poses.copy()
    if denormalize:
        poses[:, :3, 3] = poses[:, :3, 3] * ds.radius + ds.center
    header = "\t".join([f"c{i}" for i in range(CAMS_META_COLS)])
    rows = [header]
    for n in range(ds.n_images):
        vals = np.concatenate([
            poses[n].reshape(-1), ds.intrinsics[n].reshape(-1),
            ds.dist_params[n], ds.bounds[n]])
        rows.append("\t".join(f"{v:.9g}" for v in vals))
    (data_dir / "cams_meta.tsv").write_text("\n".join(rows) + "\n")
    for n in range(ds.n_images):
        write_image(data_dir / "images" / f"{n:06d}.png", ds.images[n])
