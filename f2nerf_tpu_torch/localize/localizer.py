"""NeRF-based camera pose localization (port of
``f2nerf_tpu/localize/localizer.py``).

Reference ``src/localizer.{hpp,cpp}``, two modes:

* **particle search** (``optimize_pose_by_random_search``): N noisy
  poses around the prior, one batched render of ``render_pixel_num``
  random pixels per pose, particle weights ``(pixel_num / loss)^5``
  normalized (computed in log space), fused by weighted position +
  sign-aligned unweighted quaternion averaging. The particle noise and
  the pixel choice are drawn on the host from a numpy ``Generator``, as
  in the JAX package, so the same ``seed`` gives the same particles and
  pixels in both.
* **differentiable inverse rendering** (``optimize_pose_by_differential``,
  and the staged ``localize`` that refines a particle search with it):
  ``torch.optim.Adam`` directly on the 3x4 pose through one VALIDATE
  render of the whole frame. The pose gradient reaches the points
  through the encode's point gradient, the CUDA kernel
  ``trilinear_bwd_frac``; the field is frozen (its tensors are detached),
  so no page gradient is computed.

The multi-device ``mesh`` of the JAX localizer is not ported.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, NamedTuple

import numpy as np
import torch

from f2nerf_tpu_torch.core.cameras import (camera2world, pixel_grid,
                                           rays_from_pose, world2camera)
from f2nerf_tpu_torch.core.config import Config
from f2nerf_tpu_torch.core.device import resolve_device
from f2nerf_tpu_torch.models import hash_field, renderer


@dataclasses.dataclass
class LocalizerParam:
    """Reference LocalizerParam defaults (src/localizer.hpp:15-26)."""
    train_result_dir: str = ""
    render_pixel_num: int = 256
    noise_position_x: float = 0.025
    noise_position_y: float = 0.025
    noise_position_z: float = 0.025
    noise_rotation_x: float = 2.5
    noise_rotation_y: float = 2.5
    noise_rotation_z: float = 2.5
    resize_factor: int = 1
    # inference-time march start override (normalized scene units);
    # None keeps the trained config's sample_near
    sample_near: float | None = None


class Particle(NamedTuple):
    pose: np.ndarray   # [3, 4] NeRF-frame pose
    weight: float


def _euler_rotations(theta_xyz: np.ndarray) -> np.ndarray:
    """Rz @ Ry @ Rx from per-axis angles [..., 3] (radians) — the
    reference composes AngleAxis x, then y, then z
    (src/localizer.cpp:100-118)."""
    tx, ty, tz = theta_xyz[..., 0], theta_xyz[..., 1], theta_xyz[..., 2]

    def rot(c, s, axis):
        o = np.ones_like(c)
        z = np.zeros_like(c)
        if axis == 0:
            m = [o, z, z, z, c, -s, z, s, c]
        elif axis == 1:
            m = [c, z, s, z, o, z, -s, z, c]
        else:
            m = [c, -s, z, s, c, z, z, z, o]
        return np.stack(m, axis=-1).reshape(*c.shape, 3, 3)

    rx = rot(np.cos(tx), np.sin(tx), 0)
    ry = rot(np.cos(ty), np.sin(ty), 1)
    rz = rot(np.cos(tz), np.sin(tz), 2)
    return rz @ ry @ rx


def matrix_to_quat_xyzw(m: np.ndarray) -> np.ndarray:
    """Rotation matrix [3,3] -> quaternion in (x, y, z, w) order (the
    ROS geometry_msgs field order), Shepperd's method."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(m[i, i] - m[j, j] - m[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q


def quat_xyzw_to_matrix(quat_xyzw: np.ndarray) -> np.ndarray:
    """Quaternion in (x, y, z, w) order -> rotation matrix [3,3]."""
    x, y, z, w = quat_xyzw / np.linalg.norm(quat_xyzw)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def calc_average_pose(particles: list[Particle]) -> np.ndarray:
    """Weighted position + sign-aligned UNWEIGHTED quaternion mean
    (the reference's rotation average ignores the particle weights,
    src/localizer.cpp:254-281,283-316)."""
    avg_pos = sum(p.weight * p.pose[:3, 3] for p in particles)
    quats = [matrix_to_quat_xyzw(
                 np.asarray(p.pose[:3, :3], dtype=np.float64))
             for p in particles]
    front = quats[0]
    acc = np.zeros(4)
    for q in quats:
        acc += -q if np.dot(q, front) < 0 else q
    acc /= len(quats)
    out = np.zeros((3, 4), dtype=np.float32)
    out[:3, :3] = quat_xyzw_to_matrix(acc)
    out[:3, 3] = avg_pos
    return out


def _to_device(tree: dict[str, Any], device: torch.device) -> dict[str, Any]:
    """The params on ``device``, detached: the localizer never trains
    the field."""
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.detach().to(device) for k, v in tree.items()}


class Localizer:
    """Localizes images against a trained field."""

    def __init__(self, params, cfg: Config, intrinsic: np.ndarray,
                 center: np.ndarray, radius: float, height: int,
                 width: int, param: LocalizerParam | None = None,
                 occ_vals: torch.Tensor | None = None,
                 seed: int | None = None,
                 device: str | torch.device | None = None):
        """``params``: the port's params dict (see ``convert``);
        ``occ_vals``: ``occupancy.occ_values`` of the trained grid, needed
        when the config samples by occupancy. Runs on ``cuda`` unless
        ``device`` says otherwise, and raises if there is no card."""
        self.device = resolve_device(device)
        self.param = param or LocalizerParam()
        if self.param.sample_near is not None:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, sample_near=float(self.param.sample_near)))
        self.cfg = cfg
        params = _to_device(params, self.device)
        # params never change while serving, so the haloed table is built
        # once here instead of on every render
        params["field"]["haloed"] = hash_field.haloed_table(
            params["field"], cfg.model)
        self.params = params
        self.occ_vals = (None if occ_vals is None
                         else occ_vals.to(self.device))
        self.center = torch.as_tensor(np.asarray(center, dtype=np.float32))
        self.radius = float(radius)
        f = self.param.resize_factor
        self.infer_height = height // f
        self.infer_width = width // f
        intr = np.asarray(intrinsic, dtype=np.float32).copy() / f
        intr[2, 2] = 1.0
        self.intrinsic = torch.as_tensor(intr, device=self.device)
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_checkpoint(cls, train_result_dir: str | pathlib.Path,
                        param: LocalizerParam | None = None,
                        device: str | torch.device | None = None
                        ) -> "Localizer":
        """Load a run directory: ``inference_params.yaml`` and
        ``train_config.yaml`` (the files both trainers write), then the
        field, from the first of:

        * the newest checkpoint of the port's trainer,
          ``checkpoints/step_*/state.pt`` (``train/checkpoint.py``), as
          the JAX localizer reads its newest checkpoint;
        * ``torch_params.npz``, a converted JAX run: the params tree
          flattened by ``convert.flatten`` ("field/feat_pool",
          "field/mlp/w", ..., "app_emb") plus the occupancy grid as
          "occ_grid". A JAX run's Orbax checkpoint becomes that file by
          ``np.savez`` of its restored leaves, with the JAX package
          installed::

              state = f2nerf_tpu.train.checkpoint.restore(run / "checkpoints", template)
              flat = convert.flatten(jax.tree.map(np.asarray, state["params"]))
              flat["occ_grid"] = np.asarray(state["extra"]["occ_grid"])
              np.savez(run / "torch_params.npz", **flat)

          where ``template`` is built as in the JAX
          ``Localizer.from_checkpoint``.

        Raises ``FileNotFoundError`` naming both when neither exists.
        Reads no ``yaml`` (``core/yaml_io.py``).
        """
        from f2nerf_tpu_torch.convert import params_from_numpy, unflatten
        from f2nerf_tpu_torch.core import yaml_io
        from f2nerf_tpu_torch.models import occupancy
        from f2nerf_tpu_torch.train import checkpoint as ckpt_lib

        d = pathlib.Path(train_result_dir)
        ip = yaml_io.load(d / "inference_params.yaml")
        cfg = Config.load(d / "train_config.yaml")
        dev = resolve_device(device)
        npz = d / "torch_params.npz"
        if ckpt_lib.latest_step(d / "checkpoints") is not None:
            state = ckpt_lib.restore(d / "checkpoints")
            params = unflatten({k: v.to(dev)
                                for k, v in state["params"].items()})
            occ_grid = state["occ_grid"]
        elif npz.is_file():
            with np.load(npz) as data:
                flat = {k: data[k] for k in data.files}
            occ_grid = flat.pop("occ_grid", None)
            params = params_from_numpy(unflatten(flat), dev)
        else:
            raise FileNotFoundError(
                f"{d} holds neither a checkpoint of the port's trainer "
                f"(checkpoints/step_*/{ckpt_lib.STATE_FILE}) nor "
                f"torch_params.npz (a converted JAX run)")
        occ_vals = None
        if cfg.model.sampler_mode == "occ":
            if occ_grid is None:
                raise ValueError("the run directory has no occupancy grid, "
                                 "which sampler_mode='occ' needs")
            occ_vals = occupancy.occ_values(
                torch.as_tensor(occ_grid, device=dev), cfg.model)
        intr = np.array(ip["intrinsic"], dtype=np.float32).reshape(3, 3)
        return cls(params, cfg, intr,
                   np.array(ip["normalizing_center"], dtype=np.float32),
                   float(ip["normalizing_radius"]), ip["height"],
                   ip["width"], param=param, occ_vals=occ_vals,
                   device=dev)

    # -- rendering ---------------------------------------------------------
    @torch.inference_mode()
    def render_image(self, pose) -> torch.Tensor:
        """[H, W, 3] render at the localizer's resolution, on the device."""
        pose_t = torch.as_tensor(np.asarray(pose, dtype=np.float32),
                                 device=self.device)
        rgb, _ = renderer.render_image(
            self.params, pose_t, self.intrinsic, self.infer_height,
            self.infer_width, self.cfg.model,
            chunk=min(65536, self.infer_height * self.infer_width),
            occ_vals=self.occ_vals)
        return rgb

    # -- particle search ---------------------------------------------------
    @torch.inference_mode()
    def evaluate_poses(self, poses: np.ndarray, image: np.ndarray
                       ) -> np.ndarray:
        """One batched render of render_pixel_num random pixels for all
        poses -> normalized weights (src/localizer.cpp:176-252)."""
        h, w = self.infer_height, self.infer_width
        pix = min(self.param.render_pixel_num, h * w)
        sel = self._rng.choice(h * w, size=pix, replace=False)
        i = (sel // w).astype(np.float32)
        j = (sel % w).astype(np.float32)
        ij = torch.as_tensor(np.stack([i, j], axis=-1), device=self.device)

        poses_t = torch.as_tensor(np.asarray(poses, dtype=np.float32),
                                  device=self.device)         # [P, 3, 4]
        rays_o, rays_d = rays_from_pose(
            poses_t[:, None], self.intrinsic[None, None], ij[None])
        p = poses_t.shape[0]
        colors, _ = renderer.render_rays_chunked(
            self.params, rays_o.reshape(p * pix, 3),
            rays_d.reshape(p * pix, 3), self.cfg.model, chunk=65536,
            occ_vals=self.occ_vals)
        pred = torch.clamp(colors.reshape(p, pix, 3), 0.0, 1.0)
        gt = torch.as_tensor(
            np.asarray(image, dtype=np.float32).reshape(h * w, 3)[sel],
            device=self.device)[None]                         # [1, pix, 3]
        loss = torch.sum(torch.mean((pred - gt) ** 2, dim=-1), dim=-1)
        # weights (pix/loss)^5 normalized (src/localizer.cpp:237-247), in
        # log space: the raw power overflows fp32 when a loss is ~0
        logit = -5.0 * torch.log(loss + 1e-6)
        return torch.softmax(logit, dim=0).cpu().numpy()

    def optimize_pose_by_random_search(
            self, initial_pose: np.ndarray, image: np.ndarray,
            particle_num: int, noise_coeff: float) -> list[Particle]:
        """src/localizer.cpp:64-128. Noise axis mapping: world (x front,
        y left, z up) -> NeRF (x right, y up, z back)."""
        p = self.param
        pos_std = np.array([p.noise_position_y, p.noise_position_z,
                            p.noise_position_x]) * noise_coeff / self.radius
        rot_std = np.array([p.noise_rotation_y, p.noise_rotation_z,
                            p.noise_rotation_x]) * noise_coeff

        poses = [np.asarray(initial_pose, dtype=np.float32)]
        for _ in range(particle_num - 1):
            q = np.asarray(initial_pose, dtype=np.float32).copy()
            q[:3, 3] += self._rng.normal(0.0, pos_std)
            theta = np.deg2rad(self._rng.normal(0.0, rot_std))
            q[:3, :3] = _euler_rotations(theta) @ q[:3, :3]
            poses.append(q)
        poses = np.stack(poses)
        weights = self.evaluate_poses(poses, image)
        return [Particle(pose=poses[i], weight=float(weights[i]))
                for i in range(len(poses))]

    # -- differentiable mode ----------------------------------------------
    def _frame(self, image: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """The full pixel grid [H*W, 2] and the image [H*W, 3], on the
        device, for the differential loss."""
        h, w = self.infer_height, self.infer_width
        ij = torch.as_tensor(pixel_grid(h, w), device=self.device)
        gt = torch.tensor(
            np.asarray(image, dtype=np.float32).reshape(h * w, 3),
            device=self.device)
        return ij, gt

    def _pose_loss_backward(self, pose: torch.Tensor, ij: torch.Tensor,
                            gt: torch.Tensor) -> float:
        """sum((colors - gt)^2) / (n * 3) over the whole frame in one
        VALIDATE render, unclamped colors (JAX ``_diff_step``'s
        ``loss_fn``), with its gradient accumulated into the [3, 4] leaf
        ``pose``; returns the loss."""
        with torch.enable_grad():
            rays_o, rays_d = rays_from_pose(pose[None], self.intrinsic[None],
                                            ij)
            res = renderer.render(self.params, rays_o, rays_d,
                                  self.cfg.model, occ_vals=self.occ_vals)
            loss = torch.sum((res.colors - gt) ** 2) / (ij.shape[0] * 3)
            loss.backward()
        return float(loss.detach())

    def _diff_step_auto(self, pose: torch.Tensor, opt: torch.optim.Adam,
                        ij: torch.Tensor, gt: torch.Tensor) -> float:
        """One Adam step of the [3, 4] leaf ``pose`` in place, at the lr
        of ``opt``'s param group; returns the loss at the input pose.
        Both differential modes take it: the lr lives in the param group,
        so the backtracking loop halves it without a new step."""
        opt.zero_grad(set_to_none=True)
        loss = self._pose_loss_backward(pose, ij, gt)
        opt.step()
        return loss

    def pose_gradient(self, pose: np.ndarray, image: np.ndarray
                      ) -> tuple[float, np.ndarray]:
        """The differential loss at ``pose`` and its gradient [3, 4]: what
        a step of the differential modes descends."""
        leaf = torch.tensor(np.asarray(pose, dtype=np.float32),
                            device=self.device, requires_grad=True)
        loss = self._pose_loss_backward(leaf, *self._frame(image))
        return loss, leaf.grad.cpu().numpy()

    def _adam(self, pose: torch.Tensor, lr: float) -> torch.optim.Adam:
        """optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8) on ``pose``, fresh
        moments."""
        return torch.optim.Adam([pose], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def optimize_pose_by_differential(
            self, initial_pose: np.ndarray, image: np.ndarray,
            iteration_num: int, lr: float = 1e-4) -> list[np.ndarray]:
        """src/localizer.cpp:142-167: Adam on the 3x4 pose through the
        renderer; reported poses keep the original rotation rows."""
        ij, gt = self._frame(image)
        prev_rot = np.asarray(initial_pose)[:3, :3].copy()
        pose = torch.tensor(np.asarray(initial_pose, dtype=np.float32),
                            device=self.device, requires_grad=True)
        opt = self._adam(pose, lr)
        results = []
        for _ in range(iteration_num):
            self._diff_step_auto(pose, opt, ij, gt)
            out = pose.detach().cpu().numpy().copy()
            out[:3, :3] = prev_rot
            results.append(out)
        return results

    def localize(self, initial_pose: np.ndarray, image: np.ndarray,
                 particle_num: int = 128, search_rounds: int = 3,
                 noise_coeff: float = 2.0, diff_iters: int = 30,
                 diff_lr: float = 3e-3, min_lr: float = 1e-5,
                 auto_lr: bool = True) -> dict:
        """Staged localization: shrinking-rounds particle search (round r
        searches with noise_coeff / 2^r), then a safeguarded differential
        refinement: a step whose loss rises above the best reverts to the
        best pose, halves the lr and restarts Adam's moments.

        Returns dict(pose, search_pose, loss, lr_final, backtracks,
        loss_history). The reported pose keeps the search's rotation with
        the refined translation.
        """
        pose = np.asarray(initial_pose, dtype=np.float32)
        for r in range(search_rounds):
            parts = self.optimize_pose_by_random_search(
                pose, image, particle_num=particle_num,
                noise_coeff=noise_coeff / (2.0 ** r))
            pose = calc_average_pose(parts)
        search_pose = pose.copy()

        ij, gt = self._frame(image)
        lr = float(diff_lr)
        cur = torch.tensor(pose, device=self.device, requires_grad=True)
        opt = self._adam(cur, lr)
        best = cur.detach().clone()
        best_loss = float("inf")
        backtracks = 0
        history = []
        it = 0
        while it < diff_iters and lr >= min_lr:
            before = cur.detach().clone()
            loss = self._diff_step_auto(cur, opt, ij, gt)
            history.append(loss)
            if auto_lr and loss > best_loss * (1.0 + 1e-6):
                # the previous step hurt: revert to the best pose, halve
                # the rate, reset the Adam moments
                lr *= 0.5
                backtracks += 1
                with torch.no_grad():
                    cur.copy_(best)
                opt = self._adam(cur, lr)
                continue
            if loss <= best_loss:
                best, best_loss = before, loss
            it += 1

        out = best.cpu().numpy().copy()
        out[:3, :3] = search_pose[:3, :3]
        return {"pose": out, "search_pose": search_pose,
                "loss": best_loss, "lr_final": lr,
                "backtracks": backtracks, "loss_history": history}

    # -- frame conversion --------------------------------------------------
    def world2camera(self, pose_in_world: np.ndarray) -> np.ndarray:
        pose = torch.as_tensor(np.asarray(pose_in_world, dtype=np.float32))
        return world2camera(pose, self.center, self.radius).numpy()

    def camera2world(self, pose_in_camera: np.ndarray) -> np.ndarray:
        pose = torch.as_tensor(np.asarray(pose_in_camera, dtype=np.float32))
        return camera2world(pose, self.center, self.radius).numpy()
