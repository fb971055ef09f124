"""Localization service (port of ``f2nerf_tpu/apps/serve.py``).

The counterpart of the reference's Autoware ROS2 node
(``ros2/src/ros2-f2-nerf/src/nerf_based_localizer.cpp``): line-delimited
JSON over TCP, one request per line, one response per line.

Protocol (all arrays are nested JSON lists):
  {"cmd": "init_pose", "pose": [[...], ...]}       # 4x4 world pose
  {"cmd": "localize", "image": [[[...]]],          # [H, W, 3] floats
   "mode": 0|1|2,                                  # 0=particle, 1=diff,
                                                   # 2=staged
   "particle_num": 64}                             # modes 0 and 2
  mode 2 also takes "search_rounds" (3), "noise_coeff" (2.0),
  "diff_iters" (30), "diff_lr" (3e-3); "particle_num" defaults to 128
  {"cmd": "status"} | {"cmd": "shutdown"}

Responses:
  {"ok": true, "pose": [[...]], "score": s, "noise_coeff": c, ...}
  mode 2 adds "diff_loss", "lr_final" and "backtracks".

Mode 0 keeps the node's score-adaptive particle noise
``noise_coeff = base_score / previous_score`` clamped to [1, 5]
(nerf_based_localizer.cpp:276-279) and fuses the particles by their
average. Mode 1 is the node's differential tracking: one Adam iteration
at lr 1e-4 on the pose per frame. Mode 2 is the staged pipeline
(``Localizer.localize``): a shrinking particle search, then a
differential refinement with backtracking, for (re)acquisition from a
coarse prior.

Run: ``python -m f2nerf_tpu_torch.apps.serve <run_dir>``. The run
directory is what ``python -m f2nerf_tpu_torch.apps.main train`` writes
(``train_config.yaml``, ``inference_params.yaml`` and
``checkpoints/step_*``), or a converted JAX run with
``torch_params.npz`` in place of the checkpoints (see
``Localizer.from_checkpoint``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import socketserver
import threading

import numpy as np
import torch

from f2nerf_tpu_torch.kernels.resize import resize_aa
from f2nerf_tpu_torch.localize.localizer import calc_average_pose
from f2nerf_tpu_torch.utils import trace
from f2nerf_tpu_torch.utils.image_io import resize_image
from f2nerf_tpu_torch.utils.metrics import image_score

BASE_SCORE = 100.0  # reference parameter base_score_ (score scale)
PROFILE_FRAMES = (10, 15)  # the profile window's frames, first to last + 1


class LocalizerService:
    """The protocol's commands on one localizer. ``profile_dir``: trace
    localize frames 10 to 14 with ``torch.profiler`` into a Chrome trace
    there (``utils/trace.Window``), with the program's spans."""

    def __init__(self, localizer, save_particles_dir: str | None = None,
                 profile_dir: str | pathlib.Path | None = None):
        self.localizer = localizer
        self.lock = threading.Lock()
        self.pose_nerf: np.ndarray | None = None  # 3x4 NeRF frame
        self.previous_score = BASE_SCORE
        self.frames = 0
        self.save_particles_dir = save_particles_dir
        self._particles_cnt = 0
        self._window = trace.Window(profile_dir, PROFILE_FRAMES, "frames")

    def _dump_particles(self, particles) -> None:
        """Per-frame particle TSVs in the reference's format
        (nerf_based_localizer.cpp:311-329: header m00..m23, weight)."""
        d = pathlib.Path(self.save_particles_dir)
        d.mkdir(parents=True, exist_ok=True)
        cols = [f"m{i}{j}" for i in range(3) for j in range(4)]
        lines = ["\t".join(cols + ["weight"])]
        for p in particles:
            vals = [f"{v:.6f}" for v in np.asarray(p.pose)[:3, :4].ravel()]
            lines.append("\t".join(vals + [f"{p.weight:.6f}"]))
        (d / f"{self._particles_cnt:08d}.tsv").write_text(
            "\n".join(lines) + "\n")
        self._particles_cnt += 1

    def handle(self, req: dict) -> dict:
        cmd = req.get("cmd")
        if cmd == "init_pose":
            pose = np.asarray(req["pose"], dtype=np.float32)
            with self.lock:
                self.pose_nerf = self.localizer.world2camera(pose)
            return {"ok": True}
        if cmd == "status":
            with self.lock:
                return {"ok": True, "frames": self.frames,
                        "initialized": self.pose_nerf is not None,
                        "previous_score": self.previous_score}
        if cmd == "localize":
            return self._localize(req)
        if cmd == "shutdown":
            return {"ok": True, "shutdown": True}
        return {"ok": False, "error": f"unknown cmd {cmd!r}"}

    def _localize(self, req: dict) -> dict:
        with self.lock:
            self._window.tick(self.frames, self.localizer.device)
        with trace.span("serve.localize"):
            return self._localize_frame(req)

    def _resize(self, image: np.ndarray, h: int, w: int) -> np.ndarray:
        """``resize_image`` of the frame: for a localizer on CUDA, one copy
        of the frame to the card and the ``resize_aa`` kernel there (bit
        for bit the same values), else ``resize_image`` itself."""
        device = self.localizer.device
        if device.type != "cuda":
            return resize_image(image, h, w)
        frame = torch.from_numpy(np.ascontiguousarray(image)).to(device)
        trace.count("serve.resize_card", 1)
        return resize_aa(frame, h, w).cpu().numpy()

    def _localize_frame(self, req: dict) -> dict:
        with trace.span("serve.resize"):
            image = np.asarray(req["image"], dtype=np.float32)
            # the reference node resizes the incoming frame to the render
            # resolution (nerf_based_localizer.cpp:225-235)
            h, w = self.localizer.infer_height, self.localizer.infer_width
            if image.ndim == 3 and image.shape[:2] != (h, w):
                image = self._resize(image, h, w)
        mode = int(req.get("mode", 0))
        with self.lock:
            if self.pose_nerf is None:
                return {"ok": False, "error": "init_pose first"}
            pose = self.pose_nerf.copy()
            prev = self.previous_score

        extra = {}
        if mode == 0:
            noise_coeff = float(np.clip(BASE_SCORE / max(prev, 1e-6),
                                        1.0, 5.0))
            particles = self.localizer.optimize_pose_by_random_search(
                pose, image, int(req.get("particle_num", 64)), noise_coeff)
            if self.save_particles_dir:
                self._dump_particles(particles)
            new_pose = calc_average_pose(particles)
        elif mode == 1:
            # the node's per-frame differential tracking: one iteration
            noise_coeff = 0.0
            results = self.localizer.optimize_pose_by_differential(
                pose, image, iteration_num=1)
            new_pose = results[-1] if results else pose
        else:
            # staged (re)acquisition from a coarse prior
            noise_coeff = float(req.get("noise_coeff", 2.0))
            res = self.localizer.localize(
                pose, image,
                particle_num=int(req.get("particle_num", 128)),
                search_rounds=int(req.get("search_rounds", 3)),
                noise_coeff=noise_coeff,
                diff_iters=int(req.get("diff_iters", 30)),
                diff_lr=float(req.get("diff_lr", 3e-3)))
            new_pose = res["pose"]
            extra = {"diff_loss": float(res["loss"]),
                     "lr_final": float(res["lr_final"]),
                     "backtracks": int(res["backtracks"])}

        with trace.span("serve.render_reply"):
            rendered = self.localizer.render_image(new_pose).cpu().numpy()
        with trace.span("serve.score"):
            score = image_score(rendered, image.reshape(rendered.shape))

        with trace.span("serve.reply"):
            with self.lock:
                self.pose_nerf = new_pose
                self.previous_score = score
                self.frames += 1
            # the ROS2 node's log line; scripts/analyze_localizer_log.py
            # parses it
            print(f"score = {score}", flush=True)
            out = {
                "ok": True,
                "pose": self.localizer.camera2world(new_pose).tolist(),
                "score": float(score),
                "noise_coeff": noise_coeff,
                **extra,
            }
            if req.get("return_image"):
                out["rendered"] = rendered.tolist()
        return out


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        while True:
            line = self.rfile.readline()
            if not line:
                break
            try:
                req = json.loads(line)
                resp = self.server.service.handle(req)  # type: ignore
            except Exception as e:  # noqa: BLE001 — report, keep serving
                resp = {"ok": False, "error": str(e)}
            self.wfile.write((json.dumps(resp) + "\n").encode())
            self.wfile.flush()
            if resp.get("shutdown"):
                self.server.shutdown_requested = True  # type: ignore
                threading.Thread(target=self.server.shutdown).start()
                break


class Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True


def serve(localizer, host: str = "127.0.0.1", port: int = 0,
          save_particles_dir: str | None = None,
          profile_dir: str | None = None) -> Server:
    """Start the service; returns the (already listening) server. Call
    server.serve_forever() (blocking) or drive it from a thread."""
    srv = Server((host, port), _Handler)
    srv.service = LocalizerService(  # type: ignore
        localizer, save_particles_dir, profile_dir)
    srv.shutdown_requested = False  # type: ignore
    return srv


def main() -> None:
    from f2nerf_tpu_torch.localize.localizer import Localizer, LocalizerParam

    ap = argparse.ArgumentParser()
    ap.add_argument("train_result_dir")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=7011)
    ap.add_argument("--resize_factor", type=int, default=8)
    ap.add_argument("--save_particles_dir", default=None,
                    help="dump per-frame particle TSVs here")
    ap.add_argument("--profile_dir", default=None,
                    help="write a Chrome trace of frames 10-14 here")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args()

    core = Localizer.from_checkpoint(
        args.train_result_dir,
        LocalizerParam(resize_factor=args.resize_factor),
        device=args.device)
    srv = serve(core, args.host, args.port,
                save_particles_dir=args.save_particles_dir,
                profile_dir=args.profile_dir)
    print(f"localizer service on {srv.server_address}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
