"""LPIPS(vgg) perceptual metric (port of ``f2nerf_tpu/utils/lpips.py``,
which is torch code on the CPU). The port's copy runs on the card unless
the CPU is asked for, and reads its weight file with
``torch.load(weights_only=True)``.

The reference's eval harness runs the ``lpips`` package with downloaded
VGG16 and linear-calibration weights (``scripts/eval.py:78-117``); the
metric is implemented here directly (Zhang et al. 2018: VGG16 feature
slices -> per-channel unit normalization -> squared difference ->
learned 1x1 linear calibration -> spatial mean -> sum over slices) and
its weights are read from a local file.

Weight file format (a ``torch.save``-d dict of tensors):

* ``"features"``: state_dict of the 13-conv VGG16 feature stack of
  :func:`build_vgg16_features` (keys ``<idx>.weight`` / ``<idx>.bias``
  in torchvision's ``vgg16().features`` layout), and
* ``"lin"``: a list of 5 tensors ``[1, C_l, 1, 1]``, the LPIPS linear
  heads of the slices (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).

``scripts/export_lpips_weights.py`` writes this file on a machine with
torchvision and lpips; point ``LPIPS_WEIGHTS`` at it, or put it at
``weights/lpips_vgg.pt``.
"""

from __future__ import annotations

import os
import pathlib

import torch
import torch.nn as nn

from f2nerf_tpu_torch.core.device import resolve_device

# VGG16 conv layout (torchvision vgg16().features indices):
# conv indices 0,2, 5,7, 10,12,14, 17,19,21, 24,26,28; 'M' = maxpool.
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M"]
# slice boundaries AFTER the relu of the last conv in each block
SLICE_ENDS = (4, 9, 16, 23, 30)
LIN_CHANNELS = (64, 128, 256, 512, 512)

# input normalization used by LPIPS (expects inputs in [-1, 1])
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def build_vgg16_features() -> nn.Sequential:
    """The 13-conv VGG16 feature stack as an nn.Sequential whose
    state_dict keys match torchvision's ``vgg16().features``."""
    layers = []
    in_ch = 3
    for v in VGG16_CFG:
        if v == "M":
            layers.append(nn.MaxPool2d(kernel_size=2, stride=2))
        else:
            layers.append(nn.Conv2d(in_ch, v, kernel_size=3, padding=1))
            layers.append(nn.ReLU(inplace=False))
            in_ch = v
    return nn.Sequential(*layers[:SLICE_ENDS[-1]])


class LPIPSVgg:
    """Callable LPIPS(vgg) distance on ``device``. Construct via
    :func:`load`."""

    def __init__(self, state: dict, device: torch.device):
        self.device = device
        self.features = build_vgg16_features()
        self.features.load_state_dict(state["features"])
        self.features.eval().to(device)
        for p in self.features.parameters():
            p.requires_grad_(False)
        lin = [torch.as_tensor(w, dtype=torch.float32, device=device)
               for w in state["lin"]]
        if len(lin) != len(LIN_CHANNELS):
            raise ValueError(f"need {len(LIN_CHANNELS)} linear heads, "
                             f"got {len(lin)}")
        for w, c in zip(lin, LIN_CHANNELS):
            if tuple(w.shape) != (1, c, 1, 1):
                raise ValueError(f"lin head shape {tuple(w.shape)} != "
                                 f"(1, {c}, 1, 1)")
        self.lin = lin
        self._shift = torch.tensor(_SHIFT, device=device).view(1, 3, 1, 1)
        self._scale = torch.tensor(_SCALE, device=device).view(1, 3, 1, 1)

    def _slices(self, x):
        outs = []
        prev = 0
        for end in SLICE_ENDS:
            for i in range(prev, end):
                x = self.features[i](x)
            outs.append(x)
            prev = end
        return outs

    @staticmethod
    def _unit_normalize(t, eps=1e-10):
        norm = (t ** 2).sum(dim=1, keepdim=True).sqrt()
        return t / (norm + eps)

    def __call__(self, x, y) -> float:
        """x, y: [B, 3, H, W] tensors in [-1, 1] (moved to the network's
        device) -> mean LPIPS. The convolutions run in fp32 whatever the
        process allows (PyTorch lets cuDNN use TF32 by default), so the
        card gives the CPU's metric."""
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            x = (x.to(self.device) - self._shift) / self._scale
            y = (y.to(self.device) - self._shift) / self._scale
            fx, fy = self._slices(x), self._slices(y)
            total = 0.0
            for a, b, w in zip(fx, fy, self.lin):
                d = (self._unit_normalize(a)
                     - self._unit_normalize(b)) ** 2
                # linear head = non-negative per-channel weights (the
                # lpips package clamps them >= 0 at inference)
                d = (d * w.clamp(min=0)).sum(dim=1, keepdim=True)
                total = total + d.mean(dim=(2, 3))
            return float(total.mean())


def default_weights_path() -> pathlib.Path | None:
    env = os.environ.get("LPIPS_WEIGHTS")
    if env:
        return pathlib.Path(env)
    here = pathlib.Path(__file__).resolve().parents[2]
    cand = here / "weights" / "lpips_vgg.pt"
    return cand if cand.exists() else None


def load(path: str | os.PathLike | None = None,
         device: str | torch.device | None = None) -> LPIPSVgg | None:
    """Load LPIPS weights onto ``device`` (default: the card; raises
    without one, ``device="cpu"`` for the CPU); None when the file is
    absent."""
    dev = resolve_device(device)
    p = pathlib.Path(path) if path is not None else default_weights_path()
    if p is None or not p.exists():
        return None
    state = torch.load(p, map_location="cpu", weights_only=True)
    return LPIPSVgg(state, dev)


def make_random_weights(path: str | os.PathLike, seed: int = 0) -> None:
    """Write a structurally valid weight file with random values, so the
    loader and the forward path run end to end without the real VGG
    weights."""
    torch.manual_seed(seed)
    feats = build_vgg16_features()
    state = {"features": feats.state_dict(),
             "lin": [torch.rand(1, c, 1, 1) * 0.1
                     for c in LIN_CHANNELS]}
    torch.save(state, path)
