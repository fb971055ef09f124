"""Image resize (port of ``f2nerf_tpu/utils/image_io.py::resize_image``).

The JAX package resizes with PIL; PIL is not installed beside the port on
the machine with the card, so this is the same operation in PyTorch:
uint8 quantization, bilinear with antialiasing (PIL's BILINEAR filter
widens its support when it shrinks an image), align_corners=False, and
uint8 rounding of the result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_image(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize float32 [H, W, 3] in [0, 1] -> [h, w, 3]."""
    q = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    x = torch.from_numpy(q).permute(2, 0, 1)[None].float()   # [1, 3, H, W]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).numpy().astype(np.float32) / 255.0
