"""Multi-level anchored XOR-prime hash encoding (port of
``f2nerf_tpu/ops/hash_encode.py``, ``hash_mode="xor"``).

The reference's own hash (``src/hash_3d_anchored.cu:27-58``), kept as
the semantic oracle of the paged encode:

* per (point, level): trilinear interpolation of 8 hashed corners with
  hash = ((x*pa) ^ (y*pb) ^ (z*pc)) mod table_size in uint32 wraparound
  arithmetic;
* per-level scale exp2(3 + 7*l/(L-1)) and per-level random anchor bias;
* CUDA's float -> unsigned conversion saturates negatives to 0:
  ``max(floor(pt), 0)``.

PyTorch has few ``uint32`` ops, so the hash runs in int64: a corner
coordinate is below 2^13 and a prime below 2^30, so each product is
exact in int64, and masking it to 32 bits gives the uint32 product's
residue; the XOR and the final mask act on those residues alone.

Plain PyTorch, as the JAX package's is plain ``jnp``: no kernel. The
feature gradient is autograd's transpose of the row gather (an
``index_add_``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_U32 = 0xFFFFFFFF
# corner d = (dx << 2) | (dy << 1) | dz, the reference kernel's order
# (src/hash_3d_anchored.cu:37-44)
_CORNERS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))


@functools.lru_cache(maxsize=8)
def _corners(device: torch.device) -> torch.Tensor:
    """[8, 3] int64 corner offsets on ``device``, copied from the host once
    per device (a CUDA graph's capture cannot copy from the host), outside
    inference mode."""
    with torch.inference_mode(False):
        return torch.tensor(_CORNERS, dtype=torch.int64, device=device)


def level_scales(n_levels: int, res_base_pow2: float = 3.0,
                 res_fine_pow2: float = 10.0) -> np.ndarray:
    """Per-level scale factors: exp2(base + (fine-base) * l / (L-1))."""
    lvl = np.arange(n_levels, dtype=np.float32)
    denom = max(n_levels - 1, 1)
    return np.exp2(res_base_pow2
                   + (res_fine_pow2 - res_base_pow2) * lvl / denom)


def hash_corner_indices(points: torch.Tensor, primes: torch.Tensor,
                        biases: torch.Tensor, scales: torch.Tensor,
                        table_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Hashed corner indices and trilinear weights.

    Args:
      points: [N, 3] contracted points.
      primes: [L, 3] integer per-level hash primes (below 2^30).
      biases: [L, 3] float32 per-level anchor offsets.
      scales: [L] float32 per-level resolution multipliers.
      table_size: entries per level.

    Returns:
      (idx [N, L, 8] int64 in [0, table_size), w [N, L, 8] float32).
    """
    pt = (points[:, None, :] * scales[None, :, None].to(points.dtype)
          + biases[None, :, :].to(points.dtype)).float()     # [N, L, 3]
    f = torch.floor(pt.detach())
    frac = pt - f
    ipos = torch.clamp_min(f, 0.0).to(torch.int64)           # saturate
    corners = _corners(points.device)
    cpos = ipos[:, :, None, :] + corners                     # [N, L, 8, 3]
    p = primes.to(torch.int64)[None, :, None, :]             # [1, L, 1, 3]
    prod = (cpos * p) & _U32
    h = prod[..., 0] ^ prod[..., 1] ^ prod[..., 2]           # [N, L, 8]
    if table_size & (table_size - 1) == 0:
        idx = h & (table_size - 1)
    else:
        idx = h % table_size

    a, b, c = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    wx = torch.cat([1.0 - a, a], dim=-1)                     # [N, L, 2]
    wy = torch.cat([1.0 - b, b], dim=-1)
    wz = torch.cat([1.0 - c, c], dim=-1)
    w = (wx[:, :, :, None, None] * wy[:, :, None, :, None]
         * wz[:, :, None, None, :]).reshape(idx.shape)
    return idx, w


def hash_encode(points: torch.Tensor, feat_pool: torch.Tensor,
                primes: torch.Tensor, biases: torch.Tensor,
                scales: torch.Tensor) -> torch.Tensor:
    """Hash-grid encode.

    Args:
      points: [N, 3] contracted points (float32).
      feat_pool: [L, T, C] feature table (float32 or bfloat16).
      primes: [L, 3] integers; biases: [L, 3] f32; scales: [L] f32.

    Returns:
      [N, L*C] float32 features, channel-minor per level
      (out[:, l*C + k] = level l, channel k).
    """
    n_levels, table_size, n_ch = feat_pool.shape
    idx, w = hash_corner_indices(points, primes, biases, scales, table_size)
    n = points.shape[0]
    level_off = (torch.arange(n_levels, dtype=torch.int64,
                              device=points.device) * table_size)[:, None]
    flat = feat_pool.reshape(n_levels * table_size, n_ch)
    vals = flat.index_select(0, (idx + level_off).reshape(-1))
    vals = vals.reshape(n, n_levels, 8, n_ch).float()
    out = torch.sum(vals * w[..., None], dim=2)
    return out.reshape(n, n_levels * n_ch)


def init_primes(rng: np.random.Generator, n_levels: int) -> np.ndarray:
    """Random primes in [2^28, 2^30), 3 per level, uint32 [L, 3] (the
    JAX package's draws from the same Generator; reference
    src/hash_3d_anchored.cpp:28-55)."""
    def is_prime(x: int) -> bool:
        i = 2
        while i * i <= x:
            if x % i == 0:
                return False
            i += 1
        return True

    vals = []
    while len(vals) < 3 * n_levels:
        v = int(rng.integers(1 << 28, 1 << 30))
        if is_prime(v):
            vals.append(v)
    return np.array(vals, dtype=np.uint32).reshape(n_levels, 3)
