"""Paged hash-grid trilinear contraction, forward: the ``trilinear_fwd``
CUDA kernel (``csrc/trilinear_fwd.cu``), its plain PyTorch version and
its wrapper.

Port of the TPU kernel ``contract_fwd`` / ``_fwd_kernel``
(``f2nerf_tpu/kernels/trilinear.py:72-87, 146-169``). The TPU kernel
consumed rows already gathered by XLA; the CUDA kernel gathers them
itself, so one mode-0 localize request never materializes the
[N, C*128] rows buffer (1 KB per point and level in bf16).

The wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

ROW_PAD = 128        # lane-padded haloed row width per channel
_SUPPORTED_CHANNELS = (1, 2, 4, 8)


def trilinear_fwd_ref(haloed: torch.Tensor, page_idx: torch.Tensor,
                      local_frac: torch.Tensor,
                      chunk: int = 20480) -> torch.Tensor:
    """Plain version: gather rows, build the lane-padded f32 weight row
    (the counterpart of ``_weight_row``), contract; chunked by ``chunk``
    points to bound the [chunk, C*128] rows buffer."""
    from f2nerf_tpu_torch.ops.hash_paged import weight_row

    n_levels, n = page_idx.shape
    c = haloed.shape[1] // ROW_PAD
    chunk = max(int(chunk), 1)
    out = torch.empty((n, n_levels * c), dtype=torch.float32,
                      device=haloed.device)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        for lvl in range(n_levels):
            rows = haloed.index_select(0, page_idx[lvl, s:e].long())
            lf = local_frac[lvl, s:e]
            w = weight_row(lf[:, 0:3].to(torch.int32), lf[:, 3:6])
            feat = (rows.float().view(e - s, c, ROW_PAD)
                    * w[:, None, :]).sum(-1)
            out[s:e, lvl * c:(lvl + 1) * c] = feat
    return out


def _check(haloed, page_idx, local_frac):
    if haloed.dim() != 2 or haloed.shape[1] % ROW_PAD:
        raise ValueError(f"haloed must be [P, C*{ROW_PAD}], got "
                         f"{tuple(haloed.shape)}")
    if page_idx.dim() != 2:
        raise ValueError(f"page_idx must be [L, N], got "
                         f"{tuple(page_idx.shape)}")
    if tuple(local_frac.shape) != (*page_idx.shape, 6):
        raise ValueError(f"local_frac must be [L, N, 6] matching page_idx, "
                         f"got {tuple(local_frac.shape)}")


def trilinear_fwd(haloed: torch.Tensor, page_idx: torch.Tensor,
                  local_frac: torch.Tensor,
                  chunk: int = 20480) -> torch.Tensor:
    """feat [N, L*C] f32 from haloed [P, C*128] (bf16 or f32), page_idx
    [L, N] int32 (global page index) and local_frac [L, N, 6] f32
    (local xyz as floats in [0, 4), then frac xyz).

    ``chunk`` bounds memory of the plain version only.
    """
    _check(haloed, page_idx, local_frac)
    if haloed.device.type == "cpu":
        return trilinear_fwd_ref(haloed, page_idx, local_frac, chunk)
    if haloed.device.type != "cuda":
        raise ValueError(f"trilinear_fwd runs on cuda or cpu, not "
                         f"{haloed.device}")
    c = haloed.shape[1] // ROW_PAD
    if c not in _SUPPORTED_CHANNELS:
        raise ValueError(f"trilinear_fwd supports C in "
                         f"{_SUPPORTED_CHANNELS}, got {c}")
    if haloed.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"haloed must be bf16 or f32, got {haloed.dtype}")
    if page_idx.dtype != torch.int32 or local_frac.dtype != torch.float32:
        raise ValueError("page_idx must be int32 and local_frac float32")
    for name, t in (("haloed", haloed), ("page_idx", page_idx),
                    ("local_frac", local_frac)):
        if t.device != haloed.device:
            raise ValueError(f"{name} is on {t.device}, haloed on "
                             f"{haloed.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from f2nerf_tpu_torch.kernels.build import load_library

    lib = load_library("trilinear_fwd")
    fn = lib.trilinear_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_levels, n = page_idx.shape
    feat = torch.empty((n, n_levels * c), dtype=torch.float32,
                       device=haloed.device)
    with torch.cuda.device(haloed.device):
        stream = torch.cuda.current_stream(haloed.device).cuda_stream
        rc = fn(haloed.data_ptr(), int(haloed.dtype == torch.bfloat16),
                page_idx.data_ptr(), local_frac.data_ptr(), feat.data_ptr(),
                n, n_levels, c, haloed.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"trilinear_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    trilinear_fwd.launches += 1
    return feat


# launches of the CUDA kernel in this process (the plain version on the
# CPU does not count)
trilinear_fwd.launches = 0
