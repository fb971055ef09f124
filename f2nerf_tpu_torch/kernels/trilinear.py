"""Paged hash-grid trilinear contraction: the CUDA kernels
``trilinear_fwd`` (``csrc/trilinear_fwd.cu``), ``trilinear_bwd``
(``csrc/trilinear_bwd.cu``) and ``trilinear_bwd_frac``
(``csrc/trilinear_bwd_frac.cu``), their plain PyTorch versions and their
wrappers. Together they port every TPU kernel of the JAX package.

* ``trilinear_fwd`` ports the TPU kernel ``contract_fwd`` /
  ``_fwd_kernel`` (``f2nerf_tpu/kernels/trilinear.py:72-87, 146-169``).
  The TPU kernel consumed rows already gathered by XLA; the CUDA kernel
  gathers them itself, so the [N, C*128] rows buffer (1 KB per point and
  level in bf16) never exists.
* ``trilinear_bwd`` ports ``contract_bwd_rows`` / ``_bwd_rows_kernel``
  (``:90-100, 172-195``) together with the per-level ``segment_sum``
  that reduced its rows into pages (``f2nerf_tpu/ops/hash_paged.py``
  ``_encode_core_bwd``): it writes the page gradient directly, in a
  fixed order, so it is deterministic without float atomics.
* ``trilinear_bwd_frac`` ports ``contract_bwd_frac`` / ``_bwd_frac_kernel``
  (``:103-117, 198-224``), the point gradient of the localizer's pose
  refinement. Like ``trilinear_fwd`` it gathers its own 8 corners, where
  XLA re-gathered the [N, C*128] rows for the TPU kernel; at f == 0 it
  gives the JAX jnp branch's one-sided derivative (the Pallas hat form
  gives 0 there).

The haloed table is slot-major, [P, 128*C] with the C channels of slot
s at columns s*C .. s*C + C - 1 (``ops/hash_paged.py``), so a corner is
one vector load in the CUDA kernels.

Each wrapper takes the plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises. The kernels are built for
C in {1, 2, 4, 8}; the wrappers zero-pad any other C up to 8 (3 -> 4,
5-7 -> 8) and slice the result, so a supported width takes no copy.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

ROW_PAD = 128        # slots of a haloed row (125 cells, lane-padded)
# channel counts the kernels are instantiated for
_SUPPORTED_CHANNELS = (1, 2, 4, 8)
# largest L*C of trilinear_fwd / trilinear_bwd_frac: a block's [32, L*C]
# f32 tile in shared memory (kMaxRowFloats, csrc/trilinear_common.cuh)
_MAX_LEVEL_CHANNELS = 256


def trilinear_fwd_ref(haloed: torch.Tensor, page_idx: torch.Tensor,
                      local_frac: torch.Tensor,
                      chunk: int = 20480) -> torch.Tensor:
    """Plain version: gather rows, build the lane-padded f32 weight row
    (the counterpart of ``_weight_row``), contract; chunked by ``chunk``
    points to bound the [chunk, 128*C] rows buffer."""
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
            feat = (rows.float().view(e - s, ROW_PAD, c)
                    * w[:, :, None]).sum(1)
            out[s:e, lvl * c:(lvl + 1) * c] = feat
    return out


def _check(haloed, page_idx, local_frac):
    if haloed.dim() != 2 or haloed.shape[1] % ROW_PAD:
        raise ValueError(f"haloed must be [P, {ROW_PAD}*C], got "
                         f"{tuple(haloed.shape)}")
    _check_points(page_idx, local_frac)


def _check_points(page_idx, local_frac):
    if page_idx.dim() != 2:
        raise ValueError(f"page_idx must be [L, N], got "
                         f"{tuple(page_idx.shape)}")
    if tuple(local_frac.shape) != (*page_idx.shape, 6):
        raise ValueError(f"local_frac must be [L, N, 6] matching page_idx, "
                         f"got {tuple(local_frac.shape)}")


def trilinear_fwd(haloed: torch.Tensor, page_idx: torch.Tensor,
                  local_frac: torch.Tensor,
                  chunk: int = 20480) -> torch.Tensor:
    """feat [N, L*C] f32 from haloed [P, 128*C] (slot-major, see
    ``ops/hash_paged.py``; bf16 or f32), page_idx [L, N] int32 (global
    page index) and local_frac [L, N, 6] f32 (local xyz as floats in
    [0, 4), then frac xyz).

    ``chunk`` bounds memory of the plain version only.
    """
    _check(haloed, page_idx, local_frac)
    if haloed.device.type == "cpu":
        return trilinear_fwd_ref(haloed, page_idx, local_frac, chunk)
    n_levels, n = page_idx.shape
    c, width = _check_table("trilinear_fwd", haloed, n_levels)
    _check_cuda(haloed=haloed, page_idx=page_idx, local_frac=local_frac)
    haloed = _pad_channels(haloed, c, width)
    haloed, local_frac = _aligned(haloed, 16), _aligned(local_frac, 8)
    from f2nerf_tpu_torch.kernels.build import load_library

    lib = load_library("trilinear_fwd")
    fn = lib.trilinear_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    feat = torch.empty((n, n_levels * width), dtype=torch.float32,
                       device=haloed.device)
    with torch.cuda.device(haloed.device):
        stream = torch.cuda.current_stream(haloed.device).cuda_stream
        rc = fn(haloed.data_ptr(), int(haloed.dtype == torch.bfloat16),
                page_idx.data_ptr(), local_frac.data_ptr(), feat.data_ptr(),
                n, n_levels, width, haloed.shape[0], stream)
    if rc != 0:
        raise RuntimeError(f"trilinear_fwd kernel launch failed: CUDA "
                           f"error {rc}")
    trilinear_fwd.launches += 1
    return _unpad_channels(feat, c, width)


def _kernel_width(kernel: str, c: int, n_levels: int,
                  tile: bool = True) -> int:
    """The channel count the kernel runs at for C channels: C itself when
    it is in ``_SUPPORTED_CHANNELS``, else the next one up (the wrappers
    zero-pad). ``tile``: the kernel keeps a block's [32, L*width] f32 tile
    in shared memory, so L*width may not pass ``_MAX_LEVEL_CHANNELS``."""
    width = next((w for w in _SUPPORTED_CHANNELS if w >= c), None)
    if c < 1 or width is None:
        raise ValueError(f"{kernel} supports 1 <= C <= "
                         f"{_SUPPORTED_CHANNELS[-1]}, got {c}")
    if tile and n_levels * width > _MAX_LEVEL_CHANNELS:
        raise ValueError(
            f"{kernel} supports L*C <= {_MAX_LEVEL_CHANNELS} (a block's "
            f"[32, L*C] f32 tile in shared memory), got {n_levels}*{width}"
            + (f" (C = {c} runs at {width})" if width != c else ""))
    return width


def _pad_channels(t: torch.Tensor, c: int, width: int) -> torch.Tensor:
    """[rows, k*c] with the c channels innermost -> [rows, k*width], the
    channels zero-padded; ``t`` itself when width == c."""
    if width == c:
        return t
    rows = t.shape[0]
    return F.pad(t.view(rows, -1, c), (0, width - c)).reshape(rows, -1)


def _unpad_channels(t: torch.Tensor, c: int, width: int) -> torch.Tensor:
    """Inverse of :func:`_pad_channels`: keep the first c of each width."""
    if width == c:
        return t
    rows = t.shape[0]
    return t.view(rows, -1, width)[..., :c].reshape(rows, -1)


def _check_table(kernel: str, haloed: torch.Tensor, n_levels: int
                 ) -> tuple[int, int]:
    """A table the CUDA kernels take: on cuda, bf16 or f32, 1 <= C <= 8,
    L*C (padded) at most ``_MAX_LEVEL_CHANNELS``; returns (C, the width
    the kernel runs at)."""
    if haloed.device.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not "
                         f"{haloed.device}")
    c = haloed.shape[1] // ROW_PAD
    width = _kernel_width(kernel, c, n_levels)
    if haloed.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"haloed must be bf16 or f32, got {haloed.dtype}")
    return c, width


def _aligned(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on an
    ``nbytes`` boundary: the kernels read it with vector loads, and a
    view into a larger tensor may start anywhere."""
    return t if t.data_ptr() % nbytes == 0 else t.clone()


def _check_cuda(**tensors):
    """dtype, device and contiguity checks shared by the CUDA paths;
    the first keyword names the reference device."""
    (ref_name, ref), *_ = tensors.items()
    page_idx, local_frac = tensors["page_idx"], tensors["local_frac"]
    if page_idx.dtype != torch.int32 or local_frac.dtype != torch.float32:
        raise ValueError("page_idx must be int32 and local_frac float32")
    for name, t in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name} is on {t.device}, {ref_name} on "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def trilinear_bwd_ref(g: torch.Tensor, page_idx: torch.Tensor,
                      local_frac: torch.Tensor, n_pages: int,
                      dtype: torch.dtype = torch.float32,
                      chunk: int = 20480) -> torch.Tensor:
    """Plain version: per level and chunk of ``chunk`` points, the rows
    cotangent g (x) weight_row (``_drows_level``'s jnp branch,
    ``f2nerf_tpu/ops/hash_paged.py:389-393``), summed into pages with
    ``index_add_`` in f32, stored in ``dtype``."""
    from f2nerf_tpu_torch.ops.hash_paged import weight_row

    n_levels, n = page_idx.shape
    c = g.shape[1] // n_levels
    chunk = max(int(chunk), 1)
    out = torch.zeros((n_pages, c * ROW_PAD), dtype=torch.float32,
                      device=g.device)
    for lvl in range(n_levels):
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            lf = local_frac[lvl, s:e]
            w = weight_row(lf[:, 0:3].to(torch.int32), lf[:, 3:6])
            d_rows = (w[:, :, None]
                      * g[s:e, lvl * c:(lvl + 1) * c].float()[:, None, :]
                      ).reshape(e - s, ROW_PAD * c)
            out.index_add_(0, page_idx[lvl, s:e].long(), d_rows)
    return out.to(dtype)


def trilinear_bwd(g: torch.Tensor, page_idx: torch.Tensor,
                  local_frac: torch.Tensor, n_pages: int,
                  dtype: torch.dtype = torch.float32,
                  chunk: int = 20480) -> torch.Tensor:
    """d_haloed [n_pages, 128*C] (slot-major, see ``ops/hash_paged.py``)
    in ``dtype`` (bf16 or f32) from the
    cotangent g [N, L*C] f32 of ``trilinear_fwd``'s output and the same
    page_idx [L, N] int32 / local_frac [L, N, 6] f32 it was given.

    On the card: a zero-filled output, a stable sort of the page keys
    (glue, ``_bwd_sort``), then the two passes of
    ``csrc/trilinear_bwd.cu`` (``_bwd_passes``): one warp per tile of 256
    sorted entries adds each entry's 8 corners in entry order, and a
    merge adds the runs that cross tile edges in tile order. No float
    atomics: two calls on the same inputs give bitwise-equal results.
    ``chunk`` bounds memory of the plain version only.
    """
    _check_points(page_idx, local_frac)
    n_levels, n = page_idx.shape
    if g.dim() != 2 or g.shape[0] != n or g.shape[1] % n_levels:
        raise ValueError(f"g must be [N, L*C] = [{n}, {n_levels}*C], got "
                         f"{tuple(g.shape)}")
    if g.device.type == "cpu":
        return trilinear_bwd_ref(g, page_idx, local_frac, n_pages, dtype,
                                 chunk)
    if g.device.type != "cuda":
        raise ValueError(f"trilinear_bwd runs on cuda or cpu, not "
                         f"{g.device}")
    c = g.shape[1] // n_levels
    width = _kernel_width("trilinear_bwd", c, n_levels, tile=False)
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"d_haloed must be bf16 or f32, got {dtype}")
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    _check_cuda(g=g, page_idx=page_idx, local_frac=local_frac)
    if n * n_levels == 0:
        return torch.zeros((n_pages, c * ROW_PAD), dtype=dtype,
                           device=g.device)
    d_haloed = torch.zeros((n_pages, width * ROW_PAD), dtype=dtype,
                           device=g.device)
    skey, perm = _bwd_sort(page_idx, n_pages)
    _bwd_passes(_pad_channels(g, c, width), local_frac, skey, perm, d_haloed)
    return _unpad_channels(d_haloed, c, width)


def _bwd_sort(page_idx: torch.Tensor, n_pages: int):
    """Glue of ``trilinear_bwd``: the page keys of the L*N entries
    sorted stably, so the entries of each page form one run of the sorted
    order in ascending entry index; keys clamped as the forward clamps
    its gather. Returns (skey int32, perm int64)."""
    keys = page_idx.reshape(-1).clamp(0, n_pages - 1)
    return torch.sort(keys, stable=True)


def _bwd_passes(g: torch.Tensor, local_frac: torch.Tensor,
                skey: torch.Tensor, perm: torch.Tensor,
                d_haloed: torch.Tensor) -> None:
    """The two passes of ``csrc/trilinear_bwd.cu`` into ``d_haloed``
    [P, 128*C] (bf16 or f32), which holds zeros where no entry falls;
    inputs checked by ``trilinear_bwd``."""
    from f2nerf_tpu_torch.kernels.build import load_library

    n_levels, n = local_frac.shape[:2]
    c = d_haloed.shape[1] // ROW_PAD
    # the kernel reads g slices and local_frac with vector loads
    g, local_frac = _aligned(g, 16), _aligned(local_frac, 8)
    lib = load_library("trilinear_bwd")
    fn = lib.trilinear_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.trilinear_bwd_tile_size.argtypes = []
    lib.trilinear_bwd_tile_size.restype = ctypes.c_int
    tile = lib.trilinear_bwd_tile_size()
    partial = torch.empty((-(-skey.numel() // tile), 2, c * ROW_PAD),
                          dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), local_frac.data_ptr(), skey.data_ptr(),
                perm.data_ptr(), d_haloed.data_ptr(),
                int(d_haloed.dtype == torch.bfloat16), partial.data_ptr(),
                n, n_levels, c, stream)
    if rc != 0:
        raise RuntimeError(f"trilinear_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    trilinear_bwd.launches += 1


def trilinear_bwd_frac_ref(haloed: torch.Tensor, page_idx: torch.Tensor,
                           local_frac: torch.Tensor, g: torch.Tensor,
                           chunk: int = 20480,
                           magnitudes: bool = False) -> torch.Tensor:
    """Plain version: per level and chunk of ``chunk`` points, gather the
    rows, form d_w = sum_c g_c * rows_c in f32 and take the one-hot
    derivative of the weight row (``_dfrac_level``'s jnp branch,
    ``f2nerf_tpu/ops/hash_paged.py:405-416``, with g kept in f32 as the
    Pallas kernel keeps it).

    ``magnitudes=True`` returns instead the sum of the magnitudes of
    each output's terms (|g|, |rows| and |dw|), the scale against which
    the kernel's rounding is judged.
    """
    from f2nerf_tpu_torch.ops.hash_paged import PAGE_CELLS, axis_weights

    n_levels, n = page_idx.shape
    c = haloed.shape[1] // ROW_PAD
    chunk = max(int(chunk), 1)
    out = torch.zeros((n_levels, n, 6), dtype=torch.float32,
                      device=haloed.device)
    for lvl in range(n_levels):
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            rows = haloed.index_select(0, page_idx[lvl, s:e].long()).float()
            g_l = g[s:e, lvl * c:(lvl + 1) * c].float()
            lf = local_frac[lvl, s:e]
            w, dw = axis_weights(lf[:, 0:3].to(torch.int32), lf[:, 3:6])
            if magnitudes:
                rows, g_l, dw = rows.abs(), g_l.abs(), dw.abs()
            d_w = (rows.view(e - s, ROW_PAD, c) * g_l[:, None, :]).sum(2)
            d_w = d_w[:, :PAGE_CELLS].reshape(e - s, 5, 5, 5)
            wx, wy, wz = w.unbind(1)
            dwx, dwy, dwz = dw.unbind(1)
            out[lvl, s:e, 3] = torch.einsum("nxyz,nx,ny,nz->n", d_w, dwx,
                                            wy, wz)
            out[lvl, s:e, 4] = torch.einsum("nxyz,nx,ny,nz->n", d_w, wx,
                                            dwy, wz)
            out[lvl, s:e, 5] = torch.einsum("nxyz,nx,ny,nz->n", d_w, wx,
                                            wy, dwz)
    return out


def trilinear_bwd_frac(haloed: torch.Tensor, page_idx: torch.Tensor,
                       local_frac: torch.Tensor, g: torch.Tensor,
                       chunk: int = 20480) -> torch.Tensor:
    """d_local_frac [L, N, 6] f32, the gradient of ``trilinear_fwd``'s
    output with respect to its local_frac: zeros in the three ``local``
    columns (integer coords, as the JAX backward returns them) and
    d_frac in the last three. Takes the same haloed [P, 128*C]
    (slot-major, see ``ops/hash_paged.py``; bf16 or f32), page_idx
    [L, N] int32 and local_frac [L, N, 6] f32 as
    ``trilinear_fwd`` and the cotangent g [N, L*C] f32 of its output.

    On the card: one launch of ``csrc/trilinear_bwd_frac.cu``; each
    output is written by one thread, so two calls on the same inputs
    give bitwise-equal results. ``chunk`` bounds memory of the plain
    version only.
    """
    _check(haloed, page_idx, local_frac)
    n_levels, n = page_idx.shape
    c = haloed.shape[1] // ROW_PAD
    if tuple(g.shape) != (n, n_levels * c):
        raise ValueError(f"g must be [N, L*C] = [{n}, {n_levels * c}], got "
                         f"{tuple(g.shape)}")
    if haloed.device.type == "cpu":
        return trilinear_bwd_frac_ref(haloed, page_idx, local_frac, g, chunk)
    c, width = _check_table("trilinear_bwd_frac", haloed, n_levels)
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    _check_cuda(haloed=haloed, page_idx=page_idx, local_frac=local_frac,
                g=g)
    haloed, g = _pad_channels(haloed, c, width), _pad_channels(g, c, width)
    haloed, local_frac = _aligned(haloed, 16), _aligned(local_frac, 8)
    g = _aligned(g, 16)
    from f2nerf_tpu_torch.kernels.build import load_library

    lib = load_library("trilinear_bwd_frac")
    fn = lib.trilinear_bwd_frac
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    d_local_frac = torch.empty((n_levels, n, 6), dtype=torch.float32,
                               device=haloed.device)
    with torch.cuda.device(haloed.device):
        stream = torch.cuda.current_stream(haloed.device).cuda_stream
        rc = fn(haloed.data_ptr(), int(haloed.dtype == torch.bfloat16),
                page_idx.data_ptr(), local_frac.data_ptr(), g.data_ptr(),
                d_local_frac.data_ptr(), n, n_levels, width, haloed.shape[0],
                stream)
    if rc != 0:
        raise RuntimeError(f"trilinear_bwd_frac kernel launch failed: CUDA "
                           f"error {rc}")
    trilinear_bwd_frac.launches += 1
    return d_local_frac


# launches of each CUDA kernel in this process (the plain versions on
# the CPU do not count)
trilinear_fwd.launches = 0
trilinear_bwd.launches = 0
trilinear_bwd_frac.launches = 0
