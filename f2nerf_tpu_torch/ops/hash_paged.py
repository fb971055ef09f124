"""Paged multi-level hash-grid encoding (port of
``f2nerf_tpu/ops/hash_paged.py``, with both gradients: the page
gradient for training and the point gradient for pose refinement).

The parameter layout is the JAX package's, unchanged, so converted
parameters and page indices agree exactly:

* the table is stored as **pages** of 4x4x4 cells with C channels,
  ``pages`` [P_total, C, 4, 4, 4];
* the page hash is **additive**, page(Xb, Yb, Zb) = (A*Xb + B*Yb + Zb)
  mod N per level, so the +x/+y/+z block neighbours of page p are pages
  p+A, p+B, p+1 and a **haloed** table (each page extended to 5x5x5)
  is three roll+concat passes; a point's 8 trilinear corners always lie
  inside one haloed page;
* coarse levels whose block grid fits the budget are stored dense.

The haloed table, which only the encode reads, has the port's own
layout: its rows are **slot-major** and lane-padded, [P_total, 128*C]
with page p's row a [128 slots, C] block. Element (slot s, channel c)
sits at column s*C + c, s = 25x + 5y + z over the 5x5x5 haloed cells;
slots 125..127 are zero. A corner's C channels are contiguous, so the
CUDA kernels fetch each corner with one vector load. The JAX package's
rows are channel-major, [C, 128] per page: the two are one transpose of
the last two axes of [P, C, 128] apart.

The encode is :class:`_EncodeCore`, the counterpart of the JAX
``_encode_core`` custom VJP: its forward is one call of the
``trilinear_fwd`` kernel (kernels/trilinear.py), which fuses the
per-level row gather with the trilinear contraction. Its backward calls
``trilinear_bwd`` when the table needs a gradient (training), which
writes the gradient of the haloed table with the page reduction fused in
(deterministic, no float atomics), and ``trilinear_bwd_frac`` when the
points do (localizer modes 1/2), which writes the gradient of the
trilinear fractions; a frozen table pays for no page gradient. The
transpose of the halo (``halo_pages``' rolls and concatenations) and the
path from points to fractions (:func:`page_indices`) are left to
autograd, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from f2nerf_tpu_torch.kernels.trilinear import (ROW_PAD, trilinear_bwd,
                                                trilinear_bwd_frac,
                                                trilinear_fwd)

BLOCK = 4            # cells per page axis
HALO = BLOCK + 1     # haloed page axis
PAGE_CELLS = HALO * HALO * HALO   # 125 haloed cells, lane-padded to ROW_PAD
_U32 = 0xFFFFFFFF


class PagedMeta(NamedTuple):
    """Static per-level constants for the paged encode."""
    n_levels: int
    n_channels: int
    n_pages: tuple[int, ...]       # pages per level
    page_offset: tuple[int, ...]   # cumulative offsets into the page table
    a: np.ndarray                  # [L] uint32 additive x constant
    b: np.ndarray                  # [L] uint32 additive y constant
    dense: tuple[bool, ...]        # level stored dense (no collisions)
    scales: np.ndarray             # [L] float32 resolution multipliers
    biases: np.ndarray             # [L, 3] float32 anchors

    @property
    def total_pages(self) -> int:
        return self.page_offset[-1] + self.n_pages[-1]


def make_paged_meta(n_levels: int, table_size: int, n_channels: int,
                    scales: np.ndarray, np_seed: int = 2022) -> PagedMeta:
    """Per-level page layout; the same ``default_rng(np_seed + 7)`` draws
    as the JAX package, so the constants are identical.

    Pages per level = min(res_blocks^3, table_size / BLOCK^3): coarse
    levels are dense (A = res^2, B = res), finer ones hash with random
    odd A, B.
    """
    rng = np.random.default_rng(np_seed + 7)
    max_pages = max(table_size // (BLOCK ** 3), 1)
    n_pages, offsets, a_c, b_c, dense, biases = [], [], [], [], [], []
    off = 0
    for lvl in range(n_levels):
        res_blocks = int(np.ceil(4.0 * float(scales[lvl]) / BLOCK)) + 1
        if res_blocks ** 3 <= max_pages:
            n_p = res_blocks ** 3
            a_c.append(res_blocks * res_blocks)
            b_c.append(res_blocks)
            dense.append(True)
            biases.append(np.full(3, 2.0 * float(scales[lvl]),
                                  dtype=np.float32))
        else:
            n_p = max_pages
            a_c.append(int(rng.integers(1 << 20, 1 << 31)) | 1)
            b_c.append(int(rng.integers(1 << 20, 1 << 31)) | 1)
            dense.append(False)
            biases.append(
                rng.uniform(100.0, 1100.0, 3).astype(np.float32))
        n_pages.append(n_p)
        offsets.append(off)
        off += n_p
    return PagedMeta(
        n_levels=n_levels, n_channels=n_channels,
        n_pages=tuple(n_pages), page_offset=tuple(offsets),
        a=np.array(a_c, dtype=np.uint32), b=np.array(b_c, dtype=np.uint32),
        dense=tuple(dense),
        scales=np.asarray(scales, dtype=np.float32),
        biases=np.stack(biases).astype(np.float32))


def init_pages(generator: torch.Generator, meta: PagedMeta,
               device: torch.device) -> torch.Tensor:
    """[P_total, C, 4, 4, 4] feature pages ~ (U*0.2-1)*1e-4 (reference
    src/hash_3d_anchored.cpp:24). ``generator`` lives on ``device``."""
    shape = (meta.total_pages, meta.n_channels, BLOCK, BLOCK, BLOCK)
    u = torch.rand(shape, generator=generator, device=device)
    return (u * 0.2 - 1.0) * 1e-4


def halo_pages(pages: torch.Tensor, meta: PagedMeta) -> torch.Tensor:
    """Materialize the haloed table [P_total, 128 * C], slot-major (see
    the module docstring).

    Three roll+concat passes per level on a channel-last view of the
    pages ([P, 4, 4, 4, C], a view: the first concatenation writes the
    new layout): the +x/+y/+z block neighbour of page p is page p+A /
    p+B / p+1, and each roll moves only the one plane that the halo
    takes from it. The last pass also appends the 3 zero pad slots.
    """
    c = meta.n_channels
    levels = pages.permute(0, 2, 3, 4, 1).split(list(meta.n_pages))
    out = []
    for lvl, t in enumerate(levels):                 # [P, 4, 4, 4, C]
        n_p = meta.n_pages[lvl]
        a = int(meta.a[lvl]) % n_p
        b = int(meta.b[lvl]) % n_p
        hz = torch.cat([t, torch.roll(t[:, :, :, :1], -1, dims=0)], dim=3)
        hy = torch.cat([hz, torch.roll(hz[:, :, :1], -b, dims=0)], dim=2)
        plane = torch.roll(hy[:, :1], -a, dims=0)    # x halo [P, 1, 5, 5, C]
        out.append(torch.cat([
            hy.reshape(n_p, 4 * HALO * HALO, c),
            plane.reshape(n_p, HALO * HALO, c),
            hy.new_zeros((n_p, ROW_PAD - PAGE_CELLS, c))], dim=1))
    return torch.cat(out, dim=0).reshape(meta.total_pages, ROW_PAD * c)


def page_indices(points: torch.Tensor, meta: PagedMeta
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per (level, point): global page index, in-block local cell
    coords and trilinear fractions, level-major.

    The JAX package hashes in ``uint32`` (``raw % n_pages`` wraps mod
    2^32). PyTorch has no ``uint32`` remainder on every device, so the
    hash runs in int64 with each product and the sum masked to 32 bits,
    which gives the same residues.

    Returns (page_idx [L, N] int32, local [L, N, 3] int32 in [0, BLOCK),
    frac [L, N, 3] float32). ``frac`` is differentiable in ``points``
    (d frac / d points = the level's scale; floor's gradient is zero,
    as in JAX).
    """
    dev = points.device
    scales = torch.as_tensor(meta.scales, device=dev)
    biases = torch.as_tensor(meta.biases, device=dev)
    pt = points[None, :, :] * scales[:, None, None] + biases[:, None, :]
    f = torch.floor(pt.detach())
    frac = (pt - f).float()
    ip = f.to(torch.int32)                               # cell coords
    blk = (ip >> 2).to(torch.int64) & _U32               # as uint32
    local = ip & (BLOCK - 1)

    a = torch.as_tensor(meta.a.astype(np.int64), device=dev)[:, None]
    b = torch.as_tensor(meta.b.astype(np.int64), device=dev)[:, None]
    n_pages = torch.as_tensor(np.array(meta.n_pages, dtype=np.int64),
                              device=dev)[:, None]
    raw = (((blk[..., 0] * a) & _U32) + ((blk[..., 1] * b) & _U32)
           + blk[..., 2]) & _U32
    page = raw % n_pages
    offs = torch.as_tensor(np.array(meta.page_offset, dtype=np.int64),
                           device=dev)[:, None]
    return (page + offs).to(torch.int32), local, frac


def axis_weights(local: torch.Tensor, frac: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-axis trilinear weights of the 5 haloed slots and their
    derivative in the fraction.

    local/frac: [..., 3] -> (w, dw), each [..., 3, 5] f32, with
    w_ax = (1-f)*[s==l] + f*[s==l+1] and dw_ax = [s==l+1] - [s==l]
    (the one-hot form: at f == 0 the derivative is still -1 / +1).
    """
    s5 = torch.arange(HALO, dtype=torch.int32, device=local.device)
    at_l = s5 == local[..., None]
    at_next = s5 == local[..., None] + 1
    fr = frac.float()[..., None]
    zero = torch.zeros((), dtype=torch.float32, device=fr.device)
    w = torch.where(at_l, 1.0 - fr, zero) + torch.where(at_next, fr, zero)
    return w, at_next.float() - at_l.float()


def weight_row(local: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """Trilinear weights as a lane-padded f32 row.

    local/frac: [..., 3] -> [..., 128] where slot s = x*25 + y*5 + z of
    the haloed page gets w = wx[x]*wy[y]*wz[z] (see :func:`axis_weights`).
    """
    w3, _ = axis_weights(local, frac)
    wx, wy, wz = w3[..., 0, :], w3[..., 1, :], w3[..., 2, :]
    w = (wx[..., :, None, None] * wy[..., None, :, None]
         * wz[..., None, None, :])                        # [..., 5, 5, 5]
    w = w.reshape(*w.shape[:-3], PAGE_CELLS)
    return torch.nn.functional.pad(w, (0, ROW_PAD - PAGE_CELLS))


class _EncodeCore(torch.autograd.Function):
    """feat [N, L*C] f32 from haloed [P, 128*C], page_idx [L, N] and
    local_frac [L, N, 6]; differentiable in ``haloed`` (the page
    gradient) and in ``local_frac`` (the point gradient, whose ``local``
    columns get zeros), either or both (JAX ``_encode_core``,
    ``f2nerf_tpu/ops/hash_paged.py:419-528``)."""

    @staticmethod
    def forward(ctx, haloed, page_idx, local_frac, chunk):
        # the table is kept only for the point gradient: the page
        # gradient does not read it
        if ctx.needs_input_grad[2]:
            ctx.save_for_backward(page_idx, local_frac, haloed)
        else:
            ctx.save_for_backward(page_idx, local_frac)
        ctx.n_pages = haloed.shape[0]
        ctx.dtype = haloed.dtype
        ctx.chunk = chunk
        return trilinear_fwd(haloed, page_idx, local_frac, chunk=chunk)

    @staticmethod
    def backward(ctx, g):
        page_idx, local_frac, *haloed = ctx.saved_tensors
        g = g.float().contiguous()
        d_haloed = d_local_frac = None
        if ctx.needs_input_grad[0]:
            # in haloed's dtype, as the JAX backward returns it
            d_haloed = trilinear_bwd(g, page_idx, local_frac, ctx.n_pages,
                                     ctx.dtype, chunk=ctx.chunk)
        if ctx.needs_input_grad[2]:
            d_local_frac = trilinear_bwd_frac(haloed[0], page_idx,
                                              local_frac, g, chunk=ctx.chunk)
        return d_haloed, None, d_local_frac, None


def paged_encode(points: torch.Tensor, pages: torch.Tensor,
                 meta: PagedMeta, compute_dtype=torch.bfloat16,
                 chunk: int = 65536,
                 haloed: torch.Tensor | None = None) -> torch.Tensor:
    """Encode points against the paged hash grid; differentiable in
    ``pages`` (and in ``haloed`` when it is given) and in ``points``.

    Args:
      points: [N, 3] contracted points.
      pages: [P_total, C, 4, 4, 4] canonical feature pages (fp32 master).
      meta: from :func:`make_paged_meta`.
      compute_dtype: dtype of the haloed table.
      chunk: points per chunk of the plain (CPU) versions; the CUDA
        kernels need no chunking, and the output does not depend on it.
      haloed: optional precomputed ``halo_pages(pages, meta)`` in
        ``compute_dtype`` (the localizer builds it once, since its
        params never change while serving).

    Returns:
      [N, L*C] float32 features, channel-minor per level.
    """
    if haloed is None:
        haloed = halo_pages(pages, meta).to(compute_dtype)
    page_idx, local, frac = page_indices(points, meta)
    local_frac = torch.cat([local.float(), frac], dim=-1)   # [L, N, 6]
    return _EncodeCore.apply(haloed, page_idx, local_frac, chunk)
