"""The frame's resize on the card: the CUDA kernel ``resize_aa``
(``csrc/resize_aa.cu``), its plain PyTorch version and its wrapper.

``utils/image_io.resize_image`` is the specification, and the CPU path
and the offline tools keep calling it: numpy quantizes the float32
[H, W, C] frame to uint8 (``* 255``, ``+ 0.5``, clip, truncate), ATen's
CPU antialiased bilinear filter shrinks it (a separable sum over each
output's taps, along the width into a float32 intermediate, then along
the height), and the result is rounded half to even and divided by 255.
The kernel does all of it in one launch and gives the same float32
values, bit for bit. What that needs of ATen is read from ATen itself,
once per pair of frame sizes (:func:`frame_taps`), so it holds for the
CPU path of whichever machine runs it:

* each output's taps: the filter run on a NaN diagonal marks every
  input that ATen sums for the output, zero weights at the ends
  included (the count of taps decides the rounding below);
* their weights: the filter run on an identity (row r of the result is
  input r's weight for each output, exactly: 1 x w adds nothing to w);
* how each tap rounds. ATen sums ``out = x_0 * w_0``, then ``out +=
  x_j * w_j`` in index order. Its default build rounds each product and
  each add; its AVX2 and AVX-512 builds unroll that loop by four and
  fuse the multiply and add of the taps left over (one rounding). Each
  output keeps ``plain``: taps 1 .. plain round twice, later taps are
  one fused multiply-add. For each count of taps, ``plain`` is the
  split whose sums equal ATen's own on a seeded random frame of the
  same shape, passed to ``F.interpolate`` as ``resize_image`` passes it.

The plain version :func:`resize_aa_ref` repeats the kernel's arithmetic
on the CPU: a rounded tap as two float32 operations, a fused one in
float64, which holds the product exactly and so rounds once but for a
tie of the two roundings (about one tap in 2^29). The wrapper
:func:`resize_aa` takes it only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

# outputs per pass whose sums the split is chosen on (the first rows of
# the width pass, the first columns of the height pass)
_SAMPLE = 64

Taps = tuple[torch.Tensor, torch.Tensor]
"""One axis: [3, n_out] int32 (first tap, count of taps, ``plain``) and
the weights [n_out, K] float32, zero past each output's count."""


def _aten(frame: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """ATen's filter on a [H, W, C] frame as ``resize_image`` calls it:
    a channels-last view of the frame, converted to float32."""
    x = frame.permute(2, 0, 1)[None].float()
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=True)[0].permute(
                             1, 2, 0)


def _axis(n_in: int, n_out: int) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """(first [n_out], count [n_out], weights [n_out, K]) of ATen's filter
    from ``n_in`` to ``n_out`` samples."""
    def filt(x):
        return F.interpolate(x[None, None], size=(n_in, n_out),
                             mode="bilinear", align_corners=False,
                             antialias=True)[0, 0]

    weight = filt(torch.eye(n_in))                          # [n_in, n_out]
    taps = filt(torch.diag(torch.full((n_in,), math.nan))).isnan()
    first, count = taps.int().argmax(0), taps.sum(0)
    k = int(count.max())
    idx = (first[:, None] + torch.arange(k)).clamp(max=n_in - 1)
    live = torch.arange(k) < count[:, None]
    return first, count, torch.where(live, weight.T.gather(1, idx), 0.0)


def _sum_taps(x: torch.Tensor, index: torch.Tensor,
              weight: torch.Tensor) -> torch.Tensor:
    """ATen's sums along dim 0 of ``x`` [n_in, ...] -> [n_out, ...], each
    tap rounded as ``index``'s ``plain`` says."""
    first, count, plain = index.long()
    k = weight.shape[1]
    idx = (first[:, None] + torch.arange(k)).clamp(max=x.shape[0] - 1)
    shape = (-1,) + (1,) * (x.dim() - 1)
    acc = x[idx[:, 0]] * weight[:, 0].view(shape)
    for j in range(1, k):
        xj, wj = x[idx[:, j]], weight[:, j].view(shape)
        fused = (acc.double() + xj.double() * wj.double()).float()
        step = torch.where((j > plain).view(shape), fused, acc + xj * wj)
        acc = torch.where((j < count).view(shape), step, acc)
    return acc


def _split(x: torch.Tensor, aten: torch.Tensor, first: torch.Tensor,
           count: torch.Tensor, weight: torch.Tensor) -> Taps:
    """The axis's taps with ``plain`` chosen per count of taps: the split
    whose sums of ``x`` miss the fewest of ATen's ``aten``, the latest
    one (every tap rounded twice) among equals."""
    k = weight.shape[1]
    misses = []
    for p in range(k):
        index = torch.stack([first, count, torch.full_like(count, p)])
        misses.append((_sum_taps(x, index, weight) != aten).flatten(1)
                      .sum(1))
    misses = torch.stack(misses)                            # [k, n_out]
    plain = torch.empty_like(count)
    for n in count.unique().tolist():
        per = misses[:, count == n].sum(1).tolist()
        best = min(range(k), key=lambda p: (per[p], -p))
        plain[count == n] = min(best, n - 1)
    return torch.stack([first, count, plain]).int(), weight


@functools.cache
def frame_taps(h_in: int, w_in: int, channels: int, h: int,
               w: int) -> tuple[Taps, Taps]:
    """(rows, columns) of the resize of a [h_in, w_in, channels] frame to
    [h, w], on the CPU; cached for the life of the process, one entry per
    pair of frame sizes."""
    g = torch.Generator().manual_seed(0)
    # the width pass alone on a quantized frame, then the height pass
    # alone on float32 intermediates, each at the shape resize_image
    # hands it
    q = torch.randint(0, 256, (h_in, w_in, channels), dtype=torch.uint8,
                      generator=g)
    cols = _split(q[:_SAMPLE].float().transpose(0, 1),
                  _aten(q, h_in, w)[:_SAMPLE].transpose(0, 1), *_axis(w_in, w))
    mid = torch.rand((h_in, w, channels), generator=g) * 255
    rows = _split(mid[:, :_SAMPLE], _aten(mid, h, w)[:, :_SAMPLE],
                  *_axis(h_in, h))
    return rows, cols


@functools.cache
def _frame_taps_on(device: torch.device, *sizes: int) -> tuple[Taps, Taps]:
    return tuple(tuple(t.to(device) for t in axis)
                 for axis in frame_taps(*sizes))


def resize_aa_ref(frame: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Plain version: the kernel's arithmetic on the CPU, float32 [H, W, C]
    -> [h, w, C]."""
    rows, cols = frame_taps(*frame.shape[:2], frame.shape[2], h, w)
    q = torch.clamp(frame * 255 + 0.5, 0, 255).trunc()
    mid = _sum_taps(q.transpose(0, 1), *cols).transpose(0, 1)
    return torch.clamp(torch.round(_sum_taps(mid, *rows)), 0, 255) / 255


def resize_aa(frame: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``resize_image`` of a float32 [H, W, C] frame to [h, w, C]: the
    kernel for a CUDA tensor, the plain version for a CPU one."""
    if frame.dim() != 3 or frame.dtype != torch.float32:
        raise ValueError(f"frame must be float32 [H, W, C], got "
                         f"{frame.dtype} {tuple(frame.shape)}")
    if frame.device.type == "cpu":
        return resize_aa_ref(frame, h, w)
    if frame.device.type != "cuda":
        raise ValueError(f"resize_aa runs on CPU or CUDA tensors, got "
                         f"{frame.device}")
    frame, h, w = frame.contiguous(), int(h), int(w)
    h_in, w_in, c = frame.shape
    (rows, row_w), (cols, col_w) = _frame_taps_on(frame.device, h_in, w_in,
                                                  c, h, w)
    from f2nerf_tpu_torch.kernels.build import load_library

    fn = load_library("resize_aa").resize_aa
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((h, w, c), dtype=torch.float32, device=frame.device)
    with torch.cuda.device(frame.device):
        stream = torch.cuda.current_stream(frame.device).cuda_stream
        rc = fn(frame.data_ptr(), w_in, c, rows.data_ptr(), row_w.data_ptr(),
                row_w.shape[1], h, cols.data_ptr(), col_w.data_ptr(),
                col_w.shape[1], w, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"resize_aa kernel launch failed: CUDA error {rc}")
    resize_aa.launches += 1
    return out


resize_aa.launches = 0
