"""The encode's index (``hash_paged.encode_index``) and the ``page_index``
kernel's wrapper, on the CPU. The kernel itself runs only on the card
(``tests/test_torch_kernels.py``, which takes its point sets from
:func:`index_points`); here:

* ``encode_index`` on the CPU is ``page_indices`` followed by the
  concatenation of local (as floats) and frac, exactly (the point sets
  themselves are held to the JAX package's index in
  ``tests/test_torch_hash.py``);
* ``index_points_grad``, the backward of the kernel's autograd function,
  is bitwise the gradient autograd takes through the plain passes;
* the kernel's autograd function, run on the CPU inside a run-dedup
  encode, gives the plain path's features and point gradient;
* the wrapper's argument check raises on a wrong shape, dtype or layout.

The module imports neither JAX nor the JAX package.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from f2nerf_tpu_torch.core.config import ModelConfig
from f2nerf_tpu_torch.kernels import trilinear
from f2nerf_tpu_torch.models import hash_field
from f2nerf_tpu_torch.ops import hash_paged

# the cells' field (16 levels x 2 channels, 2^19 entries a level: three
# dense levels, then hashed ones) and a tiny one (both levels hashed)
METAS = {"cells": dict(n_levels=16, n_channels=2, log2_table_size=19),
         "tiny": dict(n_levels=2, n_channels=2, log2_table_size=10)}
KINDS = ("random", "edges", "negative", "clamp", "empty", "one", "ragged")


def meta_of(name: str) -> hash_paged.PagedMeta:
    return hash_field.paged_meta(ModelConfig(**METAS[name]))


def index_points(kind: str, meta: hash_paged.PagedMeta, seed: int = 0
                 ) -> torch.Tensor:
    """[N, 3] float32 contracted points of one kind:

    * "random": 4,099 uniform in [-2, 2)^3;
    * "edges": points whose scaled coordinate is a cell or block edge of
      some level, and one float32 ulp either side of it (dyadic points,
      exact edges at the power-of-two scales; 48 cell edges spread over
      each level's range and the block edges nearest them, solved back
      to points), every axis mixed;
    * "negative": 1,031 points in [-2, 0)^3 (negative cell coordinates,
      arithmetic shifts);
    * "clamp": the perspective warp's clamp at +-1.999 on each axis;
    * "empty", "one", "ragged": N of 0, 1 and 1,001 (not a multiple of
      the kernel's 256-point block).
    """
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.rand((4099, 3), generator=g) * 4 - 2
    if kind == "negative":
        return -2 * torch.rand((1031, 3), generator=g)
    if kind == "clamp":
        pts = torch.rand((600, 3), generator=g) * 4 - 2
        for axis in range(3):
            pts[axis * 200:(axis + 1) * 200 - 100, axis] = 1.999
            pts[(axis + 1) * 200 - 100:(axis + 1) * 200, axis] = -1.999
        return pts
    if kind == "empty":
        return torch.empty((0, 3))
    if kind == "one":
        return torch.tensor([[0.25, -1.5, 1.75]])
    if kind == "ragged":
        return torch.rand((1001, 3), generator=g) * 4 - 2
    if kind != "edges":
        raise ValueError(kind)
    vals = [np.arange(-512, 512, dtype=np.float32) / 256]   # dyadic
    for lvl in range(meta.n_levels):
        scale = np.float32(meta.scales[lvl])
        for axis in range(3):
            bias = np.float32(meta.biases[lvl, axis])
            k = np.round(np.linspace(-2.0 * scale + bias, 2.0 * scale + bias,
                                     48))
            k = np.concatenate([k, 4 * np.round(k / 4)])   # cells, blocks
            x = ((k - bias) / np.float64(scale)).astype(np.float32)
            x = x[np.abs(x) < 2]
            vals += [x, np.nextafter(x, np.float32(3)),
                     np.nextafter(x, np.float32(-3))]
    v = np.concatenate(vals).astype(np.float32)
    rng = np.random.default_rng(seed)
    pts = np.stack([v, rng.permutation(v), rng.permutation(v)], axis=1)
    return torch.from_numpy(np.ascontiguousarray(pts))


def test_encode_index_on_the_cpu_is_page_indices_and_the_cat():
    """One case: on the CPU this is the plain version against itself, so
    it can catch only a miswritten concatenation. The point sets are
    held to the JAX package in ``test_torch_hash.py`` and the kernel to
    this plain version in ``test_torch_kernels.py``."""
    meta = meta_of("cells")
    pts = index_points("edges", meta)
    before = trilinear.page_index.launches
    page_idx, local_frac = hash_paged.encode_index(pts, meta)
    pi, local, frac = hash_paged.page_indices(pts, meta)
    assert page_idx.dtype == torch.int32 and local_frac.dtype == torch.float32
    assert local_frac.shape == (meta.n_levels, pts.shape[0], 6)
    assert torch.equal(page_idx, pi)
    assert torch.equal(local_frac, torch.cat([local.float(), frac], dim=-1))
    # the wrapper takes the same plain version for CPU tensors
    consts = hash_paged._meta_tensors(meta, pts.device)
    again = trilinear.page_index(pts, *consts)
    assert torch.equal(again[0], page_idx)
    assert torch.equal(again[1], local_frac)
    assert trilinear.page_index.launches == before    # no kernel here


@pytest.mark.parametrize("name", sorted(METAS))
def test_index_points_grad_is_autograd_of_the_plain_path(name):
    meta = meta_of(name)
    pts = index_points("random", meta, seed=3)
    g = torch.randn((meta.n_levels, pts.shape[0], 6),
                    generator=torch.Generator().manual_seed(4))
    x = pts.clone().requires_grad_(True)
    _, local, frac = hash_paged.page_indices(x, meta)
    lf = torch.cat([local.float(), frac], dim=-1)
    (want,) = torch.autograd.grad(lf, x, g)
    scales = hash_paged._meta_tensors(meta, pts.device)[0]
    got = hash_paged.index_points_grad(g, scales)
    assert got.shape == pts.shape
    assert torch.equal(got, want)


def test_index_function_on_the_cpu_is_the_plain_path():
    """The kernel's autograd function, run on the CPU (where its forward
    is the plain version), inside a run-dedup encode: the same features
    and point gradient as the plain path, whose page_idx the dedup
    rewrites in place all the same."""
    meta = meta_of("tiny")
    budgets = (8, 8)
    g = torch.Generator().manual_seed(6)
    pages = torch.rand((meta.total_pages, 2, 4, 4, 4), generator=g) * 2 - 1
    t = torch.cumsum(0.5 + torch.rand((16, 24, 1), generator=g), dim=1)
    pts = ((torch.rand((16, 1, 3), generator=g) - 0.5)
           + t * 0.05 * torch.randn((16, 1, 3), generator=g)).clamp(-1.9, 1.9)
    cot = torch.randn((16, 24, 4), generator=g)

    def through_function(points, m):
        consts = hash_paged._meta_tensors(m, points.device)
        return hash_paged._IndexGrad.apply(points, *consts)

    outs = []
    for fn in (through_function, hash_paged.encode_index):
        x = pts.clone().requires_grad_(True)
        with mock.patch.object(hash_paged, "encode_index", fn):
            feat = hash_paged.paged_encode_rays(x, pages, meta, budgets,
                                                compute_dtype=torch.float32)
        (feat * cot).sum().backward()
        outs.append((feat.detach(), x.grad))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _consts(meta):
    return list(hash_paged._meta_tensors(meta, torch.device("cpu")))


BAD = {
    "points_2d": lambda p, c: (p[:, :2].contiguous(), c),
    "points_1d": lambda p, c: (p.reshape(-1), c),
    "points_f64": lambda p, c: (p.double(), c),
    "points_strided": lambda p, c: (p.t().contiguous().t(), c),
    "scales_f64": lambda p, c: (p, [c[0].double(), *c[1:]]),
    "biases_shape": lambda p, c: (p, [c[0], c[1][:, :2].contiguous(),
                                      *c[2:]]),
    "ints_int32": lambda p, c: (p, [*c[:2], c[2].int(), *c[3:]]),
    "ints_short": lambda p, c: (p, [*c[:5], c[5][:-1].contiguous()]),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_page_index_check_rejects(bad):
    meta = meta_of("tiny")
    pts = index_points("ragged", meta)
    consts = _consts(meta)
    trilinear._check_page_index(pts, *consts)          # the good case
    p, c = BAD[bad](pts, consts)
    with pytest.raises(ValueError):
        trilinear._check_page_index(p, *c)
    with pytest.raises(ValueError):
        trilinear.page_index(p, *c)

