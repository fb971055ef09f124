"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA device (the check runs inside a fixture,
not at import). The module imports neither JAX nor the JAX package, so
on the machine with the card it runs without them:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances:
* trilinear_fwd: atol 1e-5 in f32 and in bf16 (rows are widened to f32
  and weighted in f32 on both sides; only the order of the 8-term sums
  differs);
* trilinear_bwd in f32: 1e-5 x the sum of the magnitudes of each cell's
  terms (the same f32 terms summed in another order, and the kernel's
  hat-form weights differ from the plain one-hot form by an ulp);
  in bf16 one bf16 rounding of the sum more (2^-8 of it). Two launches
  on the same inputs are bitwise equal.
* trilinear_bwd_frac in f32 and bf16: 1e-5 x the sum of the magnitudes
  of each output's terms (rows widened to f32 and g kept in f32 on both
  sides; only the order of the f32 sums differs). Two launches on the
  same inputs are bitwise equal.

The ``*_matches_plain`` shapes cover the edges of the kernels' launch
shape: a block is 32 points x all L levels, warp = level (levels stride
over at most 8 warps), and the block's [32, L*C] slice of feat / g
moves through shared memory; so N runs ragged around 32 at L = 8, L
runs below, at and above 8 at one N, and every C and table type is
taken at each. ``trilinear_bwd`` gives each tile of 256 page-sorted
entries to one warp (lane = corner x channel: 8, 16 or 32 lanes at
C = 1, 2, 4, two channels a lane at C = 8) and merges the runs that
cross tile edges, so its shapes put M = N*L at the tile edges, give one
entry, long runs and one run through every tile, at every C and L in
{1, 3, 8, 16}. The in-situ cases run the kernels on the page indices
of real renders at the full ``Config()`` width
(``chip_smoke.in_situ_inputs``), whose rays make neighbouring lanes
gather from neighbouring cells, and ``trilinear_bwd`` on one training
step's (``chip_smoke.train_step_inputs``); the ``*_in_situ_warp`` cases
run them on the inputs of the perspective-warp paths (a full-frame
render at a corridor view, ``chip_smoke.warp_frame_inputs``, and a warp
training step, ``chip_smoke.warp_train_inputs``). C = 3, which the kernels are
not built for, runs through the wrappers' zero-padding to C = 4.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from f2nerf_tpu_torch.core.config import Config, ModelConfig
from f2nerf_tpu_torch.kernels import trilinear
from f2nerf_tpu_torch.models import hash_field
from f2nerf_tpu_torch.ops import hash_paged

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cfg, n, dtype, device, seed=0):
    meta = hash_field.paged_meta(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    pages = torch.rand((meta.total_pages, cfg.n_channels, 4, 4, 4),
                       generator=g, device=device) * 2 - 1
    haloed = hash_paged.halo_pages(pages, meta).to(dtype)
    pts = torch.rand((n, 3), generator=g, device=device) * 4 - 2
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    return haloed, page_idx, torch.cat([local.float(), frac], dim=-1)


# (N, L): ragged N at L = 8, then L around the 8 warps of a block
SHAPES = [(1, 8), (31, 8), (33, 8), (1001, 8), (65537, 8), (1001, 1),
          (1001, 3), (1001, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,levels", SHAPES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 8])
def test_trilinear_fwd_matches_plain(cuda, dtype, n, levels, channels):
    cfg = ModelConfig(n_levels=levels, n_channels=channels,
                      log2_table_size=14)
    haloed, page_idx, lf = _inputs(cfg, n, dtype, cuda, seed=n + levels)
    before = trilinear.trilinear_fwd.launches
    out = trilinear.trilinear_fwd(haloed, page_idx, lf)
    torch.cuda.synchronize()
    assert trilinear.trilinear_fwd.launches == before + 1
    ref = trilinear.trilinear_fwd_ref(haloed, page_idx, lf, chunk=4096)
    assert out.shape == ref.shape == (n, levels * channels)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    # and the plain version on the CPU gives the same numbers
    cpu = trilinear.trilinear_fwd(haloed.cpu(), page_idx.cpu(), lf.cpu())
    np.testing.assert_allclose(out.cpu().numpy(), cpu.numpy(), atol=1e-5)


def test_trilinear_fwd_rejects_bad_inputs(cuda):
    cfg = ModelConfig(n_levels=2, n_channels=4, log2_table_size=12)
    haloed, page_idx, lf = _inputs(cfg, 100, torch.float32, cuda)
    with pytest.raises(ValueError):
        trilinear.trilinear_fwd(haloed.half(), page_idx, lf)
    with pytest.raises(ValueError):
        trilinear.trilinear_fwd(haloed, page_idx.long(), lf)
    with pytest.raises(ValueError):
        trilinear.trilinear_fwd(haloed, page_idx[:, ::2],
                                lf[:, ::2].contiguous())
    with pytest.raises(ValueError):
        trilinear.trilinear_fwd(haloed, page_idx.cpu(), lf)
    # L*C beyond the block's shared tile
    wide = ModelConfig(n_levels=64, n_channels=8, log2_table_size=12)
    haloed, page_idx, lf = _inputs(wide, 10, torch.float32, cuda)
    with pytest.raises(ValueError, match="L\\*C"):
        trilinear.trilinear_fwd(haloed, page_idx, lf)


def _shifted(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` that starts one element into a larger buffer, so
    its data is not 8 B-aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def test_unaligned_inputs(cuda):
    """Views whose data are not aligned for the kernels' vector loads
    give the same results."""
    cfg = ModelConfig(n_levels=8, n_channels=4, log2_table_size=12)
    haloed, page_idx, lf, grad = _frac_inputs(cfg, 1000, torch.bfloat16,
                                              cuda)
    args = [_shifted(t) for t in (haloed, page_idx, lf, grad)]
    assert all(t.data_ptr() % 8 for t in args)
    torch.testing.assert_close(
        trilinear.trilinear_fwd(*args[:3]),
        trilinear.trilinear_fwd(haloed, page_idx, lf), rtol=0, atol=0)
    torch.testing.assert_close(
        trilinear.trilinear_bwd_frac(*args),
        trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad),
        rtol=0, atol=0)
    n_pages = haloed.shape[0]
    assert torch.equal(
        trilinear.trilinear_bwd(args[3], *args[1:3], n_pages),
        trilinear.trilinear_bwd(grad, page_idx, lf, n_pages))


def _bwd_inputs(cfg, n, device, seed=0, kind="uniform"):
    meta = hash_field.paged_meta(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    pts = torch.rand((n, 3), generator=g, device=device) * 4 - 2
    if kind == "skew":     # most points in one coarse cell: long page runs
        pts[: n // 2] = pts[: n // 2] * 1e-3 + 0.01
    page_idx, local, frac = hash_paged.page_indices(pts, meta)
    if kind == "one_page":  # one run through every tile
        page_idx.fill_(meta.total_pages // 2)
    lf = torch.cat([local.float(), frac], dim=-1)
    grad = torch.randn((n, cfg.n_levels * cfg.n_channels), generator=g,
                       device=device)
    return grad, page_idx, lf, meta.total_pages


def _check_bwd(grad, page_idx, lf, n_pages, dtype, chunk=4096):
    """trilinear_bwd against its plain version (1e-5 x each cell's term
    magnitudes, plus 2^-8 of the value in bf16), one launch counted, two
    launches bitwise equal; returns the output and the tolerance."""
    before = trilinear.trilinear_bwd.launches
    out = trilinear.trilinear_bwd(grad, page_idx, lf, n_pages, dtype)
    torch.cuda.synchronize()
    assert trilinear.trilinear_bwd.launches == before + 1
    c = grad.shape[1] // page_idx.shape[0]
    assert out.dtype == dtype and out.shape == (n_pages, c * 128)
    ref = trilinear.trilinear_bwd_ref(grad, page_idx, lf, n_pages,
                                      chunk=chunk)
    mag = trilinear.trilinear_bwd_ref(grad.abs(), page_idx, lf, n_pages,
                                      chunk=chunk)
    tol = 1e-5 * mag + (2.0 ** -8 * ref.abs() if dtype == torch.bfloat16
                        else 0.0)
    assert bool(((out.float() - ref).abs() <= tol + 1e-30).all())
    again = trilinear.trilinear_bwd(grad, page_idx, lf, n_pages, dtype)
    assert torch.equal(out, again)
    return out, tol


# (N, L, points): M = N*L at the 256-entry tile edges (255, 256, 513),
# one entry (a run of length 1), L in {1, 3, 8, 16}, long runs (skew) and
# one page for every entry (one run through all 64 tiles)
BWD_SHAPES = [(1, 1, "uniform"), (85, 3, "uniform"), (32, 8, "uniform"),
              (171, 3, "uniform"), (1001, 1, "uniform"),
              (1001, 8, "uniform"), (4097, 16, "uniform"),
              (65537, 8, "uniform"), (65537, 8, "skew"),
              (2048, 8, "one_page")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,levels,kind", BWD_SHAPES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 8])
def test_trilinear_bwd_matches_plain(cuda, dtype, n, levels, kind, channels):
    cfg = ModelConfig(n_levels=levels, n_channels=channels,
                      log2_table_size=14)
    grad, page_idx, lf, n_pages = _bwd_inputs(cfg, n, cuda, seed=n + levels,
                                              kind=kind)
    out, tol = _check_bwd(grad, page_idx, lf, n_pages, dtype)
    # and the plain version on the CPU gives the same numbers
    cpu = trilinear.trilinear_bwd(grad.cpu(), page_idx.cpu(), lf.cpu(),
                                  n_pages)
    assert bool(((out.float().cpu() - cpu).abs() <= tol.cpu() + 1e-6).all())


def test_trilinear_bwd_rejects_bad_inputs(cuda):
    cfg = ModelConfig(n_levels=2, n_channels=4, log2_table_size=12)
    grad, page_idx, lf, n_pages = _bwd_inputs(cfg, 100, cuda)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd(grad.half(), page_idx, lf, n_pages)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd(grad, page_idx.long(), lf, n_pages)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd(grad, page_idx, lf, n_pages, torch.float16)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd(grad[:, ::2], page_idx, lf, n_pages)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd(grad, page_idx.cpu(), lf, n_pages)


def test_encode_gradient_on_the_card(cuda):
    """The whole encode backward (kernel + halo transpose) on the card
    against the CPU, and deterministic."""
    cfg = ModelConfig(n_levels=8, n_channels=4, log2_table_size=14)
    meta = hash_field.paged_meta(cfg)
    g = torch.Generator().manual_seed(3)
    pages = torch.rand((meta.total_pages, 4, 4, 4, 4), generator=g) * 2 - 1
    pts = torch.rand((20000, 3), generator=g) * 4 - 2
    cot = torch.randn((20000, 32), generator=g)
    grads = []
    for dev in (cuda, cuda, torch.device("cpu")):
        p = pages.to(dev).requires_grad_(True)
        feat = hash_paged.paged_encode(pts.to(dev), p, meta,
                                       compute_dtype=torch.float32)
        (feat * cot.to(dev)).sum().backward()
        grads.append(p.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    scale = float(grads[2].abs().max())
    torch.testing.assert_close(grads[0], grads[2], rtol=0,
                               atol=1e-5 * scale)


def _frac_inputs(cfg, n, dtype, device, seed=0):
    haloed, page_idx, lf = _inputs(cfg, n, dtype, device, seed)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    grad = torch.randn((n, cfg.n_levels * cfg.n_channels), generator=g,
                       device=device)
    return haloed, page_idx, lf, grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,levels", SHAPES)
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 8])
def test_trilinear_bwd_frac_matches_plain(cuda, dtype, n, levels, channels):
    cfg = ModelConfig(n_levels=levels, n_channels=channels,
                      log2_table_size=14)
    haloed, page_idx, lf, grad = _frac_inputs(cfg, n, dtype, cuda,
                                              seed=n + levels)
    before = trilinear.trilinear_bwd_frac.launches
    out = trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad)
    torch.cuda.synchronize()
    assert trilinear.trilinear_bwd_frac.launches == before + 1
    assert out.shape == (levels, n, 6) and out.dtype == torch.float32
    assert float(out[..., :3].abs().max()) == 0.0
    ref = trilinear.trilinear_bwd_frac_ref(haloed, page_idx, lf, grad,
                                           chunk=4096)
    mag = trilinear.trilinear_bwd_frac_ref(haloed, page_idx, lf, grad,
                                           chunk=4096, magnitudes=True)
    assert bool(((out - ref).abs() <= 1e-5 * mag + 1e-30).all())
    again = trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad)
    assert torch.equal(out, again)
    # and the plain version on the CPU gives the same numbers
    cpu = trilinear.trilinear_bwd_frac(haloed.cpu(), page_idx.cpu(),
                                       lf.cpu(), grad.cpu())
    assert bool(((out.cpu() - cpu).abs() <= 1e-5 * mag.cpu() + 1e-6).all())


def test_trilinear_bwd_frac_rejects_bad_inputs(cuda):
    cfg = ModelConfig(n_levels=2, n_channels=4, log2_table_size=12)
    haloed, page_idx, lf, grad = _frac_inputs(cfg, 100, torch.float32, cuda)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd_frac(haloed.half(), page_idx, lf, grad)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd_frac(haloed, page_idx.long(), lf, grad)
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad.double())
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad[:, :-1])
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd_frac(haloed, page_idx, lf,
                                     grad.t().contiguous().t())
    with pytest.raises(ValueError):
        trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad.cpu())
    wide = ModelConfig(n_levels=64, n_channels=8, log2_table_size=12)
    haloed, page_idx, lf, grad = _frac_inputs(wide, 10, torch.float32, cuda)
    with pytest.raises(ValueError, match="L\\*C"):
        trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad)


def _check_frac(haloed, page_idx, lf, grad):
    """trilinear_bwd_frac against its plain version at 1e-5 of each
    output's term magnitudes, zero local columns, two launches equal."""
    out = trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad)
    again = trilinear.trilinear_bwd_frac(haloed, page_idx, lf, grad)
    torch.cuda.synchronize()
    assert out.shape == (*page_idx.shape, 6)
    assert torch.equal(out, again)
    assert float(out[..., :3].abs().max()) == 0.0
    ref = trilinear.trilinear_bwd_frac_ref(haloed, page_idx, lf, grad)
    mag = trilinear.trilinear_bwd_frac_ref(haloed, page_idx, lf, grad,
                                           magnitudes=True)
    assert bool(((out - ref).abs() <= 1e-5 * mag + 1e-30).all())


@pytest.fixture(scope="module")
def chip_smoke(cuda):
    """``chip_smoke.py``, loaded by path."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def in_situ(chip_smoke, cuda):
    """``chip_smoke.in_situ_inputs``: the page indices and fractions of
    one full-frame render at the serve pose ("frame") and of one mode-0
    particle render ("particles") at the full ``Config()`` width."""
    return chip_smoke.in_situ_inputs(Config(), 0, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trilinear_bwd_in_situ(chip_smoke, cuda, dtype):
    """The 4.19 M (point, level) pairs of one training step at
    ``bench.py``'s operating point (``chip_smoke.train_step_inputs``),
    with its seeded O(1) cotangent."""
    cfg = chip_smoke.train_cfg(chip_smoke.TRAIN_RAYS)
    grad, page_idx, lf, meta = chip_smoke.train_step_inputs(cfg, 0, cuda)
    _check_bwd(grad, page_idx, lf, meta.total_pages, dtype, chunk=65536)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["frame", "particles"])
def test_trilinear_fwd_in_situ(in_situ, name, dtype):
    haloed, page_idx, lf = in_situ[name]
    haloed = haloed.to(dtype)
    out = trilinear.trilinear_fwd(haloed, page_idx, lf)
    torch.cuda.synchronize()
    ref = trilinear.trilinear_fwd_ref(haloed, page_idx, lf)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trilinear_bwd_frac_in_situ(in_situ, dtype):
    haloed, page_idx, lf = in_situ["frame"]
    grad = torch.randn((page_idx.shape[1], 32), device=lf.device,
                       generator=torch.Generator(lf.device).manual_seed(5))
    _check_frac(haloed.to(dtype), page_idx, lf, grad)


@pytest.fixture(scope="module")
def warp_frame(chip_smoke, cuda):
    """``chip_smoke.warp_frame_inputs``: the page indices and fractions
    of one full-frame render through the perspective warp at a corridor
    view, at the full ``Config()`` width."""
    return chip_smoke.warp_frame_inputs(0, cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trilinear_fwd_in_situ_warp(warp_frame, dtype):
    haloed, page_idx, lf = warp_frame
    haloed = haloed.to(dtype)
    out = trilinear.trilinear_fwd(haloed, page_idx, lf)
    torch.cuda.synchronize()
    ref = trilinear.trilinear_fwd_ref(haloed, page_idx, lf)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trilinear_bwd_frac_in_situ_warp(warp_frame, dtype):
    haloed, page_idx, lf = warp_frame
    grad = torch.randn((page_idx.shape[1], 32), device=lf.device,
                       generator=torch.Generator(lf.device).manual_seed(6))
    _check_frac(haloed.to(dtype), page_idx, lf, grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trilinear_bwd_in_situ_warp(chip_smoke, cuda, dtype):
    """The pairs of one warp training step at ``bench.py --warp
    perspective``'s point (``chip_smoke.warp_train_inputs``)."""
    grad, page_idx, lf, meta = chip_smoke.warp_train_inputs(0, cuda)
    _check_bwd(grad, page_idx, lf, meta.total_pages, dtype, chunk=65536)


def test_encode_point_gradient_on_the_card(cuda):
    """The encode's point gradient (kernel + the frac path) on the card
    against the CPU, deterministic, and with the page gradient asked for
    too. Tolerance 1e-4 x the largest entry: the finest scale (1024)
    multiplies each level's f32 sums, and CUDA and the CPU may round the
    scaled point a cell apart for a point on an edge."""
    cfg = ModelConfig(n_levels=8, n_channels=4, log2_table_size=14)
    meta = hash_field.paged_meta(cfg)
    g = torch.Generator().manual_seed(4)
    pages = torch.rand((meta.total_pages, 4, 4, 4, 4), generator=g) * 2 - 1
    pts = torch.rand((20000, 3), generator=g) * 4 - 2
    cot = torch.randn((20000, 32), generator=g)
    grads = []
    for dev, pages_grad in ((cuda, False), (cuda, False), (cuda, True),
                            (torch.device("cpu"), False)):
        x = pts.to(dev).requires_grad_(True)
        p = pages.to(dev).requires_grad_(pages_grad)
        before = trilinear.trilinear_bwd.launches
        feat = hash_paged.paged_encode(x, p, meta, compute_dtype=torch.float32)
        (feat * cot.to(dev)).sum().backward()
        assert trilinear.trilinear_bwd.launches == before + (
            pages_grad and dev.type == "cuda")
        grads.append(x.grad.cpu())
    assert torch.equal(grads[0], grads[1])
    assert torch.equal(grads[0], grads[2])
    scale = float(grads[3].abs().max())
    torch.testing.assert_close(grads[0], grads[3], rtol=0,
                               atol=1e-4 * scale)


def _ray_samples(n_rays, n_samples, march, generator, device):
    """[R, S, 3] points along straight rays from the centre region, t
    monotone with jittered steps (the samplers' contract), clipped to the
    contracted cube."""
    o = (torch.rand((n_rays, 1, 3), generator=generator) - 0.5) * 0.8
    d = torch.randn((n_rays, 1, 3), generator=generator)
    d = d / d.norm(dim=-1, keepdim=True)
    step = 0.5 + torch.rand((n_rays, n_samples, 1), generator=generator)
    t = torch.cumsum(step, dim=1) * (march / n_samples)
    return (o + d * t).clamp(-1.98, 1.98).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dedup_encode_bitwise_flat_on_the_card(cuda, dtype):
    """Run dedup at ``Config()``'s budgets on 2,048 rays of 64 samples:
    features, page gradient and point gradient bitwise the flat encode's
    on the card (no run id clamps: the run counts are checked within
    their budgets), and the kernels launched in both."""
    cfg = Config().model
    budgets = hash_field.ray_budgets(cfg)
    meta = hash_field.paged_meta(cfg)
    g = torch.Generator().manual_seed(5)
    pages = (torch.rand((meta.total_pages, 4, 4, 4, 4), generator=g) * 2
             - 1).to(cuda)
    pts = _ray_samples(2048, 64, 64 / 256, g, cuda)
    cot = torch.randn((2048, 64, 32), generator=g).to(cuda)
    outs = []
    for dedup in (True, False):
        x = pts.clone().requires_grad_(True)
        p = pages.clone().requires_grad_(True)
        before = (trilinear.trilinear_fwd.launches,
                  trilinear.trilinear_bwd.launches,
                  trilinear.trilinear_bwd_frac.launches)
        with hash_paged.recording_runs() as runs:
            if dedup:
                feat = hash_paged.paged_encode_rays(x, p, meta, budgets,
                                                    compute_dtype=dtype)
            else:
                feat = hash_paged.paged_encode(
                    x.reshape(-1, 3), p, meta,
                    compute_dtype=dtype).reshape(2048, 64, -1)
        (feat * cot).sum().backward()
        after = (trilinear.trilinear_fwd.launches,
                 trilinear.trilinear_bwd.launches,
                 trilinear.trilinear_bwd_frac.launches)
        assert all(a == b + 1 for a, b in zip(after, before))
        assert len(runs) == (sum(map(bool, budgets)) if dedup else 0)
        for e in runs:
            assert 1 <= int(e["runs"]) <= e["budget"], e
        outs.append((feat.detach(), p.grad, x.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
