"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA device (the check runs inside a fixture,
not at import). The module imports neither JAX nor the JAX package, so
on the machine with the card it runs without them:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerance: atol 1e-5 in f32 and in bf16 (rows are widened to f32 and
weighted in f32 on both sides; only the order of the 8-term sums
differs).
"""

import numpy as np
import pytest
import torch

from f2nerf_tpu_torch.core.config import ModelConfig
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 1001, 65537])
@pytest.mark.parametrize("channels", [2, 4])
def test_trilinear_fwd_matches_plain(cuda, dtype, n, channels):
    cfg = ModelConfig(n_levels=8, n_channels=channels, log2_table_size=14)
    haloed, page_idx, lf = _inputs(cfg, n, dtype, cuda)
    before = trilinear.trilinear_fwd.launches
    out = trilinear.trilinear_fwd(haloed, page_idx, lf)
    torch.cuda.synchronize()
    assert trilinear.trilinear_fwd.launches == before + 1
    ref = trilinear.trilinear_fwd_ref(haloed, page_idx, lf, chunk=4096)
    assert out.shape == ref.shape == (n, 8 * channels)
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
