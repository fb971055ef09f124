"""Port parity: the paged hash encode (f2nerf_tpu_torch.ops.hash_paged
and kernels.trilinear's plain version against f2nerf_tpu.ops.hash_paged).

Tolerances:
* page layout, page indices, local cell coords and the haloed table are
  integer or pure data movement: exactly equal (the port's haloed rows
  are slot-major, [128, C] per page, the JAX package's channel-major,
  [C, 128]: the tests compare them through ``_slot_major`` /
  ``_channel_major``);
* fp32 encode against the JAX jnp branch: atol 1e-5 (f32 sums of 8
  nonzero products of O(1) features, summed in another order);
* bf16 encode against the Pallas kernel itself, run in interpret mode:
  atol 1e-5. (The JAX jnp branch rounds the trilinear weights to bf16,
  so it differs from the kernel by ~3e-3; the port, like the kernel,
  keeps the weights in f32.)
* fp32 encode backward (the page gradient through ``_EncodeCore`` and
  the halo transpose) against ``jax.grad`` of the JAX encode: atol
  1e-6 x the largest |grad| (f32 sums of a few hundred terms per cell);
* bf16 page gradient against ``contract_bwd_rows`` in interpret mode
  plus a ``segment_sum``: the kernel rounds every g*w term to bf16
  (2^-8 of each term) and the port rounds once, after an f32 sum (2^-8
  of the sum), so each cell may differ by 2^-7 x the sum of its terms'
  magnitudes (computed from |g|; measured up to 0.0071 x);
* fp32 point gradient (``trilinear_bwd_frac``'s plain version, the
  frac path of ``page_indices`` and the sum over levels) against
  ``jax.grad`` of the jnp branch: atol 1e-5 x the largest |grad| (the
  finest scale, 1024 here at most, multiplies each level's f32 sums);
* bf16 d_frac against ``contract_bwd_frac`` in interpret mode: 1e-5 x
  the sum of each output's term magnitudes (rows widened to f32 and g
  kept in f32 on both sides; only the order of the f32 sums differs).
  Fixtures keep away from frac == 0, where the Pallas hat derivative is
  0 and the port, like the jnp branch, is one-sided; that edge has its
  own test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import f2nerf_tpu.kernels.trilinear as jtri
from f2nerf_tpu.core.config import ModelConfig as JModelConfig
from f2nerf_tpu.models import hash_field as jhf
from f2nerf_tpu.ops import hash_paged as jhp
from f2nerf_tpu_torch.core.config import ModelConfig as TModelConfig
from f2nerf_tpu_torch.kernels import trilinear as ttri
from f2nerf_tpu_torch.models import hash_field as thf
from f2nerf_tpu_torch.ops import hash_paged as thp

# small layouts: both hashed levels (tiny), a dense+hashed mix, the full
# default model, and the two ends of the channel counts the kernels take
CONFIGS = {
    "tiny": dict(n_levels=2, n_channels=2, log2_table_size=10),
    "mixed": dict(n_levels=4, n_channels=4, log2_table_size=12),
    "default": {},
    "one_channel": dict(n_levels=3, n_channels=1, log2_table_size=10),
    "eight_channels": dict(n_levels=3, n_channels=8, log2_table_size=11),
}


def _slot_major(rows, c):
    """Channel-major haloed rows [P, C*128] (the JAX package's) in the
    port's slot-major layout [P, 128*C]."""
    rows = np.asarray(rows)
    return rows.reshape(len(rows), c, 128).transpose(0, 2, 1).reshape(
        len(rows), 128 * c)


def _channel_major(rows, c):
    """The inverse of :func:`_slot_major`."""
    rows = np.asarray(rows)
    return rows.reshape(len(rows), 128, c).transpose(0, 2, 1).reshape(
        len(rows), c * 128)


def _metas(name):
    kw = CONFIGS[name]
    return (jhf.paged_meta(JModelConfig(**kw)),
            thf.paged_meta(TModelConfig(**kw)))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_make_paged_meta_exact(name):
    jm, tm = _metas(name)
    assert tm.n_pages == jm.n_pages
    assert tm.page_offset == jm.page_offset
    assert tm.dense == jm.dense
    assert tm.n_levels == jm.n_levels and tm.n_channels == jm.n_channels
    for f in ("a", "b", "scales", "biases"):
        x, y = getattr(tm, f), getattr(jm, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    if name == "default":
        assert tm.total_pages == 54794
        assert not all(tm.dense) and any(tm.dense)


def _away_from_edges(pts, meta, margin=1e-4):
    """Keep points whose cell coordinate is at least ``margin`` from a
    cell boundary on every level and axis (floor cannot flip there)."""
    pt = (pts[None].astype(np.float64) * meta.scales[:, None, None]
          + meta.biases[:, None, :])
    frac = pt - np.floor(pt)
    ok = np.all((frac > margin) & (frac < 1 - margin), axis=(0, 2))
    return pts[ok]


@pytest.mark.parametrize("name,span", [("tiny", 2.0), ("default", 2.0),
                                       ("default", 60.0)])
def test_page_indices_exact(name, span):
    """span 60 reaches block coordinates ~16k on the finest hashed
    level, positive and negative, where the uint32 products wrap."""
    jm, tm = _metas(name)
    rng = np.random.default_rng(7)
    pts = _away_from_edges(
        rng.uniform(-span, span, (6000, 3)).astype(np.float32), jm)
    assert len(pts) > 4000
    pj, lj, fj = jhp._page_indices_lm(jnp.asarray(pts), jm)
    pt_, lt, ft = thp.page_indices(torch.from_numpy(pts), tm)
    assert pt_.dtype == torch.int32 and lt.dtype == torch.int32
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    # frac = pt - floor(pt): a few ulp of the scaled coordinate
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=2e-4)
    if span > 2.0:
        blk = np.floor(pts[None] * jm.scales[:, None, None]
                       + jm.biases[:, None, :]) // 4
        assert blk.max() > 10000 and blk.min() < -10000


def test_hash_matches_uint32_arithmetic():
    """The int64-masked hash against plain numpy uint32 arithmetic."""
    _, tm = _metas("default")
    rng = np.random.default_rng(8)
    blk = rng.integers(-(1 << 24), 1 << 24, (2000, 3))
    lvl = tm.n_levels - 1
    with np.errstate(over="ignore"):
        raw = (blk[:, 0].astype(np.uint32) * tm.a[lvl]
               + blk[:, 1].astype(np.uint32) * tm.b[lvl]
               + blk[:, 2].astype(np.uint32))
    expect = (raw % np.uint32(tm.n_pages[lvl])).astype(np.int64) \
        + tm.page_offset[lvl]
    # points whose cell is 4*blk (+0.5 to sit mid-cell) on that level
    pts = ((blk * 4 + 0.5 - tm.biases[lvl]) / tm.scales[lvl])
    pages, _, _ = thp.page_indices(torch.from_numpy(pts), tm)
    np.testing.assert_array_equal(pages[lvl].numpy(), expect)


@pytest.mark.parametrize("name", ["tiny", "mixed", "one_channel",
                                  "eight_channels"])
def test_halo_pages_exact(name):
    """The port's slot-major halo is the JAX halo permuted, exactly, for
    C in {1, 2, 4, 8}; the permutation's inverse gives the JAX rows
    back, and the pad slots are zero."""
    jm, tm = _metas(name)
    c = jm.n_channels
    rng = np.random.default_rng(9)
    pages = rng.uniform(-1, 1, (jm.total_pages, c, 4, 4, 4)
                        ).astype(np.float32)
    hj = np.asarray(jhp.halo_pages(jnp.asarray(pages), jm))
    ht = thp.halo_pages(torch.from_numpy(pages), tm).numpy()
    assert ht.shape == hj.shape == (jm.total_pages, 128 * c)
    np.testing.assert_array_equal(ht, _slot_major(hj, c))
    np.testing.assert_array_equal(_channel_major(ht, c), hj)
    assert not ht[:, 125 * c:].any()
    # corner (slot s, channel k) of page p sits at column s*C + k
    p, s, k = jm.total_pages - 1, 25 * 4 + 5 * 2 + 3, c - 1
    assert ht[p, s * c + k] == hj[p, k * 128 + s]


def _pages_points(meta, n=3000, seed=10):
    rng = np.random.default_rng(seed)
    pages = rng.uniform(-1, 1, (meta.total_pages, meta.n_channels, 4, 4, 4)
                        ).astype(np.float32)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    return pages, pts


@pytest.mark.parametrize("name", ["tiny", "mixed"])
def test_paged_encode_fp32(name):
    jm, tm = _metas(name)
    pages, pts = _pages_points(jm)
    ref = np.asarray(jhp.paged_encode(jnp.asarray(pts), jnp.asarray(pages),
                                      jm, compute_dtype=jnp.float32,
                                      use_pallas=False))
    # chunk smaller than N: the plain version's chunking must not matter
    out = thp.paged_encode(torch.from_numpy(pts), torch.from_numpy(pages),
                           tm, compute_dtype=torch.float32, chunk=1000)
    assert out.shape == (len(pts), jm.n_levels * jm.n_channels)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU
    (nothing in the JAX package changes)."""
    orig = jtri.pl.pallas_call
    monkeypatch.setattr(jtri.pl, "pallas_call",
                        functools.partial(orig, interpret=True))


@pytest.mark.parametrize("name", ["tiny", "mixed"])
def test_paged_encode_bf16_vs_pallas(name, pallas_interpret):
    jm, tm = _metas(name)
    pages, pts = _pages_points(jm, seed=11)
    ref = np.asarray(jhp.paged_encode(jnp.asarray(pts), jnp.asarray(pages),
                                      jm, compute_dtype=jnp.bfloat16,
                                      use_pallas=True))
    out = thp.paged_encode(torch.from_numpy(pts), torch.from_numpy(pages),
                           tm, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    # and the kernel-free jnp branch really is further away (bf16 weights)
    jnp_ref = np.asarray(jhp.paged_encode(
        jnp.asarray(pts), jnp.asarray(pages), jm,
        compute_dtype=jnp.bfloat16, use_pallas=False))
    assert np.abs(out.numpy() - jnp_ref).max() > 1e-4


def test_trilinear_fwd_ref_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version and launches no
    kernel; a ragged point count goes through unchanged."""
    _, tm = _metas("mixed")
    pages, pts = _pages_points(tm, n=1001, seed=12)
    haloed = thp.halo_pages(torch.from_numpy(pages), tm)
    pidx, local, frac = thp.page_indices(torch.from_numpy(pts), tm)
    lf = torch.cat([local.float(), frac], dim=-1)
    before = ttri.trilinear_fwd.launches
    a = ttri.trilinear_fwd(haloed, pidx, lf, chunk=256)
    b = ttri.trilinear_fwd_ref(haloed, pidx, lf, chunk=4096)
    assert ttri.trilinear_fwd.launches == before
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError):
        ttri.trilinear_fwd(haloed, pidx, lf[:, :-1])


def test_weight_row_matches_jax():
    rng = np.random.default_rng(13)
    local = rng.integers(0, 4, (500, 3)).astype(np.int32)
    frac = rng.random((500, 3)).astype(np.float32)
    ref = np.asarray(jhp._weight_row(jnp.asarray(local), jnp.asarray(frac)))
    out = thp.weight_row(torch.from_numpy(local), torch.from_numpy(frac))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-7)
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)


def test_level_scales_match():
    from f2nerf_tpu.ops.hash_encode import level_scales

    for n in (2, 8, 16):
        x, y = thp.level_scales(n), level_scales(n)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_dataclass_fields_are_the_same():
    assert ([f.name for f in dataclasses.fields(TModelConfig)]
            == [f.name for f in dataclasses.fields(JModelConfig)])


def _grad_inputs(meta, n, seed):
    pages, pts = _pages_points(meta, n=n, seed=seed)
    g = np.random.default_rng(seed + 100).normal(
        size=(n, meta.n_levels * meta.n_channels)).astype(np.float32)
    return pages, pts, g


@pytest.mark.parametrize("name", ["tiny", "mixed", "one_channel",
                                  "eight_channels"])
def test_encode_backward_fp32(name):
    jm, tm = _metas(name)
    pages, pts, g = _grad_inputs(jm, 3000, 20)
    ref = np.asarray(jax.grad(lambda p: jnp.sum(jhp.paged_encode(
        jnp.asarray(pts), p, jm, compute_dtype=jnp.float32,
        use_pallas=False, point_grads=False) * g))(jnp.asarray(pages)))
    tp = torch.from_numpy(pages).requires_grad_(True)
    feat = thp.paged_encode(torch.from_numpy(pts), tp, tm,
                            compute_dtype=torch.float32, chunk=1000)
    (feat * torch.from_numpy(g)).sum().backward()
    assert tp.grad.shape == pages.shape
    scale = float(np.abs(ref).max())
    assert scale > 1.0
    np.testing.assert_allclose(tp.grad.numpy(), ref, rtol=0,
                               atol=1e-6 * scale)


def _jax_page_gradient(pts, g, jm, dtype):
    """The JAX package's page gradient [P, C*128] (channel-major) in f32:
    ``contract_bwd_rows`` per level (in interpret mode under
    ``pallas_interpret``), its rows in ``dtype``, summed into pages by a
    ``segment_sum`` in f32."""
    pidx, local, frac = jhp._page_indices_lm(jnp.asarray(pts), jm)
    c = jm.n_channels
    ref = jnp.zeros((jm.total_pages, c * jhp.ROW_PAD), jnp.float32)
    for lvl in range(jm.n_levels):
        d_rows = jtri.contract_bwd_rows(
            local[lvl][:, None, :], frac[lvl][:, None, :],
            jnp.asarray(g[:, lvl * c:(lvl + 1) * c]), 1, c, dtype)
        assert d_rows.dtype == dtype
        ref = ref + jax.ops.segment_sum(d_rows.astype(jnp.float32),
                                        pidx[lvl],
                                        num_segments=jm.total_pages)
    return np.asarray(ref)


@pytest.mark.parametrize("name", ["tiny", "mixed", "one_channel",
                                  "eight_channels"])
def test_page_gradient_bf16_vs_pallas(name, pallas_interpret):
    jm, tm = _metas(name)
    n = 2048                    # a multiple of the Pallas TILE (1024)
    pages, pts, g = _grad_inputs(jm, n, 21)
    c = jm.n_channels
    ref = _jax_page_gradient(pts, g, jm, jnp.bfloat16)
    tpidx, tlocal, tfrac = thp.page_indices(torch.from_numpy(pts), tm)
    lf = torch.cat([tlocal.float(), tfrac], dim=-1)
    out = ttri.trilinear_bwd(torch.from_numpy(g), tpidx, lf,
                             tm.total_pages, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    # the port's rows are slot-major: compare in the JAX package's layout
    mag = _channel_major(ttri.trilinear_bwd_ref(
        torch.from_numpy(np.abs(g)), tpidx, lf, tm.total_pages), c)
    err = np.abs(_channel_major(out.float(), c) - ref)
    assert np.all(err <= 2.0 ** -7 * mag + 1e-30)
    assert float(mag.max()) > 1.0
    # through the whole encode and the halo transpose: the port's bf16
    # page gradient against the JAX halo transpose of that reference
    _, halo_vjp = jax.vjp(lambda p: jhp.halo_pages(p, jm),
                          jnp.asarray(pages))
    (ref_pages,) = halo_vjp(jnp.asarray(ref))
    (mag_pages,) = halo_vjp(jnp.asarray(mag))
    tp = torch.from_numpy(pages).requires_grad_(True)
    feat = thp.paged_encode(torch.from_numpy(pts), tp, tm,
                            compute_dtype=torch.bfloat16)
    (feat * torch.from_numpy(g)).sum().backward()
    err = np.abs(tp.grad.numpy() - np.asarray(ref_pages))
    assert np.all(err <= 2.0 ** -7 * np.asarray(mag_pages) + 1e-30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_page_gradient_skewed_vs_pallas(dtype, pallas_interpret):
    """Skewed points (three quarters in one finest-level cell): every
    level holds a page run of over 1,500 entries, several times the CUDA
    kernel's tile, against ``contract_bwd_rows`` in interpret mode plus a
    ``segment_sum``. f32: 1e-5 x each cell's term magnitudes (the same
    f32 products summed in another order); bf16: 2^-7 of them, as in
    ``test_page_gradient_bf16_vs_pallas``."""
    jm, tm = _metas("mixed")
    n = 2048
    _, pts, g = _grad_inputs(jm, n, 28)
    pts[: 3 * n // 4] = pts[: 3 * n // 4] * 1e-4 + 0.01
    tpidx, tlocal, tfrac = thp.page_indices(torch.from_numpy(pts), tm)
    runs = [int(torch.bincount(tpidx[lvl].long()).max())
            for lvl in range(jm.n_levels)]
    assert min(runs) >= 3 * n // 4
    ref = _jax_page_gradient(pts, g, jm, getattr(jnp, dtype))
    lf = torch.cat([tlocal.float(), tfrac], dim=-1)
    out = ttri.trilinear_bwd(torch.from_numpy(g), tpidx, lf,
                             tm.total_pages, getattr(torch, dtype))
    c = jm.n_channels
    mag = _channel_major(ttri.trilinear_bwd_ref(
        torch.from_numpy(np.abs(g)), tpidx, lf, tm.total_pages), c)
    assert float(mag.max()) > 100.0
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    err = np.abs(_channel_major(out.float(), c) - ref)
    assert np.all(err <= rel * mag + 1e-30)


def _point_grad(pts, pages, meta, g, dtype, chunk=65536, pages_grad=False):
    """The port's gradient of sum(encode * g) in the points (and in the
    pages when ``pages_grad``)."""
    x = torch.from_numpy(pts).requires_grad_(True)
    tp = torch.from_numpy(pages).requires_grad_(pages_grad)
    feat = thp.paged_encode(x, tp, meta, compute_dtype=dtype, chunk=chunk)
    (feat * torch.from_numpy(g)).sum().backward()
    return x.grad, tp.grad


@pytest.mark.parametrize("name", ["tiny", "mixed"])
def test_point_gradient_fp32(name):
    """Through ``_EncodeCore`` and ``page_indices`` against ``jax.grad``
    of the JAX encode (jnp branch, point_grads=True)."""
    jm, tm = _metas(name)
    pages, pts, _ = _grad_inputs(jm, 3000, 22)
    pts = _away_from_edges(pts, jm)
    g = np.random.default_rng(122).normal(
        size=(len(pts), jm.n_levels * jm.n_channels)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(jhp.paged_encode(
        x, jnp.asarray(pages), jm, compute_dtype=jnp.float32,
        use_pallas=False, point_grads=True) * g))(jnp.asarray(pts)))
    out, _ = _point_grad(pts, pages, tm, g, torch.float32, chunk=1000)
    scale = float(np.abs(ref).max())
    assert out.shape == pts.shape and scale > 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("name", ["tiny", "mixed"])
def test_point_gradient_bf16_vs_pallas(name, pallas_interpret):
    """The bf16 d_frac against ``contract_bwd_frac`` in interpret mode,
    per level, at 1e-5 of each output's term magnitudes (the same f32
    products summed in another order); then the whole encode's point
    gradient against sum_l scale_l * d_frac_l of that kernel."""
    jm, tm = _metas(name)
    n = 2048                    # a multiple of the Pallas TILE (1024)
    pages, pts, g = _grad_inputs(jm, 3000, 24)
    # away from frac == 0, where the two sides differ by design
    pts, g = _away_from_edges(pts, jm)[:n], g[:n]
    assert len(pts) == n
    haloed = jhp.halo_pages(jnp.asarray(pages), jm).astype(jnp.bfloat16)
    pidx, local, frac = jhp._page_indices_lm(jnp.asarray(pts), jm)
    c = jm.n_channels
    ref = np.stack([np.asarray(jtri.contract_bwd_frac(
        jnp.take(haloed, pidx[lvl], axis=0), local[lvl][:, None, :],
        frac[lvl][:, None, :], jnp.asarray(g[:, lvl * c:(lvl + 1) * c]), 1,
        c)[:, 0]) for lvl in range(jm.n_levels)])          # [L, N, 3]
    t_haloed = thp.halo_pages(torch.from_numpy(pages), tm).to(torch.bfloat16)
    tpidx, tlocal, tfrac = thp.page_indices(torch.from_numpy(pts), tm)
    lf = torch.cat([tlocal.float(), tfrac], dim=-1)
    out = ttri.trilinear_bwd_frac(t_haloed, tpidx, lf, torch.from_numpy(g))
    mag = ttri.trilinear_bwd_frac_ref(t_haloed, tpidx, lf,
                                      torch.from_numpy(g), magnitudes=True)
    assert out.shape == (jm.n_levels, n, 6)
    assert float(out[..., :3].abs().max()) == 0.0
    assert float(mag.max()) > 1.0
    err = np.abs(out[..., 3:].numpy() - ref)
    assert np.all(err <= 1e-5 * mag[..., 3:].numpy() + 1e-30)
    d_pts = np.einsum("l,lnk->nk", jm.scales, ref)
    got, _ = _point_grad(pts, pages, tm, g, torch.bfloat16)
    scale = float(np.abs(d_pts).max())
    np.testing.assert_allclose(got.numpy(), d_pts, rtol=0,
                               atol=1e-5 * scale)


def test_point_gradient_at_frac_zero(pallas_interpret):
    """At frac == 0 exactly the port gives the JAX jnp branch's
    one-sided derivative (-1 / +1 per corner pair); the Pallas hat
    derivative gives 0 on that axis (a divergence between the JAX
    package's two branches, ROADMAP §C)."""
    _, tm = _metas("mixed")
    n, c = 1024, tm.n_channels
    rng = np.random.default_rng(25)
    haloed = rng.uniform(-1, 1, (tm.total_pages, c * 128)).astype(np.float32)
    pidx = rng.integers(0, tm.total_pages, (1, n)).astype(np.int32)
    local = rng.integers(0, 4, (1, n, 3)).astype(np.int32)
    frac = rng.uniform(0.05, 0.95, (1, n, 3)).astype(np.float32)
    frac[0, :, 0] = 0.0                     # every point on an x edge
    frac[0, ::2, 2] = 0.0                   # half of them on a z edge too
    g = rng.normal(size=(n, c)).astype(np.float32)
    rows = jnp.take(jnp.asarray(haloed), jnp.asarray(pidx[0]), axis=0)
    jnp_ref = np.asarray(jhp._dfrac_level(
        rows, jnp.asarray(local[0]), jnp.asarray(frac[0]), jnp.asarray(g),
        c, use_pallas=False))
    pallas = np.asarray(jhp._dfrac_level(
        rows, jnp.asarray(local[0]), jnp.asarray(frac[0]), jnp.asarray(g),
        c, use_pallas=True))
    lf = torch.from_numpy(np.concatenate([local, frac], -1).astype(
        np.float32))
    # the same table in the port's slot-major layout
    out = ttri.trilinear_bwd_frac(torch.from_numpy(_slot_major(haloed, c)),
                                  torch.from_numpy(pidx), lf,
                                  torch.from_numpy(g))[0, :, 3:].numpy()
    np.testing.assert_allclose(out, jnp_ref, rtol=0, atol=1e-5)
    assert np.abs(out[:, 0]).min() > 0.0 and np.abs(out[::2, 2]).min() > 0
    # the Pallas branch: 0 on the edge axes, the same elsewhere
    assert np.all(pallas[:, 0] == 0.0) and np.all(pallas[::2, 2] == 0.0)
    np.testing.assert_allclose(pallas[:, 1], out[:, 1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny", "mixed"])
def test_both_gradients_together(name):
    """Page and point gradients asked for in one backward equal each
    asked for alone."""
    jm, tm = _metas(name)
    pages, pts, g = _grad_inputs(tm, 700, 26)
    d_pts, d_pages = _point_grad(pts, pages, tm, g, torch.float32,
                                 pages_grad=True)
    alone_pts, none = _point_grad(pts, pages, tm, g, torch.float32)
    assert none is None
    tp = torch.from_numpy(pages).requires_grad_(True)
    feat = thp.paged_encode(torch.from_numpy(pts), tp, tm,
                            compute_dtype=torch.float32)
    (feat * torch.from_numpy(g)).sum().backward()
    torch.testing.assert_close(d_pts, alone_pts, rtol=0, atol=0)
    torch.testing.assert_close(d_pages, tp.grad, rtol=0, atol=0)
    assert float(d_pts.abs().max()) > 0 and float(d_pages.abs().max()) > 0


def test_trilinear_bwd_frac_ref_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version and launches no
    kernel; the chunking does not change the result; bad shapes raise."""
    _, tm = _metas("mixed")
    pages, pts, g = _grad_inputs(tm, 1001, 27)
    haloed = thp.halo_pages(torch.from_numpy(pages), tm)
    pidx, local, frac = thp.page_indices(torch.from_numpy(pts), tm)
    lf = torch.cat([local.float(), frac], dim=-1)
    gt = torch.from_numpy(g)
    before = ttri.trilinear_bwd_frac.launches
    a = ttri.trilinear_bwd_frac(haloed, pidx, lf, gt, chunk=256)
    b = ttri.trilinear_bwd_frac_ref(haloed, pidx, lf, gt, chunk=4096)
    assert ttri.trilinear_bwd_frac.launches == before
    assert a.shape == (tm.n_levels, 1001, 6) and a.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    mag = ttri.trilinear_bwd_frac_ref(haloed, pidx, lf, gt, magnitudes=True)
    assert bool((mag[..., 3:] >= a[..., 3:].abs() - 1e-6).all())
    with pytest.raises(ValueError):
        ttri.trilinear_bwd_frac(haloed, pidx, lf, gt[:-1])
    with pytest.raises(ValueError):
        ttri.trilinear_bwd_frac(haloed, pidx, lf[:, :-1], gt)
    with pytest.raises(ValueError):
        ttri.trilinear_bwd_frac(haloed[:, :-1], pidx, lf, gt)


def test_trilinear_bwd_ref_is_the_cpu_path():
    """On CPU tensors the wrapper is the plain version and launches no
    kernel; the chunking does not change the result; bad shapes raise."""
    _, tm = _metas("mixed")
    pages, pts, g = _grad_inputs(tm, 1001, 23)
    pidx, local, frac = thp.page_indices(torch.from_numpy(pts), tm)
    lf = torch.cat([local.float(), frac], dim=-1)
    gt = torch.from_numpy(g)
    before = ttri.trilinear_bwd.launches
    a = ttri.trilinear_bwd(gt, pidx, lf, tm.total_pages, chunk=256)
    b = ttri.trilinear_bwd_ref(gt, pidx, lf, tm.total_pages, chunk=4096)
    assert ttri.trilinear_bwd.launches == before
    c = tm.n_channels
    assert a.shape == (tm.total_pages, 128 * c)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
    assert float(a[:, 125 * c:].abs().max()) == 0.0     # pad slots
    with pytest.raises(ValueError):
        ttri.trilinear_bwd(gt[:-1], pidx, lf, tm.total_pages)
    with pytest.raises(ValueError):
        ttri.trilinear_bwd(gt, pidx, lf[:, :-1], tm.total_pages)


@pytest.mark.parametrize("channels", [3, 5, 6, 7])
def test_channel_padding_glue(channels):
    """The wrappers run a C the kernels are not built for at the next
    width they are (3 -> 4, 5-7 -> 8): the table and g zero-padded, the
    output sliced. On the plain versions that glue gives what C itself
    gives, within 1e-6 (the padded channels are zeros; the vectorized
    f32 sums may take another order at another width)."""
    cfg = TModelConfig(n_levels=3, n_channels=channels, log2_table_size=10)
    tm = thf.paged_meta(cfg)
    width = ttri._kernel_width("k", channels, tm.n_levels)
    assert width == (4 if channels == 3 else 8)
    pages, pts, g = _grad_inputs(tm, 300, 40 + channels)
    haloed = thp.halo_pages(torch.from_numpy(pages), tm)
    pidx, local, frac = thp.page_indices(torch.from_numpy(pts), tm)
    lf = torch.cat([local.float(), frac], dim=-1)
    gt = torch.from_numpy(g)
    wide_table = ttri._pad_channels(haloed, channels, width)
    wide_g = ttri._pad_channels(gt, channels, width)
    assert wide_table.shape == (tm.total_pages, 128 * width)
    assert wide_g.shape == (300, tm.n_levels * width)
    assert ttri._pad_channels(haloed, channels, channels) is haloed
    feat = ttri._unpad_channels(
        ttri.trilinear_fwd_ref(wide_table, pidx, lf), channels, width)
    torch.testing.assert_close(feat, ttri.trilinear_fwd_ref(haloed, pidx, lf),
                               rtol=0, atol=1e-6)
    d_table = ttri._unpad_channels(
        ttri.trilinear_bwd_ref(wide_g, pidx, lf, tm.total_pages),
        channels, width)
    torch.testing.assert_close(
        d_table, ttri.trilinear_bwd_ref(gt, pidx, lf, tm.total_pages),
        rtol=0, atol=1e-6)
    d_lf = ttri.trilinear_bwd_frac_ref(wide_table, pidx, lf, wide_g)
    torch.testing.assert_close(
        d_lf, ttri.trilinear_bwd_frac_ref(haloed, pidx, lf, gt),
        rtol=0, atol=1e-6)


def test_kernel_width_limits():
    """C beyond 8 and a padded L*C beyond the shared-memory tile raise;
    the page-gradient kernel keeps no such tile."""
    with pytest.raises(ValueError, match="C <= 8"):
        ttri._kernel_width("trilinear_fwd", 9, 2)
    with pytest.raises(ValueError, match="shared memory"):
        ttri._kernel_width("trilinear_fwd", 6, 40)       # 40 * 8 > 256
    assert ttri._kernel_width("trilinear_bwd", 6, 40, tile=False) == 8
    assert ttri._kernel_width("trilinear_fwd", 4, 64) == 4
