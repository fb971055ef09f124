"""The port's compiled image codec (``f2nerf_tpu_torch/utils/csrc/
image_codec.cpp``, the only decoder behind ``image_io.read_image`` and
``decode_image``) against PIL, which the JAX package reads images with.
Every file here loads in the port to pixels ``np.array_equal`` to the JAX
package's ``read_image``:

* JPEG: every case of ``test_torch_jpeg.py`` (1x1 to 130x70, quality
  50-100, 4:4:4 / 4:2:2 / 4:2:0, grey, optimized tables, restarts, RGB-coded
  files, 16-bit quantization tables, fill bytes), baseline and
  progressive, the baseline ones also equal to the plain ``decode_jpeg``;
  progressive files whose scan script stops early or skips scans
  (libjpeg-turbo's block smoothing and DC interpolation); a file with no
  Huffman tables (Annex K's). The kinds the codec does not read raise
  ``ValueError`` naming the gap.
* PNG: every colour type at every bit depth the standard allows, Adam7
  interlaced or not, each of the five row filters and a mix, hand-encoded
  here (PIL writes few of them); the 8-bit non-interlaced ones also equal
  the plain ``decode_png``. PIL's rules pinned one by one: 16-bit grey
  saturates at 255, 16-bit samples keep their high byte, sub-byte grey is
  scaled, a palette index past PLTE is black, tRNS is dropped.
* The committed fixtures (``tests/torch_fixtures/codec``, written by this
  file's ``__main__``) equal their stored PIL decodes (``expected.npz``),
  which ``chip_smoke.py`` checks again on the machine without PIL.
* A dataset of progressive JPEGs loads to the JAX package's array.
* Without a C++ compiler, or with a source that does not compile,
  ``read_image`` raises and never falls back to the plain decoders; the
  library's name follows its source.
"""

import io
import pathlib
import re
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

import test_torch_jpeg as tj
from f2nerf_tpu.data import dataset as jdata
from f2nerf_tpu.utils import image_io as jimg
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.data import synthetic as tsyn
from f2nerf_tpu_torch.kernels import build
from f2nerf_tpu_torch.utils import image_io as timg

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures" / "codec"


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _as_in_jax(tmp_path: pathlib.Path, data: bytes, name: str) -> np.ndarray:
    """Write ``data`` to a file; both packages' ``read_image`` must give
    the same pixels. Returns the port's uint8 decode."""
    path = tmp_path / name
    path.write_bytes(data)
    got = timg.read_image(path)
    np.testing.assert_array_equal(got, jimg.read_image(path))
    return timg.decode_image(data)


# -- JPEG ------------------------------------------------------------------


def _jpeg_cases() -> dict:
    """The JPEG cases of ``test_torch_jpeg.py``, each a function that
    writes the file, baseline or ``progressive``."""
    cases = {}
    for hw in tj.SIZES:
        for ss in (0, 1, 2):
            for q in (50, 75, 95, 100):
                cases[f"{hw[0]}x{hw[1]}-s{ss}-q{q}"] = (
                    lambda p, hw=hw, ss=ss, q=q: tj._jpeg(
                        tj._smooth(np.random.default_rng(
                            1000 * hw[0] + 10 * q + ss), *hw),
                        quality=q, subsampling=ss, progressive=p))
        cases[f"grey-{hw[0]}x{hw[1]}"] = lambda p, hw=hw: tj._jpeg(
            tj._smooth(np.random.default_rng(3), *hw), "L", quality=85,
            progressive=p)
    for name, opts in (("optimize", {"optimize": True}),
                       ("rst_blocks1", {"restart_marker_blocks": 1}),
                       ("rst_blocks5", {"restart_marker_blocks": 5}),
                       ("rst_rows1", {"restart_marker_rows": 1})):
        for ss in (0, 1, 2):
            cases[f"{name}-s{ss}"] = lambda p, ss=ss, opts=opts: tj._jpeg(
                tj._smooth(np.random.default_rng(ss), 45, 67), quality=92,
                subsampling=ss, progressive=p, **opts)
    cases["rgb_coded"] = lambda p: tj._jpeg(
        tj._smooth(np.random.default_rng(4), 45, 67), quality=92,
        subsampling=0, keep_rgb=True, progressive=p)
    cases["dqt16"] = lambda p: tj._jpeg(
        tj._smooth(np.random.default_rng(5), 40, 56),
        qtables=[list(range(200, 264)), [300 + i for i in range(64)]],
        subsampling=2, progressive=p)
    cases["fill_bytes"] = lambda p: tj._with_fill_bytes(tj._jpeg(
        tj._smooth(np.random.default_rng(6), 24, 40), quality=80,
        restart_marker_blocks=2, comment=b"a comment", progressive=p))
    return cases


JPEG_CASES = _jpeg_cases()


@pytest.mark.parametrize("progressive", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("case", sorted(JPEG_CASES))
def test_jpeg_equals_jax(case, progressive, tmp_path):
    data = JPEG_CASES[case](progressive)
    got = _as_in_jax(tmp_path, data, "x.jpg")
    if progressive:
        with pytest.raises(ValueError, match="progressive"):
            timg.decode_jpeg(data)
    else:
        np.testing.assert_array_equal(got, timg.decode_jpeg(data))


_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")


def _scans(data: bytes) -> tuple[bytes, list[tuple[bytes, bytes, bytes]]]:
    """A progressive JPEG's header (its segments up to the first SOS) and
    its scans, each (the table segments before it, its SOS segment, its
    entropy-coded data)."""
    pos, head, scans, pending = 2, b"", [], b""
    while data[pos + 1] != 0xD9:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos:pos + 2 + n]
        pos += 2 + n
        if seg[1] == 0xDA:
            end = _SCAN_END.search(data, pos).start()
            scans.append((pending, seg, data[pos:end]))
            pending, pos = b"", end
        elif scans:
            pending += seg
        else:
            head += seg
    return head, scans


def _keep_scans(data: bytes, wanted: list[int]) -> bytes:
    """``data`` with only the scans ``wanted`` that keep the progression
    valid (each refinement follows the scan it refines), as an encoder
    that stops early or skips components would write it."""
    head, scans = _scans(data)
    al: dict[tuple[int, int], int] = {}
    kept = []
    for i in wanted:
        tables, sos, body = scans[i]
        ns = sos[4]
        ids = [sos[5 + 2 * k] for k in range(ns)]
        ss, se, a = sos[5 + 2 * ns], sos[6 + 2 * ns], sos[7 + 2 * ns]
        band = [(c, k) for c in ids for k in range(ss, se + 1)]
        if all(al.get(key, 0) == a >> 4 for key in band):
            al.update(dict.fromkeys(band, a & 15))
            kept.append(tables + sos + body)
    return b"\xff\xd8" + head + b"".join(kept) + b"\xff\xd9"


# libjpeg's script for YCbCr (jcparam.c): 0 DC first (Al 1), 1 Y AC 1-5
# (Al 2), 2 / 3 Cr / Cb AC 1-63 (Al 1), 4 Y AC 6-63 (Al 2), 5 Y to Al 1,
# 6 DC refinement, 7 / 8 / 9 Cr / Cb / Y to Al 0; for grey: 0 DC, 1 AC
# 1-5, 2 AC 6-63, 3 AC to Al 1, 4 DC refinement, 5 AC to Al 0
SMOOTHING_KEEPS = {"dc_only": [0], "first_band": [0, 1],
                   "first_scans": [0, 1, 2, 3, 4],
                   "all_but_last": list(range(9)),
                   "skip_chroma_ac": [0, 1, 4, 5, 6, 9]}


@pytest.mark.parametrize("keep", sorted(SMOOTHING_KEEPS))
@pytest.mark.parametrize("subsampling", [0, 1, 2, "grey"])
@pytest.mark.parametrize("hw", [(17, 33), (70, 130), (100, 37)],
                         ids=["17x33", "70x130", "100x37"])
def test_progressive_smoothing_equals_jax(hw, subsampling, keep, tmp_path):
    """A progressive file whose scans leave low AC coefficients unrefined
    (libjpeg-turbo smooths each block from its 5x5 DC neighbourhood) or
    send no AC data for a component (it interpolates the DC too); the last
    iMCU row of 4:2:0 counts its rows as libjpeg-turbo does."""
    rng = np.random.default_rng(hw[0] + 7 * hw[1])
    grey = subsampling == "grey"
    data = tj._jpeg(tj._smooth(rng, *hw), "L" if grey else "RGB",
                    quality=80, progressive=True,
                    **({} if grey else {"subsampling": subsampling}))
    n_scans = len(_scans(data)[1])
    wanted = [i for i in SMOOTHING_KEEPS[keep] if i < n_scans - 1]
    _as_in_jax(tmp_path, _keep_scans(data, wanted), "x.jpg")


def test_annex_k_tables_when_a_file_has_none(tmp_path):
    """A Motion-JPEG-style frame without DHT decodes with the standard
    tables, as libjpeg-turbo fills them in."""
    data = tj._jpeg(tj._smooth(np.random.default_rng(12), 40, 56),
                    quality=90)
    pos, out = 2, [data[:2]]
    while data[pos + 1] != 0xDA:
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        if data[pos + 1] != 0xC4:
            out.append(data[pos:pos + 2 + n])
        pos += 2 + n
    bare = b"".join(out) + data[pos:]
    assert b"\xff\xc4" not in bare
    np.testing.assert_array_equal(_as_in_jax(tmp_path, bare, "x.jpg"),
                                  _pil(data))


@pytest.mark.parametrize("prog", [False, True],
                         ids=["baseline", "progressive"])
@pytest.mark.parametrize("hv", [0x41, 0x14], ids=["y4x1", "y1x4"])
@pytest.mark.parametrize("hw", [(32, 64), (96, 32)], ids=["32x64", "96x32"])
def test_sampling_factor_4_equals_jax(hw, hv, prog, tmp_path):
    """Luma sampled 4x1 or 1x4 against chroma 1x1 (libjpeg-turbo
    replicates each chroma sample four times: ``int_upsample``): a 4:2:0
    file relabelled so, whose blocks, tables and MCU count stay valid."""
    rng = np.random.default_rng(hw[0] + hv)
    data = tj._jpeg(tj._smooth(rng, *hw), quality=85, subsampling=2,
                    progressive=prog)
    data = tj._patched(data, b"\xff\xc2" if prog else b"\xff\xc0", 11, hv)
    _as_in_jax(tmp_path, data, "x.jpg")


def _fractional_sampling() -> tuple[bytes, str]:
    """Luma 3x1 against chroma 2x1: a ratio of 1.5, which PIL refuses."""
    img = tj._smooth(np.random.default_rng(8), 16, 24)
    data = tj._patched(tj._jpeg(img, subsampling=1), b"\xff\xc0", 11, 0x31)
    return tj._patched(data, b"\xff\xc0", 14, 0x21), "fractional"


@pytest.mark.parametrize("kind", ["sof9", "lossless", "12-bit", "cmyk",
                                  "fractional"])
def test_unsupported_jpeg_kinds_raise_naming_the_gap(kind):
    data, words = (_fractional_sampling() if kind == "fractional"
                   else tj._unsupported()[kind])
    with pytest.raises(ValueError, match=words):
        timg.decode_image(data)


def test_jpeg_dataset_of_progressive_files_loads_as_in_jax(tmp_path):
    """The sphere dataset with its PNGs re-saved as progressive JPEG (by
    PIL) loads to the same [N, H, W, 3] array in both packages."""
    ds = tsyn.make_sphere_dataset(n_images=4, h=24, w=24)
    tdata.save_dataset(ds, tmp_path)
    for p in sorted((tmp_path / "images").glob("*.png")):
        Image.open(p).save(p.with_suffix(".jpg"), quality=90,
                           progressive=True)
        p.unlink()
    got = tdata.load_dataset(tmp_path)
    want = jdata.load_dataset(tmp_path)
    assert got.images.shape == (4, 24, 24, 3)
    np.testing.assert_array_equal(got.images, np.asarray(want.images))


# -- PNG -------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
PAIRS = [(c, d) for c, ds in DEPTHS.items() for d in ds]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """One row of samples -> its bytes (MSB first below 8 bits, big-endian
    at 16)."""
    if depth == 16:
        return np.frombuffer(samples.astype(">u2").tobytes(), np.uint8)
    if depth == 8:
        return samples.astype(np.uint8)
    bits = np.unpackbits(samples.astype(np.uint8)[:, None], axis=1)
    return np.packbits(bits[:, 8 - depth:].ravel())


def _filtered(raw: np.ndarray, prev: np.ndarray, bpp: int, f: int) -> bytes:
    """The specification's filter ``f`` on one row of bytes."""
    x, b = raw.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x])[:len(x)]
    c = np.concatenate([np.zeros(bpp, np.int64), b])[:len(x)]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = (0, a, b, (a + b) // 2, paeth)[f]
    return bytes([f]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()


def encode_png(samples: np.ndarray, depth: int, colour: int,
               interlace: int = 0, filters=(0,), palette: bytes | None = None,
               trns: bytes | None = None) -> bytes:
    """A PNG of ``samples`` (int [H, W, channels]; palette indices for
    colour type 3) at ``depth``, Adam7 passes when ``interlace``, the
    rows filtered by ``filters`` in turn."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    rows, k = [], 0
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:               # an empty pass has no rows at all
            continue
        prev = None
        for row in sub:
            raw = _pack(row.reshape(-1), depth)
            prev = np.zeros_like(raw) if prev is None else prev
            rows.append(_filtered(raw, prev, bpp, filters[k % len(filters)]))
            prev, k = raw, k + 1
    return assemble_png(w, h, depth, colour, b"".join(rows), interlace,
                        palette, trns)


def assemble_png(w: int, h: int, depth: int, colour: int, raw: bytes,
                 interlace: int = 0, palette: bytes | None = None,
                 trns: bytes | None = None) -> bytes:
    """The chunks of a PNG around its filtered rows ``raw``."""
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (timg.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + (_chunk(b"PLTE", palette) if palette is not None else b"")
            + (_chunk(b"tRNS", trns) if trns is not None else b"")
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def png_samples(rng, h: int, w: int, colour: int, depth: int
                ) -> tuple[np.ndarray, bytes | None]:
    """Camera-like samples over the whole range of ``depth`` (16-bit
    grey well above 255 in places), and a palette for colour type 3."""
    top = (1 << depth) - 1
    ch = CHANNELS[colour]
    wave = tj._smooth(rng, h, w).astype(np.int64)[..., :1].repeat(ch, -1)
    noise = rng.integers(0, top + 1, (h, w, ch))
    samples = np.where(rng.random((h, w, ch)) < 0.3, noise,
                       wave * top // 255)
    palette = None
    if colour == 3:
        palette = rng.integers(0, 256, 3 * (top + 1)).astype(
            np.uint8).tobytes()
    return samples, palette


FILTERS = {"none": (0,), "sub": (1,), "up": (2,), "average": (3,),
           "paeth": (4,), "mixed": (4, 1, 0, 3, 2, 2, 4, 1)}


@pytest.mark.parametrize("filt", sorted(FILTERS))
@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("colour,depth", PAIRS,
                         ids=[f"c{c}d{d}" for c, d in PAIRS])
def test_png_equals_jax(colour, depth, interlace, filt, tmp_path):
    rng = np.random.default_rng(100 * colour + depth + 7 * interlace)
    samples, palette = png_samples(rng, 11, 13, colour, depth)
    data = encode_png(samples, depth, colour, interlace, FILTERS[filt],
                      palette)
    got = _as_in_jax(tmp_path, data, "x.png")
    if depth == 8 and not interlace:
        np.testing.assert_array_equal(got, timg.decode_png(data))


@pytest.mark.parametrize("hw", [(1, 1), (1, 6), (5, 1), (2, 3), (3, 9),
                                (9, 2)], ids=str)
@pytest.mark.parametrize("colour,depth", [(0, 1), (3, 4), (2, 16), (6, 8)])
def test_adam7_empty_passes(hw, colour, depth, tmp_path):
    """Images smaller than 8x8 leave some Adam7 passes empty: they carry
    no rows, not even filter bytes."""
    rng = np.random.default_rng(hw[0] * 10 + hw[1])
    samples, palette = png_samples(rng, *hw, colour, depth)
    _as_in_jax(tmp_path, encode_png(samples, depth, colour, 1, (4, 1),
                                    palette), "x.png")


def test_png_rules_pinned_against_pil():
    """PIL's conversions, value by value: 16-bit grey saturates at 255
    (``I;16`` -> RGB), 16-bit RGB(A) and grey + alpha keep the high byte,
    2- and 4-bit grey scale by 85 and 17, 1-bit is 0 / 255, a palette
    index past PLTE is black, tRNS changes nothing."""
    grey16 = np.array([0, 1, 255, 256, 1000, 65535])[None, :, None]
    want = [0, 1, 255, 255, 255, 255]
    for trns in (None, struct.pack(">H", 1000)):
        data = encode_png(grey16, 16, 0, trns=trns)
        np.testing.assert_array_equal(timg.decode_image(data)[0, :, 0], want)
        np.testing.assert_array_equal(_pil(data)[0, :, 0], want)
    rgb16 = np.array([[[300, 511, 65535], [255, 256, 7]]])
    np.testing.assert_array_equal(timg.decode_image(encode_png(rgb16, 16, 2)),
                                  [[[1, 1, 255], [0, 1, 0]]])
    la16 = np.array([[[300, 5], [65535, 0], [255, 7]]])
    np.testing.assert_array_equal(
        timg.decode_image(encode_png(la16, 16, 4))[0, :, 0], [1, 255, 0])
    for depth, scale in ((1, 255), (2, 85), (4, 17)):
        vals = np.arange(1 << depth)[None, :, None]
        np.testing.assert_array_equal(
            timg.decode_image(encode_png(vals, depth, 0))[0, :, 0],
            vals[0, :, 0] * scale)
    pal = bytes([10, 20, 30, 40, 50, 60, 70, 80, 90])
    idx = np.array([0, 1, 2, 3, 200])[None, :, None]
    for trns in (None, b"\x00\x80"):
        data = encode_png(idx, 8, 3, palette=pal, trns=trns)
        want = [[10, 20, 30], [40, 50, 60], [70, 80, 90], [0, 0, 0],
                [0, 0, 0]]
        np.testing.assert_array_equal(timg.decode_image(data)[0], want)
        with warnings.catch_warnings():     # PIL: bytes transparency
            warnings.simplefilter("ignore", UserWarning)
            np.testing.assert_array_equal(_pil(data)[0], want)


def test_png_faults_raise():
    """An undefined depth, interlace method or row filter and too little
    image data raise, naming the fault (PIL refuses each of these files
    too); a palette image without PLTE is black in both."""
    row = b"\x00" + bytes(9)           # filter 0, three RGB pixels
    for args, words in (
            ((3, 2, 4, 2, row * 2), "colour type 2 at bit depth 4"),
            ((3, 2, 8, 2, row * 2, 2), "interlace method 2"),
            ((3, 2, 8, 2, row + b"\x07" + bytes(9)), "filter type 7"),
            ((3, 2, 8, 2, row + row[:2]), "holds 12 bytes, expected 20")):
        data = assemble_png(*args)
        with pytest.raises(ValueError, match=words):
            timg.decode_image(data)
        with pytest.raises(OSError):
            _pil(data)
    no_plte = assemble_png(3, 2, 8, 3, b"\x00\x00\x05\xff" * 2)
    np.testing.assert_array_equal(timg.decode_image(no_plte),
                                  np.zeros((2, 3, 3), np.uint8))
    np.testing.assert_array_equal(_pil(no_plte), np.zeros((2, 3, 3)))


# -- fixtures for the machine without PIL ------------------------------------


def _fixture_specs() -> dict:
    """name -> the file's bytes (seeded)."""
    rng = np.random.default_rng(17)
    img = tj._smooth(rng, 29, 37)
    specs = {
        "prog_ycc420_29x37.jpg": tj._jpeg(img, quality=85, subsampling=2,
                                          progressive=True),
        "prog_ycc444_rst_24x16.jpg": tj._jpeg(
            img[:16, :24], quality=95, subsampling=0, progressive=True,
            restart_marker_blocks=3),
        "prog_grey_23x19.jpg": tj._jpeg(img[:19, :23], "L", quality=75,
                                        progressive=True),
        "prog_smoothed_ycc420_29x37.jpg": _keep_scans(tj._jpeg(
            img, quality=80, subsampling=2, progressive=True), [0, 1, 2, 3]),
        # restarts at every MCU: chip_smoke tiles a camera frame from it
        "prog_ycc420_rst1_48x32.jpg": tj._jpeg(
            tj._smooth(rng, 32, 48), quality=90, subsampling=2,
            progressive=True, restart_marker_blocks=1),
    }
    for name, (colour, depth, interlace, filters) in {
            "rgb16_21x17.png": (2, 16, 0, (4, 1, 2)),
            "grey16_21x17.png": (0, 16, 0, (1, 4)),
            "palette4_21x17.png": (3, 4, 0, (0, 4)),
            "grey2_21x17.png": (0, 2, 0, (2, 3)),
            "adam7_rgb8_21x17.png": (2, 8, 1, (4, 1, 0, 3, 2)),
            "adam7_ga16_21x17.png": (4, 16, 1, (3, 4)),
            "rgb8_paeth_sub_21x17.png": (2, 8, 0, (4, 1))}.items():
        samples, palette = png_samples(rng, 17, 21, colour, depth)
        specs[name] = encode_png(samples, depth, colour, interlace, filters,
                                 palette)
    return specs


FIXTURE_NAMES = sorted(_fixture_specs())


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_equals_stored_decode(name):
    data = (FIXTURES / name).read_bytes()
    expected = np.load(FIXTURES / "expected.npz")[name]
    np.testing.assert_array_equal(expected, _pil(data))
    np.testing.assert_array_equal(timg.decode_image(data), expected)
    np.testing.assert_array_equal(timg.read_image(FIXTURES / name),
                                  expected.astype(np.float32) / 255)


def test_fixtures_are_the_committed_files():
    assert sorted(p.name for p in FIXTURES.iterdir()
                  if p.name != "expected.npz") == FIXTURE_NAMES
    assert sorted(np.load(FIXTURES / "expected.npz").files) == FIXTURE_NAMES
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < 100_000


@pytest.mark.parametrize("source", ["jpeg/ycc420_rst1_48x32.jpg",
                                    "codec/prog_ycc420_rst1_48x32.jpg"])
def test_tiled_frames_equal_pil(source):
    """``chip_smoke.tile_jpeg`` (the frames the card's host times the
    decoders on) builds valid baseline and progressive JPEGs from fixtures
    that restart at every MCU: PIL decodes them, to the codec's pixels,
    and the tiles repeat the source's MCUs."""
    src = (FIXTURES.parent / source).read_bytes()
    data = tj._chip_smoke().tile_jpeg(src, 70, 100)
    got = timg.decode_image(data)
    assert got.shape == (70, 100, 3)
    np.testing.assert_array_equal(got, _pil(data))
    # away from the tiles' edges (fancy upsampling reads across them) the
    # tiled frame repeats the source's pixels
    np.testing.assert_array_equal(got[34:62, 50:94], _pil(src)[2:30, 2:46])


def test_filtered_png_equals_pil():
    """``chip_smoke.filtered_png`` writes each filter type as PIL reads
    it, and the codec reads it back to the frame it was written from."""
    img = tj._smooth(np.random.default_rng(8), 23, 31)
    data = tj._chip_smoke().filtered_png(img, (4, 1, 2, 3, 0))
    np.testing.assert_array_equal(_pil(data), img)
    np.testing.assert_array_equal(timg.decode_image(data), img)
    np.testing.assert_array_equal(timg.decode_png(data), img)


# -- the build --------------------------------------------------------------


@pytest.fixture
def no_plain_decoders(monkeypatch):
    """Fail the test if ``read_image`` reaches a plain decoder."""
    def refuse(buf):
        raise AssertionError("read_image fell back to a plain decoder")

    monkeypatch.setattr(timg, "decode_png", refuse)
    monkeypatch.setattr(timg, "decode_jpeg", refuse)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})


def test_no_compiler_raises_without_falling_back(tmp_path, monkeypatch,
                                                 fresh_build,
                                                 no_plain_decoders):
    (tmp_path / "bin").mkdir()
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    img = tj._smooth(np.random.default_rng(2), 8, 8)
    (tmp_path / "a.png").write_bytes(timg.encode_png(img))
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        timg.read_image(tmp_path / "a.png")
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        timg.decode_image(tj._jpeg(img))
    assert not (tmp_path / "build").exists() or not list(
        (tmp_path / "build").glob("*.so"))


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch, fresh_build,
                                          no_plain_decoders):
    src = tmp_path / "image_codec.cpp"
    src.write_text("int f2_png_decode( {\n")
    monkeypatch.setitem(build.HOST_SOURCES, "image_codec", src)
    with pytest.raises(RuntimeError, match="failed for image_codec") as e:
        timg.decode_image(timg.encode_png(np.zeros((2, 2, 3), np.uint8)))
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))


def test_host_library_path_follows_its_source(tmp_path, monkeypatch):
    src = tmp_path / "codec.cpp"
    src.write_text("int x;\n")
    monkeypatch.setitem(build.HOST_SOURCES, "codec", src)
    before = build.library_path("codec")
    assert before == build.library_path("codec")
    assert before.parent == build.BUILD_DIR and before.suffix == ".so"
    (tmp_path / "notes.txt").write_text("not compiled\n")
    assert build.library_path("codec") == before
    src.write_text("int x;  // edited\n")
    edited = build.library_path("codec")
    assert edited != before
    (tmp_path / "common.h").write_text("\n")    # a header beside it counts
    assert build.library_path("codec") != edited
    # the kernels' default build leaves the host libraries out
    assert "image_codec" not in build.kernel_names()
    assert build.kernel_names() == sorted(
        p.stem for p in build.CSRC.glob("*.cu"))


def test_builds_into_a_fresh_directory(tmp_path, fresh_build):
    secs = build.build_all(["image_codec"])
    assert secs["image_codec"] > 0
    assert build.library_path("image_codec").exists()
    assert build.build_all(["image_codec"]) == {"image_codec": 0.0}
    img = tj._smooth(np.random.default_rng(5), 9, 14)
    np.testing.assert_array_equal(
        timg.decode_image(timg.encode_png(img)), img)


def make_fixtures() -> None:
    """Write the fixtures and ``expected.npz`` (PIL's decodes)."""
    FIXTURES.mkdir(parents=True, exist_ok=True)
    expected = {}
    for name, data in _fixture_specs().items():
        (FIXTURES / name).write_bytes(data)
        expected[name] = _pil(data)
    np.savez_compressed(FIXTURES / "expected.npz", **expected)


if __name__ == "__main__":
    make_fixtures()
