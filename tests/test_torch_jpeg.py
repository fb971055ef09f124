"""The port's JPEG decoder (``f2nerf_tpu_torch/utils/image_io.py``)
against PIL, which the JAX package reads images with.

* Every JPEG that PIL writes here is decoded to PIL's own pixels exactly
  (the decoder follows libjpeg-turbo's integer IDCT, fancy upsampling
  and colour conversion): sizes 1x1 to 130x70, quality 50-100, 4:4:4,
  4:2:2, 4:2:0, grey, optimized Huffman tables, restart intervals,
  16-bit quantization tables, RGB-coded files.
* The committed fixtures (``tests/torch_fixtures/jpeg``, written by this
  file's ``__main__``) equal their stored PIL decodes (``expected.npz``),
  which ``chip_smoke.py`` checks again on the machine without PIL.
* The kinds the decoder does not read raise ``ValueError`` naming the gap;
  of these, the compiled codec behind ``read_image`` reads progressive
  files and sampling factors of 3 (to PIL's pixels) and raises on the
  rest.
* A JPEG dataset loads to the same array in both packages.
"""

import importlib.util
import io
import pathlib
import struct

import numpy as np
import pytest
from PIL import Image

from f2nerf_tpu.data import dataset as jdata
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.data import synthetic as tsyn
from f2nerf_tpu_torch.utils import image_io as timg

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures" / "jpeg"
# name: (height, width, save options, mode)
FIXTURE_SPECS = {
    "ycc420_odd_37x23.jpg": (23, 37, {"quality": 85, "subsampling": 2}),
    "ycc420_optimized_29x21.jpg": (21, 29, {"quality": 90, "subsampling": 2,
                                            "optimize": True}),
    "ycc444_24x16.jpg": (16, 24, {"quality": 95, "subsampling": 0}),
    "ycc422_restart_33x17.jpg": (17, 33, {"quality": 75, "subsampling": 1,
                                          "restart_marker_blocks": 2}),
    "grey_19x13.jpg": (13, 19, {"quality": 80}),
    "ycc420_rst1_48x32.jpg": (32, 48, {"quality": 90, "subsampling": 2,
                                       "restart_marker_blocks": 1}),
}


def _smooth(rng, h, w) -> np.ndarray:
    """A camera-like uint8 [h, w, 3] image: waves plus noise."""
    y, x = np.mgrid[0:h, 0:w]
    ch = [127 + 90 * np.sin(rng.uniform(0.05, 0.4) * x
                            + rng.uniform(0.05, 0.4) * y + rng.uniform(0, 6))
          + rng.normal(0, 12, (h, w)) for _ in range(3)]
    return np.clip(np.stack(ch, -1), 0, 255).astype(np.uint8)


def _jpeg(img: np.ndarray, mode: str = "RGB", **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).convert(mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _check(data: bytes) -> None:
    np.testing.assert_array_equal(timg.decode_jpeg(data), _pil(data))


SIZES = [(1, 1), (7, 9), (17, 33), (64, 48), (70, 130)]


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_decode_equals_pil(hw, subsampling, quality):
    rng = np.random.default_rng(1000 * hw[0] + 10 * quality + subsampling)
    _check(_jpeg(_smooth(rng, *hw), quality=quality,
                 subsampling=subsampling))


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_grey_equals_pil(hw):
    rng = np.random.default_rng(3)
    data = _jpeg(_smooth(rng, *hw), "L", quality=85)
    assert timg.decode_jpeg(data).shape == (*hw, 3)
    _check(data)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("opts", [
    {"optimize": True}, {"restart_marker_blocks": 1},
    {"restart_marker_blocks": 5}, {"restart_marker_rows": 1}],
    ids=["optimize", "rst_blocks1", "rst_blocks5", "rst_rows1"])
def test_options_equal_pil(opts, subsampling):
    """Optimized tables (codes up to 16 bits) and restart intervals of
    one or more MCUs (predictors reset, RST0-7 wrapping round)."""
    rng = np.random.default_rng(subsampling)
    _check(_jpeg(_smooth(rng, 45, 67), quality=92,
                 subsampling=subsampling, **opts))


def test_rgb_coded_equals_pil():
    """An RGB-coded file (Adobe transform 0) is not colour-converted."""
    rng = np.random.default_rng(4)
    data = _jpeg(_smooth(rng, 45, 67), quality=92, subsampling=0,
                 keep_rgb=True)
    assert b"Adobe" in data
    _check(data)


def test_sixteen_bit_quantization_tables():
    """Table entries above 255 are written as a 16-bit DQT."""
    rng = np.random.default_rng(5)
    tables = [list(range(200, 264)), [300 + i for i in range(64)]]
    data = _jpeg(_smooth(rng, 40, 56), qtables=tables, subsampling=2)
    at = data.index(b"\xff\xdb")
    assert data[at + 4] >> 4 == 1          # Pq = 1: 16-bit entries
    _check(data)


def _with_fill_bytes(data: bytes) -> bytes:
    """``data`` with an APP5 segment before its first scan and fill bytes
    before its RST1 markers and its EOI."""
    sos = data.index(b"\xff\xda")
    app = b"\xff\xe5" + struct.pack(">H", 6) + b"abcd"
    body = data[sos:].replace(b"\xff\xd1", b"\xff\xff\xff\xd1")
    return data[:sos] + app + body[:-2] + b"\xff\xff\xd9"


def test_fill_bytes_and_extra_segments():
    """Fill bytes before markers, an APP and a COM segment are skipped."""
    rng = np.random.default_rng(6)
    data = _jpeg(_smooth(rng, 24, 40), quality=80,
                 restart_marker_blocks=2, comment=b"a comment")
    np.testing.assert_array_equal(timg.decode_jpeg(_with_fill_bytes(data)),
                                  _pil(data))


@pytest.mark.parametrize("name", sorted(FIXTURE_SPECS))
def test_fixture_equals_stored_decode(name):
    expected = np.load(FIXTURES / "expected.npz")[name]
    data = (FIXTURES / name).read_bytes()
    h, w, _ = FIXTURE_SPECS[name]
    assert expected.shape == (h, w, 3)
    np.testing.assert_array_equal(expected, _pil(data))
    np.testing.assert_array_equal(timg.decode_jpeg(data), expected)
    np.testing.assert_array_equal(
        timg.read_image(FIXTURES / name), expected.astype(np.float32) / 255)


def _patched(data: bytes, marker: bytes, at: int, value: int) -> bytes:
    out = bytearray(data)
    out[data.index(marker) + at] = value
    return bytes(out)


def _unsupported():
    rng = np.random.default_rng(8)
    img = _smooth(rng, 16, 24)
    base = _jpeg(img)
    return {
        "progressive": (_jpeg(img, progressive=True), "progressive"),
        "sof9": (_patched(base, b"\xff\xc0", 1, 0xC9), "arithmetic-coded"),
        "lossless": (_patched(base, b"\xff\xc0", 1, 0xC3), "lossless"),
        "12-bit": (_patched(base, b"\xff\xc0", 4, 12), "12-bit"),
        "cmyk": (_jpeg(img, "CMYK"), "CMYK"),
        "sampling3": (_patched(base, b"\xff\xc0", 11, 0x31),
                      "sampling factors 3x1"),
    }


@pytest.mark.parametrize("kind", ["progressive", "sof9", "lossless",
                                  "12-bit", "cmyk", "sampling3"])
def test_unsupported_kinds_raise_naming_the_gap(kind):
    """The plain decoder raises on each kind, naming it; the codec behind
    ``decode_image`` does too, except on progressive files and sampling
    factors of 3, which it reads to PIL's pixels
    (``test_torch_image_codec.py`` holds it)."""
    data, words = _unsupported()[kind]
    with pytest.raises(ValueError, match=words):
        timg.decode_jpeg(data)
    if kind in ("progressive", "sampling3"):
        np.testing.assert_array_equal(timg.decode_image(data), _pil(data))
    else:
        with pytest.raises(ValueError, match=words):
            timg.decode_image(data)


def test_read_image_dispatches_on_magic_bytes(tmp_path):
    """The bytes decide, not the name: a PNG called .jpg and a JPEG
    called .png both read; other formats raise naming themselves."""
    rng = np.random.default_rng(9)
    img = _smooth(rng, 12, 10)
    (tmp_path / "a.jpg").write_bytes(timg.encode_png(img))
    np.testing.assert_array_equal(timg.read_image(tmp_path / "a.jpg"),
                                  img.astype(np.float32) / 255)
    data = _jpeg(img, quality=90)
    (tmp_path / "b.png").write_bytes(data)
    np.testing.assert_array_equal(timg.read_image(tmp_path / "b.png"),
                                  _pil(data).astype(np.float32) / 255)
    for fmt, name in (("GIF", "GIF"), ("BMP", "BMP"), ("TIFF", "TIFF")):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, fmt)
        (tmp_path / "c.png").write_bytes(buf.getvalue())
        with pytest.raises(ValueError, match=name):
            timg.read_image(tmp_path / "c.png")
    with pytest.raises(ValueError, match="unknown image format"):
        timg.decode_image(b"\x00\x01\x02\x03 not an image")
    with pytest.raises(ValueError, match="not a JPEG"):
        timg.decode_jpeg(timg.encode_png(img))


def test_jpeg_dataset_loads_as_in_jax(tmp_path):
    """C3: the sphere dataset with its PNGs re-saved as JPEG (quality 95,
    by PIL) loads to the same [N, H, W, 3] array in both packages,
    exactly."""
    ds = tsyn.make_sphere_dataset(n_images=4, h=24, w=24)
    tdata.save_dataset(ds, tmp_path)
    for p in sorted((tmp_path / "images").glob("*.png")):
        Image.open(p).save(p.with_suffix(".jpg"), quality=95)
        p.unlink()
    got = tdata.load_dataset(tmp_path)
    want = jdata.load_dataset(tmp_path)
    assert got.images.shape == (4, 24, 24, 3)
    np.testing.assert_array_equal(got.images, np.asarray(want.images))
    np.testing.assert_array_equal(got.poses, np.asarray(want.poses))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_jpeg", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tiled_frame_equals_pil():
    """``chip_smoke.tile_jpeg`` (the frame the card's host times the
    decoder on) builds a valid JPEG from a fixture that restarts at every
    MCU: PIL decodes it, to the decoder's pixels, and its MCUs are the
    fixture's."""
    src = (FIXTURES / "ycc420_rst1_48x32.jpg").read_bytes()
    data = _chip_smoke().tile_jpeg(src, 70, 100)
    got = timg.decode_jpeg(data)
    assert got.shape == (70, 100, 3)
    np.testing.assert_array_equal(got, _pil(data))
    with pytest.raises(ValueError, match="every MCU"):
        _chip_smoke().tile_jpeg(
            (FIXTURES / "ycc444_24x16.jpg").read_bytes(), 32, 32)


def make_fixtures() -> None:
    """Write the fixtures and ``expected.npz`` (PIL's decodes)."""
    rng = np.random.default_rng(11)
    expected = {}
    for name, (h, w, opts) in FIXTURE_SPECS.items():
        mode = "L" if name.startswith("grey") else "RGB"
        data = _jpeg(_smooth(rng, h, w), mode, **opts)
        (FIXTURES / name).write_bytes(data)
        expected[name] = _pil(data)
    np.savez_compressed(FIXTURES / "expected.npz", **expected)


if __name__ == "__main__":
    make_fixtures()
