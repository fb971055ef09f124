"""Port parity for the data layer: the YAML subset (``core/yaml_io.py``),
the PNG codec (``utils/image_io.py``), ``ssim``, the dataset directory
format, the synthetic scene generators and the batch sources, against the
JAX package, PyYAML and PIL on the CPU.

Everything here is exact (bitwise or equal values) except ``ssim``,
atol 1e-12 (the same float64 numpy/scipy operations).
"""

import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

from f2nerf_tpu.core.config import Config as JConfig
from f2nerf_tpu.data import dataset as jdata
from f2nerf_tpu.data import native_loader as jnative
from f2nerf_tpu.data import synthetic as jsyn
from f2nerf_tpu.utils import image_io as jimg
from f2nerf_tpu.utils import metrics as jmetrics
from f2nerf_tpu_torch.core import yaml_io
from f2nerf_tpu_torch.core.config import Config as TConfig
from f2nerf_tpu_torch.data import dataset as tdata
from f2nerf_tpu_torch.data import native_loader as tnative
from f2nerf_tpu_torch.data import synthetic as tsyn
from f2nerf_tpu_torch.utils import image_io as timg
from f2nerf_tpu_torch.utils import metrics as tmetrics

# -- YAML --------------------------------------------------------------------


def _configs(tiny_cfg, occ_cfg):
    return {"tiny": tiny_cfg, "occ": occ_cfg, "default": JConfig(),
            "quality": JConfig.quality()}


@pytest.mark.parametrize("which", ["tiny", "occ", "default", "quality"])
def test_yaml_reads_jax_config(which, tiny_cfg, occ_cfg, tmp_path):
    """train_config.yaml written by the JAX package: yaml_io reads the
    values yaml.safe_load gives, and the port's writer gives its text."""
    cfg = _configs(tiny_cfg, occ_cfg)[which]
    cfg.save(tmp_path / "c.yaml")
    text = (tmp_path / "c.yaml").read_text()
    assert yaml_io.loads(text) == yaml.safe_load(text) == cfg.to_dict()
    tcfg = TConfig.from_dict(dataclasses.asdict(cfg))
    assert yaml_io.dumps(tcfg.to_dict()) == text
    assert TConfig.load(tmp_path / "c.yaml") == tcfg


@pytest.mark.parametrize("which", ["tiny", "quality"])
def test_yaml_port_config_reads_in_pyyaml(which, tiny_cfg, occ_cfg,
                                          tmp_path):
    tcfg = TConfig.from_dict(dataclasses.asdict(
        _configs(tiny_cfg, occ_cfg)[which]))
    tcfg.save(tmp_path / "c.yaml")
    raw = yaml.safe_load((tmp_path / "c.yaml").read_text())
    assert raw == tcfg.to_dict()
    assert JConfig.load(tmp_path / "c.yaml").to_dict() == tcfg.to_dict()


def test_yaml_inference_params(sphere_ds, tmp_path):
    """inference_params.yaml: the port writes JAX's text byte for byte,
    and yaml_io reads it as the JAX localizer does (yaml.safe_load after
    dropping the directive and marker)."""
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    sphere_ds.save_inference_params(tmp_path / "j")
    tds = tdata.Dataset(**{f.name: getattr(sphere_ds, f.name)
                           for f in dataclasses.fields(tdata.Dataset)})
    tds.save_inference_params(tmp_path / "t")
    text = (tmp_path / "j" / "inference_params.yaml").read_text()
    assert (tmp_path / "t" / "inference_params.yaml").read_text() == text
    ref = yaml.safe_load(text.replace("%YAML 1.2", "").replace("---", ""))
    got = yaml_io.loads(text)
    assert got == ref
    assert isinstance(got["height"], int) and len(got["intrinsic"]) == 9


def test_yaml_scalars_match_pyyaml():
    text = ("a: true\nb: off\nc: 1.0e-06\nd: -3\ne: .5\nf: ~\ng: 'x # y'\n"
            "h: \"q\"\ni: 1e-2\nj: [1, 2.5, yes, s]\nk:\nl:\n  m: 1\n"
            "  n:\n    o: 2  # c\n")
    assert yaml_io.loads(text) == yaml.safe_load(text)
    data = {"s": "yes", "t": "1.5", "u": "a b", "v": 1e20, "w": float("inf"),
            "x": [1.0, 2, "z"], "y": {"z": False}}
    assert yaml.safe_load(yaml_io.dumps(data)) == data


@pytest.mark.parametrize("text", [
    "a: &x 1\n", "a: *x\n", "a: !!str 1\n", "a:\n  - 1\n", "a: |\n  x\n",
    "a: >\n  x\n", "a: [1, [2]]\n", "a: {b: {c: 1}}\n", "a:\n\tb: 1\n",
    "a: 010\n", "a: 1\na: 2\n", "a: 1\n---\nb: 2\n", "- 1\n",
    "a: 'x\n"])
def test_yaml_rejects_outside_the_subset(text):
    with pytest.raises(ValueError, match="line"):
        yaml_io.loads(text)


# -- PNG ---------------------------------------------------------------------


def _pil_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _smooth(rng, h, w, c):
    """uint8 [h, w, c] with smooth areas and noise, so every filter
    predicts something."""
    base = rng.random((h // 4 + 2, w // 4 + 2, c))
    up = np.repeat(np.repeat(base, 4, 0), 4, 1)[:h, :w]
    return np.clip(up * 230 + rng.integers(0, 25, (h, w, c)), 0,
                   255).astype(np.uint8)


def test_png_write_reads_in_pil(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((29, 41, 3)).astype(np.float32)
    img[0, 0] = [-0.1, 1.2, 0.5]                 # clipped like JAX
    timg.write_image(tmp_path / "t.png", img)
    jimg.write_image(tmp_path / "j.png", img)
    with Image.open(tmp_path / "t.png") as im:
        assert im.mode == "RGB"
        got = np.asarray(im)
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path /
                                                             "j.png")))
    np.testing.assert_array_equal(timg.read_image(tmp_path / "t.png"),
                                  jimg.read_image(tmp_path / "t.png"))
    # a 2-D image is repeated to 3 channels
    timg.write_image(tmp_path / "g.png", img[..., 0])
    jimg.write_image(tmp_path / "gj.png", img[..., 0])
    np.testing.assert_array_equal(timg.read_image(tmp_path / "g.png"),
                                  jimg.read_image(tmp_path / "gj.png"))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_reads_pil_files(mode, tmp_path):
    """Files PIL writes (adaptive filters) read as PIL's convert("RGB")
    reads them, alpha dropped."""
    rng = np.random.default_rng(len(mode))
    if mode in ("RGB", "RGBA", "LA"):
        arr = _smooth(rng, 37, 53, {"RGB": 3, "RGBA": 4, "LA": 2}[mode])
        data = _pil_png(arr)
    elif mode == "L":
        data = _pil_png(_smooth(rng, 37, 53, 1)[..., 0])
    else:
        rgb = Image.fromarray(_smooth(rng, 37, 53, 3))
        buf = io.BytesIO()
        rgb.quantize(colors=40).save(buf, format="PNG")
        data = buf.getvalue()
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == mode
    (tmp_path / "x.png").write_bytes(data)
    np.testing.assert_array_equal(timg.decode_png(data), _pil_rgb(data))
    np.testing.assert_array_equal(timg.read_image(tmp_path / "x.png"),
                                  jimg.read_image(tmp_path / "x.png"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _encode_filtered(pix: np.ndarray, colour: int, filters) -> bytes:
    """A PNG of uint8 [H, W, bpp] with row r filtered by filters[r]
    (a plain loop over bytes, the specification's arithmetic)."""
    h, w, bpp = pix.shape
    rows = pix.reshape(h, w * bpp).astype(np.int64)
    out = bytearray()
    for r in range(h):
        f = filters[r]
        out.append(f)
        for i in range(w * bpp):
            a = rows[r, i - bpp] if i >= bpp else 0
            b = rows[r - 1, i] if r > 0 else 0
            c = rows[r - 1, i - bpp] if r > 0 and i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[f]
            out.append(int(rows[r, i] - pred) & 0xFF)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("colour", [2, 6, 4])
def test_png_filter_types(filt, colour, tmp_path):
    """Each row filter, on its own and mixed row by row, for RGB, RGBA
    and grey+alpha: the file decodes in PIL to the pixels it was made
    from, and the port decodes it as PIL does."""
    bpp = {2: 3, 6: 4, 4: 2}[colour]
    rng = np.random.default_rng(7 + colour)
    pix = _smooth(rng, 13, 17, bpp)
    filters = ([filt] * 13 if filt != "mixed"
               else list(rng.integers(0, 5, 13)))
    data = _encode_filtered(pix, colour, filters)
    with Image.open(io.BytesIO(data)) as im:
        raw = np.asarray(im)
    np.testing.assert_array_equal(raw.reshape(pix.shape), pix)
    np.testing.assert_array_equal(timg.decode_png(data), _pil_rgb(data))


def test_png_rejects_what_it_does_not_read(tmp_path):
    """16-bit, interlaced and JPEG files raise naming the gap in the plain
    PNG decoder; since the compiled codec (C5), ``read_image`` reads the
    16-bit and interlaced files to the JAX package's pixels
    (``test_torch_image_codec.py`` holds the codec), and since the JPEG
    decoder (C3) it and ``load_dataset`` read the JPEG files to PIL's
    pixels (``test_torch_jpeg.py`` holds that decoder)."""
    deep = _pil_png(np.arange(60, dtype=np.uint16).reshape(6, 10) * 1000)
    with pytest.raises(ValueError, match="16-bit"):
        timg.decode_png(deep)
    interlaced = bytearray(_encode_filtered(np.zeros((2, 2, 3), np.uint8),
                                            2, [0, 0]))
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1)
    interlaced[16:29] = ihdr
    interlaced[29:33] = struct.pack(
        ">I", zlib.crc32(b"IHDR" + ihdr) & 0xFFFFFFFF)
    with pytest.raises(ValueError, match="interlaced"):
        timg.decode_png(bytes(interlaced))
    # a whole Adam7 file: passes 1, 6 and 7 of a 2x2 image, filter 0 (the
    # file above holds too few bytes for them: PIL refuses it too)
    px = _smooth(np.random.default_rng(5), 2, 2, 3)
    raw = b"".join(b"\x00" + p.tobytes() for p in (px[0, 0], px[0, 1], px[1]))
    idat = zlib.compress(raw)
    adam7 = (bytes(interlaced[:33]) + struct.pack(">I", len(idat)) + b"IDAT"
             + idat + struct.pack(">I", zlib.crc32(b"IDAT" + idat)
                                  & 0xFFFFFFFF) + interlaced[-12:])
    for name, data in (("deep.png", deep), ("adam7.png", adam7)):
        (tmp_path / name).write_bytes(data)
        np.testing.assert_array_equal(timg.read_image(tmp_path / name),
                                      jimg.read_image(tmp_path / name))
    (tmp_path / "ds" / "images").mkdir(parents=True)
    ds = tsyn.make_sphere_dataset(n_images=2, h=8, w=8)
    tdata.save_dataset(ds, tmp_path / "ds")
    for n in range(2):
        p = tmp_path / "ds" / "images" / f"{n:06d}.png"
        Image.open(p).save(p.with_suffix(".jpg"))
        p.unlink()
    jpg = tmp_path / "ds" / "images" / "000000.jpg"
    with pytest.raises(ValueError, match="not a PNG"):
        timg.decode_png(jpg.read_bytes())
    pil = np.stack([np.asarray(Image.open(tmp_path / "ds" / "images" /
                                          f"{n:06d}.jpg").convert("RGB"))
                    for n in range(2)]).astype(np.float32) / 255
    np.testing.assert_array_equal(timg.read_image(jpg), pil[0])
    np.testing.assert_array_equal(tdata.load_dataset(tmp_path / "ds").images,
                                  pil)


# -- metrics -----------------------------------------------------------------


def test_ssim_matches_jax():
    rng = np.random.default_rng(3)
    gt = rng.random((40, 52, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    for a, b in ((pred, gt), (gt, gt)):
        np.testing.assert_allclose(tmetrics.ssim(a, b), jmetrics.ssim(a, b),
                                   rtol=0, atol=1e-12)
    assert tmetrics.ssim(gt, gt) == pytest.approx(1.0)


# -- generators and the dataset directory ------------------------------------


GENERATORS = {
    "sphere": dict(n_images=3, h=12, w=16),
    "checker": dict(n_images=3, h=12, w=16),
    "corridor": dict(n_images=3, h=12, w=16),
    "textured": dict(n_images=3, h=12, w=16),
    "longtraj": dict(n_images=3, h=12, w=16),
    "objcap": dict(n_images=3, h=12, w=16),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generators_bitwise(name):
    kw = GENERATORS[name]
    j = getattr(jsyn, f"make_{name}_dataset")(**kw)
    t = getattr(tsyn, f"make_{name}_dataset")(**kw)
    assert isinstance(t, tdata.Dataset)
    for f in dataclasses.fields(jdata.Dataset):
        a, b = getattr(j, f.name), getattr(t, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert t.images.std() > 0.01


def _assert_same(a, b):
    for f in dataclasses.fields(jdata.Dataset):
        np.testing.assert_array_equal(getattr(b, f.name), getattr(a, f.name),
                                      err_msg=f.name)


def test_dataset_directory_round_trip(tmp_path):
    """A directory written by JAX save_dataset (PIL, adaptive filters)
    loads into equal arrays in both packages, and so does one written by
    the port (filter 0)."""
    ds = jsyn.make_textured_dataset(n_images=4, h=20, w=28)
    jdata.save_dataset(ds, tmp_path / "j")
    tdata.save_dataset(tsyn.make_textured_dataset(n_images=4, h=20, w=28),
                       tmp_path / "t")
    assert ((tmp_path / "j" / "cams_meta.tsv").read_text()
            == (tmp_path / "t" / "cams_meta.tsv").read_text())
    for d in ("j", "t"):
        a = jdata.load_dataset(tmp_path / d)
        b = tdata.load_dataset(tmp_path / d)
        _assert_same(a, b)
        assert a.radius == b.radius
    _assert_same(jdata.load_dataset(tmp_path / "j"),
                 tdata.load_dataset(tmp_path / "t"))


def test_sample_batch_same_stream(sphere_ds):
    tds = tdata.Dataset(**{f.name: getattr(sphere_ds, f.name)
                           for f in dataclasses.fields(tdata.Dataset)})
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        for a, b in zip(sphere_ds.sample_batch(rj, 257),
                        tds.sample_batch(rt, 257)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_native_loader_same_stream(sphere_ds):
    """The port's binding to native/libf2loader.so gives the JAX
    binding's batches for one seed (skipped if the library is absent)."""
    if not (jnative.available() and tnative.available()):
        pytest.skip("native/libf2loader.so does not load here")
    a = jnative.NativeBatchLoader(sphere_ds.images, 96, seed=11)
    b = tnative.NativeBatchLoader(sphere_ds.images, 96, seed=11)
    try:
        for _ in range(4):
            for x, y in zip(a.next(), b.next()):
                np.testing.assert_array_equal(y, x)
    finally:
        a.close()
        b.close()
