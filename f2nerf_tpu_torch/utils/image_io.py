"""Image IO: PNG <-> float32 HWC arrays in [0, 1], and resize (port of
``f2nerf_tpu/utils/image_io.py``).

The JAX package reads, writes and resizes with PIL; PIL is not installed
beside the port on the machine with the card. So PNG is coded here on
``zlib`` + numpy, and the resize is the same operation in PyTorch.

* :func:`write_image`: 8-bit RGB, filter 0 (None) on every row, the
  JAX version's rounding ``clip(x * 255 + 0.5, 0, 255)``.
* :func:`read_image`: 8-bit PNGs of colour type grey, RGB, palette,
  grey + alpha and RGBA, not interlaced, with any of the five row
  filters; alpha is dropped as PIL's ``convert("RGB")`` drops it.
  16-bit or sub-byte depths, interlaced files and anything that is not a
  PNG (a ``.jpg`` dataset) raise ``ValueError`` naming the gap.
"""

from __future__ import annotations

import pathlib
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey+alpha",
                 6: "RGBA"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (8-bit RGB, filter 0 on every row)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"encode_png takes [H, W, 3], got {rgb.shape}")
    raw = np.zeros((h, 1 + 3 * w), dtype=np.uint8)   # filter byte 0
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: data [H, 1 + W*bpp] -> [H, W, bpp] uint8.

    Rows of filter 0 only are a reshape. Otherwise every pixel is
    reconstructed from its left, upper and upper-left neighbours, one
    anti-diagonal of pixels at a time (those depend only on the two
    diagonals before), so H + W - 1 vector steps decode the image."""
    filt = data[:, 0]
    if np.any(filt > 4):
        raise ValueError(f"PNG row filter type {int(filt.max())} is not one "
                         f"of the five defined (0-4)")
    pix = data[:, 1:].reshape(h, w, bpp)
    if not filt.any():
        return pix.copy()
    x = pix.astype(np.int32)
    # recon with a zero row above and a zero column to the left
    rec = np.zeros((h + 1, w + 1, bpp), dtype=np.int32)
    ft = filt.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h, d + 1))
        c = d - r
        a = rec[r + 1, c]          # left
        b = rec[r, c + 1]          # up
        ul = rec[r, c]             # upper left
        f = ft[r][:, None]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, ul))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[r + 1, c + 1] = (x[r, c] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (see the module docstring for
    what is read)."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file: only PNG images can be read "
                         "(JPEG and other formats need PIL, which the port "
                         "does not use)")
    pos, ihdr, palette, idat = 8, None, None, []
    while pos + 12 <= len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        kind = buf[pos + 4:pos + 8]
        data = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if len(data) != n or zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or corrupt")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, comp, filt_method, interlace = ihdr
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} is not defined")
    if depth != 8:
        raise ValueError(f"{depth}-bit {_COLOUR_NAMES[colour]} PNGs are not "
                         f"supported: only bit depth 8 is read")
    if interlace != 0:
        raise ValueError("interlaced (Adam7) PNGs are not supported")
    if comp != 0 or filt_method != 0:
        raise ValueError("PNG compression or filter method is not 0")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {raw.size} bytes, expected "
                         f"{h * (1 + w * bpp)}")
    pix = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        idx = pix[..., 0]
        if idx.max(initial=0) >= len(palette):
            raise ValueError("PNG palette index out of range")
        return palette[idx]
    if colour in (0, 4):
        return np.repeat(pix[..., :1], 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])


def read_image(path: str | pathlib.Path) -> np.ndarray:
    """Read a PNG file -> float32 [H, W, 3] in [0, 1]."""
    return decode_png(pathlib.Path(path).read_bytes()).astype(
        np.float32) / 255.0


def write_image(path: str | pathlib.Path, image: np.ndarray) -> None:
    """Write float32 [H, W, 3] (or [H, W]) in [0, 1] to a PNG file."""
    arr = np.asarray(image)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = np.clip(arr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    pathlib.Path(path).write_bytes(encode_png(arr))


def resize_image(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize float32 [H, W, 3] in [0, 1] -> [h, w, 3]: uint8
    quantization, bilinear with antialiasing (PIL's BILINEAR filter
    widens its support when it shrinks an image), align_corners=False,
    and uint8 rounding of the result."""
    q = np.clip(np.asarray(image) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    x = torch.from_numpy(q).permute(2, 0, 1)[None].float()   # [1, 3, H, W]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).numpy().astype(np.float32) / 255.0
