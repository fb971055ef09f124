"""Image IO: PNG and JPEG -> float32 HWC arrays in [0, 1], PNG writing,
and resize (port of ``f2nerf_tpu/utils/image_io.py``).

The JAX package reads, writes and resizes with PIL; PIL is not installed
beside the port on the machine with the card. So images are decoded by
the port's own compiled codec (``csrc/image_codec.cpp``), PNG is written
on ``zlib`` + numpy, and the resize is the same operation in PyTorch.

* :func:`read_image` (:func:`decode_image` on the file's bytes) picks the
  format by the file's magic bytes, not its extension, and decodes with
  the codec only: the C++ library is built at first use by the system's
  C++ compiler (``kernels/build.py``), and where it cannot be built the
  call raises with the compiler's log. Its pixels are PIL's
  ``convert("RGB")`` exactly:

  - JPEG: baseline, extended-sequential and progressive Huffman files
    (SOF0-2) of 8-bit precision, grey or three components (YCbCr, or RGB
    where the file says so), sampling factors 1 to 4 at whole ratios, 8-
    and 16-bit quantization tables, restart intervals, Annex K's Huffman
    tables where a file defines none; libjpeg-turbo's ``JDCT_ISLOW``
    IDCT, block smoothing of progressive files left unrefined, fancy
    upsampling and fixed-point YCbCr -> RGB. Lossless, hierarchical and arithmetic-coded
    files, 12-bit precision, 2- or 4-component (CMYK / YCCK) files and
    fractional sampling ratios raise ``ValueError`` naming the gap.
  - PNG: every colour type at every bit depth the standard allows (grey
    at 1/2/4/8/16, palette at 1/2/4/8, grey + alpha, RGB and RGBA at
    8/16), Adam7 interlaced or not, the five row filters; IDAT is
    inflated by Python's ``zlib`` here, the codec unfilters,
    de-interlaces and converts as PIL's modes do (16-bit grey saturates
    at 255, other 16-bit samples keep their high byte, sub-byte grey is
    scaled, alpha and tRNS are dropped).

* :func:`decode_png` and :func:`decode_jpeg`: the plain versions, in
  numpy, which the tests and ``chip_smoke.py`` hold the codec against.
  ``decode_png`` reads 8-bit PNGs of every colour type, not interlaced,
  with any of the five row filters; 16-bit or sub-byte depths and
  interlaced files raise ``ValueError`` naming the gap. ``decode_jpeg``
  reads baseline and extended-sequential Huffman JPEGs (SOF0, SOF1) as
  the codec does, the Huffman stream in Python; progressive files and
  the kinds the codec does not read raise ``ValueError`` naming the gap.
* :func:`write_image`: 8-bit RGB, filter 0 (None) on every row, the
  JAX version's rounding ``clip(x * 255 + 0.5, 0, 255)``.
"""

from __future__ import annotations

import array
import ctypes
import functools
import pathlib
import re
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from f2nerf_tpu_torch.kernels import build

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


def _png_chunks(buf: bytes) -> tuple[tuple, bytes | None, bytes]:
    """The IHDR fields, the PLTE payload (None without one) and the
    joined IDAT payloads of a PNG; every chunk's CRC is checked."""
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
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
            palette = data
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    if palette is not None and len(palette) % 3:
        raise ValueError(f"PNG palette of {len(palette)} bytes is not RGB "
                         f"entries")
    return ihdr, palette, b"".join(idat)


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB (see the module docstring for
    what is read)."""
    ihdr, palette, idat = _png_chunks(buf)
    if palette is not None:
        palette = np.frombuffer(palette, dtype=np.uint8).reshape(-1, 3)
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
    raw = np.frombuffer(zlib.decompress(idat), dtype=np.uint8)
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


# -- JPEG ------------------------------------------------------------------

JPEG_SOI = b"\xff\xd8"
_OTHER_FORMATS = ((rb"GIF8[79]a", "GIF"), (rb"BM", "BMP"),
                  (rb"II\*\x00|MM\x00\*", "TIFF"),
                  (rb"RIFF....WEBP", "WebP"))
# what each start-of-frame marker other than SOF0 / SOF1 codes
_SOF_GAPS = {
    0xC2: "progressive JPEG (SOF2)", 0xC3: "lossless JPEG (SOF3)",
    0xC5: "hierarchical JPEG (SOF5)", 0xC6: "hierarchical progressive "
    "JPEG (SOF6)", 0xC7: "hierarchical lossless JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded "
    "progressive JPEG (SOF10)", 0xCB: "arithmetic-coded lossless JPEG "
    "(SOF11)", 0xCD: "arithmetic-coded hierarchical JPEG (SOF13)",
    0xCE: "arithmetic-coded hierarchical progressive JPEG (SOF14)",
    0xCF: "arithmetic-coded hierarchical lossless JPEG (SOF15)"}
_STRIDE = 80           # coefficient slots a block: 64, and 16 for overruns
_WINDOW = 6            # bytes of Huffman data peeked at each bit position


def _zigzag() -> np.ndarray:
    """Natural (row-major) index of each zigzag position."""
    order = []
    for s in range(15):
        lo, hi = max(0, s - 7), min(s, 7)
        rows = range(hi, lo - 1, -1) if s % 2 == 0 else range(lo, hi + 1)
        order += [r * 8 + s - r for r in rows]
    return np.array(order)


_ZIGZAG = _zigzag()


def _idct_range_limit() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by the descaled value & 1023:
    the value + 128 (CENTERJSAMPLE) clamped to [0, 255] for values in
    [-512, 511]; values outside wrap as the table's mask makes them."""
    x = np.arange(1024)
    return np.select([x < 128, x < 512, x < 896], [x + 128, 255, 0],
                     x - 896).astype(np.uint8)


_RANGE_LIMIT = _idct_range_limit()


def _huffman_lookup(counts: bytes, symbols: bytes
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The canonical code of a DHT table as a 16-bit lookahead: for every
    16-bit window of the stream, (length of the code it starts with,
    symbol). Windows that start with no code decode as symbol 0 after 16
    bits, as libjpeg fakes a zero for a bad code."""
    length = np.full(65536, 16, np.int64)
    symbol = np.zeros(65536, np.int64)
    code = i = 0
    for n_bits in range(1, 17):
        for _ in range(counts[n_bits - 1]):
            lo, hi = code << (16 - n_bits), (code + 1) << (16 - n_bits)
            if hi > 65536:
                raise ValueError("corrupt JPEG: a Huffman table assigns "
                                 "more codes than its lengths allow")
            length[lo:hi] = n_bits
            symbol[lo:hi] = symbols[i]
            code += 1
            i += 1
        code <<= 1
    return length, symbol


def _extend(bits: np.ndarray, s: np.ndarray) -> np.ndarray:
    """HUFF_EXTEND: ``s`` magnitude bits -> the signed value."""
    return np.where(bits < (1 << np.maximum(s - 1, 0)),
                    bits - (1 << s) + 1, bits)


# a camera's frames share their tables: built once per distinct table
@functools.lru_cache(maxsize=16)
def _dc_table(counts: bytes, symbols: bytes) -> tuple:
    """Per 16-bit window: (code length, magnitude bits to read)."""
    if any(s > 15 for s in symbols):
        raise ValueError("corrupt JPEG: a DC Huffman table has a symbol "
                         "above 15")
    length, symbol = _huffman_lookup(counts, symbols)
    return tuple(zip(length.tolist(), symbol.tolist()))


@functools.lru_cache(maxsize=16)
def _ac_table(counts: bytes, symbols: bytes) -> tuple:
    """Per 16-bit window, one of:
    (code + magnitude bits, zero run, value) where both fit in the window
    (value 0: run 15 is a ZRL, run 0 an end of block), or
    (0, code length, run/size symbol) where the magnitude bits do not."""
    length, rs = _huffman_lookup(counts, symbols)
    look = np.arange(65536)
    s, run = rs & 15, rs >> 4
    fits = length + s <= 16
    shift = np.where(fits, 16 - length - s, 0)
    value = _extend((look >> shift) & ((1 << s) - 1), s)
    # a zero size with a run other than 15 ends the block, as in libjpeg
    run = np.where(s > 0, run, np.where(run == 15, 15, 0))
    value = np.where(s > 0, value, 0)
    first = np.where(fits, length + s, 0)
    second = np.where(fits, run, length)
    third = np.where(fits, value, rs)
    return tuple(zip(first.tolist(), second.tolist(), third.tolist()))


def _segment(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """The marker at ``pos`` (fill bytes and stray bytes skipped, as
    libjpeg skips them): (marker, its payload, position after it)."""
    while pos < len(buf) and buf[pos] != 0xFF:
        pos += 1
    while pos < len(buf) and buf[pos] == 0xFF:
        pos += 1
    if pos >= len(buf):
        raise ValueError("corrupt JPEG: the file ends before EOI")
    marker = buf[pos]
    pos += 1
    if marker in (0x01, 0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
        return marker, b"", pos
    (n,) = struct.unpack(">H", buf[pos:pos + 2])
    if n < 2 or pos + n > len(buf):
        raise ValueError(f"corrupt JPEG: marker 0x{marker:02X} segment is "
                         f"truncated")
    return marker, buf[pos + 2:pos + n], pos + n


_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff[\xd0-\xd7]")


def _scan_windows(buf: bytes, start: int) -> tuple[list, list, int]:
    """The entropy-coded data from ``start`` up to the next marker that
    is not a restart: (windows, start byte of each restart interval, end
    position). The intervals are unstuffed (0xFF00 -> 0xFF), stripped of
    fill bytes and each followed by zero bytes, so that reading past an
    interval's end reads zeros, as libjpeg does; ``windows[i]`` holds the
    ``_WINDOW`` bytes from byte ``i`` as one big-endian int."""
    m = _SCAN_END.search(buf, start)
    end = m.start() if m else len(buf)
    parts, starts, at = [], [], 0
    for raw in _RESTART.split(buf[start:end]):
        seg = raw.rstrip(b"\xff").replace(b"\xff\x00", b"\xff")
        starts.append(at)
        parts.append(seg + bytes(_WINDOW))
        at += len(seg) + _WINDOW
    data = np.frombuffer(b"".join(parts) + bytes(_WINDOW), dtype=np.uint8)
    n = len(data) - _WINDOW
    win = np.zeros(n, np.int64)
    for j in range(_WINDOW):
        win = (win << 8) | data[j:j + n]
    return win.tolist(), starts, end


def _decode_scan(win: list, starts: list, n_mcu: int, restart: int,
                 layout: list, n_comp: int) -> np.ndarray:
    """Huffman-decode one scan: ``n_mcu`` MCUs of the blocks ``layout``
    names ((predictor slot, DC table, AC table) each), restarting every
    ``restart`` MCUs (0: never). Returns int64 [n_mcu * len(layout),
    64], the coefficients in zigzag order."""
    per = restart or n_mcu
    n_int = -(-n_mcu // per) if n_mcu else 0
    if n_int > len(starts):
        raise ValueError(f"corrupt JPEG: {len(starts)} restart intervals "
                         f"for {n_int}")
    coef = array.array("q", bytes(8 * _STRIDE * n_mcu * len(layout)))
    b = 0
    for j in range(n_int):
        p = starts[j] * 8
        pred = [0] * n_comp
        for _ in range(min(per, n_mcu - j * per)):
            for ci, dct, act in layout:
                w = win[p >> 3]
                o = p & 7
                n_bits, s = dct[(w >> (32 - o)) & 0xFFFF]
                p += n_bits
                if s:
                    x = (w >> (48 - o - n_bits - s)) & ((1 << s) - 1)
                    p += s
                    if x < (1 << (s - 1)):
                        x -= (1 << s) - 1
                    pred[ci] += x
                coef[b] = pred[ci]
                k = 1
                while k < 64:
                    w = win[p >> 3]
                    nb, r, v = act[(w >> (32 - (p & 7))) & 0xFFFF]
                    if nb:
                        p += nb
                        if v:
                            k += r
                            coef[b + k] = v
                            k += 1
                        elif r:
                            k += 16
                        else:
                            break
                    else:
                        # a code and magnitude longer than 16 bits
                        o = p & 7
                        s = v & 15
                        k += v >> 4
                        x = (w >> (48 - o - r - s)) & ((1 << s) - 1)
                        p += r + s
                        if x < (1 << (s - 1)):
                            x -= (1 << s) - 1
                        coef[b + k] = x
                        k += 1
                b += _STRIDE
    out = np.frombuffer(coef, dtype=np.int64).reshape(-1, _STRIDE).copy()
    # a zero run past a block's end writes at position 63, as libjpeg's
    # padded natural-order table makes it; the last such write stays
    for row in np.nonzero(out[:, 64:].any(axis=1))[0]:
        tail = out[row, 63:]
        out[row, 63] = tail[np.nonzero(tail)[0][-1]]
    return out[:, :64]


def _idct_1d(x: list, shift: int) -> list:
    """One pass of ``jpeg_idct_islow`` (CONST_BITS 13) over the eight
    inputs ``x`` (int64 arrays), descaled by ``shift`` bits."""
    z1 = (x[2] + x[6]) * 4433                     # FIX_0_541196100
    tmp2 = z1 + x[6] * -15137                     # FIX_1_847759065
    tmp3 = z1 + x[2] * 6270                       # FIX_0_765366865
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * 9633                         # FIX_1_175875602
    t0 = t0 * 2446                                # FIX_0_298631336
    t1 = t1 * 16819                               # FIX_2_053119869
    t2 = t2 * 25172                               # FIX_3_072711026
    t3 = t3 * 12299                               # FIX_1_501321110
    z1 = z1 * -7373                               # FIX_0_899976223
    z2 = z2 * -20995                              # FIX_2_562915447
    z3 = z3 * -16069 + z5                         # FIX_1_961570560
    z4 = z4 * -3196 + z5                          # FIX_0_390180644
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(coef: np.ndarray) -> np.ndarray:
    """int64 [N, 8, 8] dequantized coefficients (row = vertical
    frequency) -> uint8 [N, 8, 8] samples: columns first (PASS1_BITS 2),
    then rows, +128 and the range limit."""
    ws = np.stack(_idct_1d([coef[:, u, :] for u in range(8)], 13 - 2),
                  axis=1)
    out = np.stack(_idct_1d([ws[:, :, u] for u in range(8)], 13 + 2 + 3),
                   axis=2)
    return _RANGE_LIMIT[out & 1023]


def _edge(x: np.ndarray, axis: int, step: int) -> np.ndarray:
    """``x`` shifted by one along ``axis`` (step -1: each element's
    predecessor, +1: its successor), the edge element repeated."""
    n = x.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(x, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        *a.shape[:axis], 2 * a.shape[axis], *a.shape[axis + 1:])


def _upsample(plane: np.ndarray, dh: int, dw: int, fy: int, fx: int
              ) -> np.ndarray:
    """libjpeg-turbo's upsampling of a component whose real size is dh x
    dw by (fy, fx) in {1, 2}: ``h2v1_fancy_upsample``,
    ``h1v2_fancy_upsample`` and ``h2v2_fancy_upsample`` (the plain
    replication ``h2v1_upsample`` / ``h2v2_upsample`` where dw <= 2), with
    their edge rules: the last column and row are the real ones, not the
    MCU padding."""
    if (fy, fx) == (1, 1):
        return plane
    x = plane[:dh, :dw].astype(np.int32)
    if fx == 2 and dw <= 2:
        return np.repeat(np.repeat(x, fx, axis=1), fy, axis=0)
    if fx == 1:
        return _interleave((3 * x + _edge(x, 0, -1) + 1) >> 2,
                           (3 * x + _edge(x, 0, 1) + 2) >> 2, 0)
    if fy == 1:
        return _interleave((3 * x + _edge(x, 1, -1) + 1) >> 2,
                           (3 * x + _edge(x, 1, 1) + 2) >> 2, 1)
    rows = []
    for c in (3 * x + _edge(x, 0, -1), 3 * x + _edge(x, 0, 1)):
        rows.append(_interleave((3 * c + _edge(c, 1, -1) + 8) >> 4,
                                (3 * c + _edge(c, 1, 1) + 7) >> 4, 1))
    return _interleave(rows[0], rows[1], 0)


def _ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray
                ) -> np.ndarray:
    """``jdcolor.c``'s ``ycc_rgb_convert`` (SCALEBITS 16, its tables)."""
    def fix(v: float) -> int:
        return int(v * 65536 + 0.5)

    half = 1 << 15
    y = y.astype(np.int32)
    cb = cb.astype(np.int32) - 128
    cr = cr.astype(np.int32) - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb + half - fix(0.71414) * cr) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(buf: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] RGB (see the module docstring for
    what is read). The Huffman stream is decoded in Python with 16-bit
    lookahead tables; dequantization, the IDCT, upsampling and colour
    conversion run in numpy over all blocks at once."""
    if buf[:2] != JPEG_SOI:
        raise ValueError("not a JPEG file")
    qt: dict[int, np.ndarray] = {}
    dc: dict[int, tuple] = {}
    ac: dict[int, tuple] = {}
    restart = 0
    frame = None
    jfif = False
    adobe = None
    comps: list[dict] = []
    pos = 2
    while True:
        marker, seg, pos = _segment(buf, pos)
        if marker == 0xD9:
            break
        if marker in _SOF_GAPS:
            raise ValueError(f"{_SOF_GAPS[marker]} is not supported: only "
                             f"baseline and extended-sequential Huffman "
                             f"JPEGs (SOF0, SOF1) are read")
        if marker in (0xC8, 0xCC):
            raise ValueError("arithmetic-coded JPEG (DAC / JPG marker) is "
                             "not supported: only Huffman coding is read")
        if marker in (0xC0, 0xC1):
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise ValueError(f"{prec}-bit JPEG is not supported: only "
                                 f"8-bit precision is read")
            if nc not in (1, 3):
                kind = (" (CMYK / YCCK)" if nc == 4 else "")
                raise ValueError(f"{nc}-component JPEG{kind} is not "
                                 f"supported: only grey (1) and 3 "
                                 f"components are read")
            if h == 0 or w == 0:
                raise ValueError("JPEG with a zero or DNL-defined size is "
                                 "not supported")
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                if (hv >> 4) not in (1, 2) or (hv & 15) not in (1, 2):
                    raise ValueError(f"JPEG sampling factors {hv >> 4}x"
                                     f"{hv & 15} are not supported: only 1 "
                                     f"or 2 are read")
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15,
                              "tq": tq, "q": None})
            frame = (h, w)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
            for c in comps:
                c["coef"] = np.zeros((my * c["v"], mx * c["h"], 64),
                                     np.int64)
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                n = sum(counts)
                symbols = seg[i + 17:i + 17 + n]
                if len(counts) < 16 or len(symbols) < n or tc > 1:
                    raise ValueError("corrupt JPEG: bad DHT segment")
                table = (_ac_table if tc else _dc_table)(bytes(counts),
                                                         bytes(symbols))
                (ac if tc else dc)[th] = table
                i += 17 + n
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + size],
                                    dtype=">u2" if pq else np.uint8)
                if raw.size != 64:
                    raise ValueError("corrupt JPEG: bad DQT segment")
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = raw
                qt[tq] = q
                i += 1 + size
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG: a scan before the frame "
                                 "header")
            pos = _read_scan(buf, pos, seg, comps, frame, qt, dc, ac,
                             restart)
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    return _reconstruct(comps, frame, jfif, adobe)


def _read_scan(buf: bytes, pos: int, seg: bytes, comps: list, frame: tuple,
               qt: dict, dc: dict, ac: dict, restart: int) -> int:
    """Decode the scan whose SOS payload is ``seg`` into the components'
    coefficient arrays; returns the position after its data."""
    h, w = frame
    ns = seg[0]
    by_id = {c["id"]: c for c in comps}
    scan = []
    for i in range(ns):
        cid, t = seg[1 + 2 * i:3 + 2 * i]
        if cid not in by_id or (t >> 4) not in dc or (t & 15) not in ac:
            raise ValueError("corrupt JPEG: a scan names an undefined "
                             "component or Huffman table")
        c = by_id[cid]
        if c["q"] is None:        # latched at the component's first scan
            if c["tq"] not in qt:
                raise ValueError(f"corrupt JPEG: quantization table "
                                 f"{c['tq']} is not defined")
            c["q"] = qt[c["tq"]]
        scan.append((c, dc[t >> 4], ac[t & 15]))
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    if ns == 1:
        c = scan[0][0]
        bw = -(-(-(-w * c["h"] // hmax)) // 8)
        bh = -(-(-(-h * c["v"] // vmax)) // 8)
        layout = [(0, scan[0][1], scan[0][2])]
        rows = np.repeat(np.arange(bh), bw)[:, None]
        cols = np.tile(np.arange(bw), bh)[:, None]
        places = [(c, rows, cols)]
        n_mcu = bw * bh
    else:
        mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
        n_mcu = mx * my
        layout, places = [], []
        mcu_y = np.repeat(np.arange(my), mx)[:, None]
        mcu_x = np.tile(np.arange(mx), my)[:, None]
        for slot, (c, dct, act) in enumerate(scan):
            layout += [(slot, dct, act)] * (c["h"] * c["v"])
            sub = np.arange(c["h"] * c["v"])[None, :]
            places.append((c, mcu_y * c["v"] + sub // c["h"],
                           mcu_x * c["h"] + sub % c["h"]))
    win, starts, end = _scan_windows(buf, pos)
    coef = _decode_scan(win, starts, n_mcu, restart, layout, ns)
    coef = coef.reshape(n_mcu, len(layout), 64)
    at = 0
    for c, rows, cols in places:
        n = rows.shape[1]
        c["coef"][rows, cols] = coef[:, at:at + n]
        at += n
    return end


def _reconstruct(comps: list, frame: tuple, jfif: bool, adobe: int | None
                 ) -> np.ndarray:
    """Dequantize, IDCT, upsample and convert the decoded components."""
    h, w = frame
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    natural = np.argsort(_ZIGZAG)
    planes = []
    for c in comps:
        if c["q"] is None:
            raise ValueError("corrupt JPEG: a component has no scan")
        coef = c["coef"]
        by, bx = coef.shape[:2]
        # JCOEF and the islow multiplier table are 16-bit in libjpeg
        zz = coef[..., natural].astype(np.int16).astype(np.int64)
        q = c["q"].astype(np.int16).astype(np.int64)
        blocks = _idct_islow((zz * q).reshape(-1, 8, 8))
        plane = blocks.reshape(by, bx, 8, 8).transpose(0, 2, 1, 3).reshape(
            by * 8, bx * 8)
        dh = -(-h * c["v"] // vmax)
        dw = -(-w * c["h"] // hmax)
        planes.append(_upsample(plane, dh, dw, vmax // c["v"],
                                hmax // c["h"])[:h, :w])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    # libjpeg's guess of the colour space: JFIF means YCbCr, else an
    # Adobe marker's transform says, else component ids 'R', 'G', 'B'
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = tuple(c["id"] for c in comps) == (82, 71, 66)
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return _ycc_to_rgb(*planes)


# -- the compiled codec -----------------------------------------------------

_ERR_LEN = 512


def _codec() -> ctypes.CDLL:
    """``csrc/image_codec.cpp``, built at first use (raises with the
    compiler's log where it cannot be)."""
    lib = build.load_library("image_codec")
    if not hasattr(lib, "signatures_set"):
        sz, i32, ptr, buf = (ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_char_p)
        for fn, args in (
                (lib.f2_jpeg_size, [buf, sz, ctypes.POINTER(i32),
                                    ctypes.POINTER(i32), buf, sz]),
                (lib.f2_jpeg_decode, [buf, sz, ptr, i32, i32, buf, sz]),
                (lib.f2_png_decode, [buf, sz, i32, i32, i32, i32, i32, buf,
                                     i32, ptr, buf, sz])):
            fn.argtypes, fn.restype = args, i32
        lib.signatures_set = True
    return lib


def _check(rc: int, err: ctypes.Array) -> None:
    if rc == 2:
        raise MemoryError("the image codec ran out of memory")
    if rc:
        raise ValueError(err.value.decode(errors="replace"))


def _codec_jpeg(buf: bytes) -> np.ndarray:
    lib = _codec()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w = ctypes.c_int(), ctypes.c_int()
    _check(lib.f2_jpeg_size(buf, len(buf), ctypes.byref(h), ctypes.byref(w),
                            err, _ERR_LEN), err)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _check(lib.f2_jpeg_decode(buf, len(buf), out.ctypes.data, h.value,
                              w.value, err, _ERR_LEN), err)
    return out


def _codec_png(buf: bytes) -> np.ndarray:
    (w, h, depth, colour, comp, filt_method, interlace), palette, idat = \
        _png_chunks(buf)
    if comp != 0 or filt_method != 0:
        raise ValueError("PNG compression or filter method is not 0")
    lib = _codec()
    raw = zlib.decompress(idat)
    palette = palette or b""
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    _check(lib.f2_png_decode(raw, len(raw), w, h, depth, colour, interlace,
                             palette, len(palette) // 3, out.ctypes.data,
                             err, _ERR_LEN), err)
    return out


def decode_image(buf: bytes) -> np.ndarray:
    """PNG or JPEG bytes -> uint8 [H, W, 3] RGB, by the magic bytes,
    through the compiled codec."""
    buf = bytes(buf)
    if buf[:4] == PNG_SIGNATURE[:4]:
        return _codec_png(buf)
    if buf[:2] == JPEG_SOI:
        return _codec_jpeg(buf)
    for magic, name in _OTHER_FORMATS:
        if re.match(magic, buf[:12]):
            raise ValueError(f"{name} images are not supported: only PNG "
                             f"and JPEG are read")
    raise ValueError(f"unknown image format (first bytes {buf[:8]!r}): "
                     f"only PNG and JPEG are read")


def read_image(path: str | pathlib.Path) -> np.ndarray:
    """Read a PNG or JPEG file -> float32 [H, W, 3] in [0, 1]."""
    return decode_image(pathlib.Path(path).read_bytes()).astype(
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
