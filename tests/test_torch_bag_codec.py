"""The port's compiled chunk codec (``f2nerf_tpu_torch/utils/csrc/
chunk_codec.cpp`` through ``utils/decompress.py``, the only decoder behind
``rosbag_reader.read_bag_mcap``'s compressed chunks), held byte for byte:

* Zstandard against ``zstandard`` (what the JAX package's reader calls):
  levels -5 to 22, checksums and content sizes on and off, a large
  window and long-distance matching, random (raw blocks), run (RLE
  blocks), word-like and JPEG inputs, frames of several blocks,
  ``compressobj`` streams cut by ``FLUSH_BLOCK`` (predefined, RLE and
  repeat tables, treeless literals), inputs built to reach the rarer
  modes (RLE literals, direct Huffman weights, a 3-byte sequence count,
  the ``rep1 - 1`` offset, no sequences), every content-size width, and
  concatenated and skippable frames (against ``zstandard``'s reader
  across frames).
* LZ4 frames against the input of ``tests/_lz4_frame.py``, a writer built
  from the format's description (the tests do not depend on the ``lz4``
  module), over its flag matrix, and against a frame written out by hand
  here (its header checksum byte is the ``lz4`` tool's for these flags).
* Truncated, bit-flipped and mis-sized input raises ``ValueError`` and
  never crashes the process.
* The committed fixtures (``tests/torch_fixtures/bag``, written by this
  file's ``__main__``) decode to their stored lengths and SHA-256s and
  together reach every mode the codec counts; the two fixture bags read
  to the mixed bag's records with ``zstandard`` and ``lz4`` unimportable.
* No module of the port imports ``zstandard`` or ``lz4`` outside
  ``write_bag_mcap``; a source that does not compile raises with the
  compiler's log and never falls back to ``zstandard``.
"""

import ast
import functools
import hashlib
import importlib.util
import io
import itertools
import json
import pathlib
import struct
import sys

import numpy as np
import pytest
import zstandard

import _lz4_frame as lz4w
from f2nerf_tpu_torch.kernels import build
from f2nerf_tpu_torch.tools import rosbag_reader
from f2nerf_tpu_torch.utils import decompress as dc

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures" / "bag"
JPEG_FIXTURES = ROOT / "tests" / "torch_fixtures" / "jpeg"
FIXTURE_BUDGET = 512 * 1024
ZSTD_MAGIC = struct.pack("<I", 0xFD2FB528)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_bag_codec", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- inputs ------------------------------------------------------------------


def _text(n: int, seed: int = 0) -> bytes:
    """Word-like text: words of 2-8 letters from a 400-word vocabulary."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(400)]
    out = b" ".join(words[i] for i in rng.integers(0, 400, n // 4))
    return out[:n]


def _random(n: int, seed: int = 1) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.uint8).tobytes()


def _runs() -> bytes:
    """Runs of one byte, each longer than a block, between short text."""
    return b"".join(bytes([v]) * 140_000 + _text(500, v) for v in (0, 7, 255))


@functools.cache
def _input(kind: str) -> bytes:
    if kind == "text":
        return _text(200_000)
    if kind == "random":
        return _random(40_000)
    if kind == "runs":
        return _runs()
    return b"".join(p.read_bytes() for p in sorted(JPEG_FIXTURES.glob("*.jpg")))


def _zstd(data: bytes, level: int = 3, **kw) -> bytes:
    return zstandard.ZstdCompressor(level=level, **kw).compress(data)


def _flushed(data: bytes, level: int, every: int) -> bytes:
    """One frame cut into blocks by ``FLUSH_BLOCK`` every ``every`` bytes."""
    c = zstandard.ZstdCompressor(level=level).compressobj()
    out = []
    for at in range(0, len(data), every):
        out += [c.compress(data[at:at + every]),
                c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)]
    return b"".join(out) + c.flush()


def _oracle(frame: bytes, size: int) -> bytes:
    """``zstandard``'s output: every frame, skippable ones skipped."""
    reader = zstandard.ZstdDecompressor().stream_reader(
        io.BytesIO(frame), read_across_frames=True)
    out = reader.read()
    assert len(out) == size
    return out


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return struct.pack("<II", 0x184D2A50 + nibble, len(payload)) + payload


def _modes_of(fn):
    """(fn's result, the codec's mode counts that it added)."""
    before = dc.decoded_modes()
    out = fn()
    after = dc.decoded_modes()
    return out, {k: after[k] - before[k] for k in after if after[k] > before[k]}


# -- rare modes: inputs built to reach them ------------------------------------


def _literals_rle() -> tuple[bytes, bytes]:
    """A block whose literals are all 'x': copies of an earlier block of
    random bytes other than 'x', each after one 'x' (level 19 codes 8 or
    more identical literals as RLE; with this seed its parser leaves no
    other literal in the block)."""
    rng = np.random.default_rng(8)
    head = rng.integers(0, 256, 2000).astype(np.uint8)
    head[head == ord("x")] = ord("y")
    head = head.tobytes()
    body = b"".join(b"x" + head[a:a + 200] for a in rng.integers(0, 1800, 40))
    c = zstandard.ZstdCompressor(level=19).compressobj()
    frame = (c.compress(head) + c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
             + c.compress(body) + c.flush())
    return head + body, frame


def _many_sequences() -> tuple[bytes, bytes]:
    """32,768 sequences in the second block (the 3-byte count): every 4th
    byte differs from the byte 4,096 back, the 3 after it repeat theirs,
    so that no match there is longer than 3."""
    rng = np.random.default_rng(5)
    k, n = 4096, 300_000
    d = np.zeros(n, np.uint8)
    d[:k] = rng.integers(0, 256, k)
    for at in range(k, n, k):
        m = min(k, n - at)
        seg = d[at - k:at - k + m].copy()
        lit = seg[0::4].astype(np.int64) + rng.integers(1, 256, len(seg[0::4]))
        seg[0::4] = lit % 256
        d[at:at + m] = seg
    data = d.tobytes()
    return data, _zstd(data, 19)


def _rep_minus_one() -> tuple[bytes, bytes]:
    """Copies at an offset and then at that offset less one, with no
    literal between (the optimal parser codes ``rep1 - 1``)."""
    rng = np.random.default_rng(6)
    d = bytearray(_random(5000, 6))
    for _ in range(2000):
        off, n = int(rng.integers(8, 200)), int(rng.integers(4, 30))
        for k in range(n):
            d.append(d[len(d) - off])
        if rng.random() < 0.5:
            for k in range(int(rng.integers(4, 30))):
                d.append(d[len(d) - (off - 1)])
        d.append(int(rng.integers(0, 256)))
    return bytes(d), _zstd(bytes(d), 19)


def _small_alphabet() -> tuple[bytes, bytes]:
    """Three symbols: the Huffman weights are written directly."""
    data = np.random.default_rng(7).integers(0, 3, 60_000).astype(
        np.uint8).tobytes()
    return data, _zstd(data, 3)


def _no_sequences() -> tuple[bytes, bytes]:
    """Letters with no repeats worth a match: literals only."""
    data = np.random.default_rng(8).integers(97, 113, 1000).astype(
        np.uint8).tobytes()
    return data, _zstd(data, 1)


RARE = {"literals_rle": _literals_rle,
        "sequences_count_3": _many_sequences,
        "offset_rep1_minus_1": _rep_minus_one,
        "huffman_weights_direct": _small_alphabet,
        "sequences_none": _no_sequences}


# -- frame headers ----------------------------------------------------------------


def _header_parts(frame: bytes) -> tuple[int, bytes]:
    """(the frame header descriptor, the frame after its header)."""
    assert frame[:4] == ZSTD_MAGIC
    fhd = frame[4]
    ss, dict_flag, fcs_flag = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    at = 5 + (0 if ss else 1) + (0, 1, 2, 4)[dict_flag]
    at += (1 if ss else 0) if fcs_flag == 0 else 1 << fcs_flag
    return fhd, frame[at:]


def rewrite_header(frame: bytes, size: int, width: int, single: bool,
                   dict_id: int = 0) -> bytes:
    """``frame`` (one frame of ``size`` bytes) with its content size in
    ``width`` bytes (0: none), Single_Segment ``single`` (else a window
    descriptor of at least ``size``) and a Dictionary_ID."""
    fhd, rest = _header_parts(frame)
    flag = {0: 0, 1: 0, 2: 1, 4: 2, 8: 3}[width]
    dict_flag = 0 if not dict_id else 1 if dict_id < 256 else 3
    out = bytes([flag << 6 | single << 5 | (fhd & 4) | dict_flag])
    if not single:
        out += bytes([max(0, (max(size, 1) - 1).bit_length() - 10) << 3])
    out += dict_id.to_bytes((0, 1, 2, 4)[dict_flag], "little")
    if width == 2:
        out += struct.pack("<H", size - 256)
    elif width:
        out += size.to_bytes(width, "little")
    return ZSTD_MAGIC + out + rest


# -- Zstandard --------------------------------------------------------------------


@pytest.mark.parametrize("checksum,content_size", [
    (True, True), (False, False), (True, False), (False, True)])
@pytest.mark.parametrize("kind", ["text", "random", "runs", "jpeg"])
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
def test_zstd_equals_zstandard(level, kind, checksum, content_size):
    data = _input(kind)
    frame = _zstd(data, level, write_checksum=checksum,
                  write_content_size=content_size)
    want = zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=len(data))
    assert want == data
    got, modes = _modes_of(lambda: dc.zstd_decompress(frame, len(data)))
    assert got == want
    assert ("zstd_checksum" in modes) == checksum
    assert ("zstd_single_segment" in modes) == content_size
    if kind == "random":
        assert "block_raw" in modes
    if kind == "runs":
        assert "block_rle" in modes
    if len(data) > 128 * 1024 and kind != "runs":
        assert modes.get("block_compressed", 0) + modes.get(
            "block_raw", 0) > 1


@pytest.mark.parametrize("params", ["window_log", "ldm"])
def test_zstd_large_window_and_long_matches(params):
    """A 27-bit window with no content size (the window descriptor) and
    long-distance matching, on random bytes repeated 210 KB later."""
    block = _random(150_000, 9)
    data = block + _text(60_000, 9) + block
    cp = zstandard.ZstdCompressionParameters.from_level(
        3, window_log=27, enable_ldm=params == "ldm")
    # a stream of unknown size keeps the window
    c = zstandard.ZstdCompressor(compression_params=cp).compressobj()
    frame = c.compress(data) + c.flush()
    assert frame[5] >> 3 == 27 - 10               # the window's exponent
    assert len(frame) < len(data) - 100_000       # the repeat was matched
    got, modes = _modes_of(lambda: dc.zstd_decompress(frame, len(data)))
    assert got == _oracle(frame, len(data)) == data
    assert "zstd_window_descriptor" in modes and "match_across_blocks" in modes


@pytest.mark.parametrize("every", [50, 300, 2000])
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19])
def test_zstd_flush_block_streams(level, every):
    data = _text(60_000, 2)
    frame = _flushed(data, level, every)
    got, modes = _modes_of(lambda: dc.zstd_decompress(frame, len(data)))
    assert got == zstandard.ZstdDecompressor().decompress(
        frame, max_output_size=len(data)) == data
    assert (modes["block_compressed"] + modes.get("block_raw", 0)
            >= len(data) // every)
    if level >= 9 and every == 300:
        assert {"ll_repeat", "of_repeat", "ml_repeat", "literals_treeless"} \
            <= modes.keys()
    if every == 50:
        assert {"ll_rle", "of_rle", "ml_rle", "ll_predefined"} <= modes.keys()


@pytest.mark.parametrize("mode", sorted(RARE))
def test_zstd_rare_modes(mode):
    data, frame = RARE[mode]()
    got, modes = _modes_of(lambda: dc.zstd_decompress(frame, len(data)))
    assert got == _oracle(frame, len(data)) == data
    assert modes.get(mode, 0) > 0, sorted(modes)


@pytest.mark.parametrize("width,single,size", [
    (0, False, 1000), (1, True, 200), (2, True, 1000), (2, False, 1000),
    (4, True, 1000), (4, False, 70_000), (8, True, 1000), (8, False, 1000)])
def test_zstd_content_size_widths(width, single, size):
    """Every Frame_Content_Size width (the 2-byte form's +256 included),
    with and without Single_Segment, each read as ``zstandard`` reads
    it."""
    data = _text(size, 3)
    frame = rewrite_header(_zstd(data, 3, write_checksum=True), size, width,
                           single)
    got, modes = _modes_of(lambda: dc.zstd_decompress(frame, size))
    assert got == _oracle(frame, size) == data
    assert modes.get("zstd_fcs_none" if width == 0 else f"zstd_fcs_{width}")
    assert ("zstd_single_segment" in modes) == single


def test_zstd_concatenated_and_skippable_frames():
    a, b = _text(3000, 4), _random(500, 4) + _text(70_000, 5)
    frame = (_skippable(b"meta", 3) + _zstd(a, 1, write_checksum=True)
             + _skippable(b"") + _flushed(b, 9, 1000) + _zstd(b"", 3)
             + _skippable(b"tail" * 10, 15))
    got, modes = _modes_of(lambda: dc.zstd_decompress(frame, len(a + b)))
    assert got == _oracle(frame, len(a + b)) == a + b
    assert modes["zstd_frame"] == 3 and modes["zstd_skippable_frame"] == 3


def test_zstd_unsupported_frames_raise_naming_the_gap():
    data = _text(1000, 6)
    frame = _zstd(data, 3)
    with pytest.raises(ValueError, match="dictionar"):
        dc.zstd_decompress(rewrite_header(frame, 1000, 2, True, dict_id=7),
                           1000)
    with pytest.raises(ValueError, match="dictionar"):
        dc.zstd_decompress(
            rewrite_header(frame, 1000, 2, True, dict_id=70_000), 1000)
    for v in range(0xFD2FB522, 0xFD2FB528):
        with pytest.raises(ValueError, match="legacy"):
            dc.zstd_decompress(struct.pack("<I", v) + frame[4:], 1000)
    with pytest.raises(ValueError, match="not a zstd frame"):
        dc.zstd_decompress(b"\x04\x22\x4d\x18" + frame[4:], 1000)
    reserved = bytearray(frame)
    reserved[4] |= 8
    with pytest.raises(ValueError, match="reserved"):
        dc.zstd_decompress(bytes(reserved), 1000)


def _flips(frame: bytes, decode, data: bytes) -> float:
    """Decode ``frame`` with each bit flipped in turn: each raises
    ``ValueError`` or gives ``data`` itself (a flip that the frame's
    meaning does not see). Returns the share that raised."""
    raised = 0
    for at, bit in itertools.product(range(len(frame)), range(8)):
        bad = bytearray(frame)
        bad[at] ^= 1 << bit
        try:
            out = decode(bytes(bad), len(data))
        except ValueError:
            raised += 1
        else:
            assert out == data, (at, bit)
    return raised / (8 * len(frame))


def _truncations(frame: bytes, decode, size: int) -> None:
    for n in range(len(frame)):
        with pytest.raises(ValueError):
            decode(frame[:n], size)


def test_zstd_corrupt_input_raises():
    data = _text(600, 7) + bytes(300) + _random(100, 7) + _text(600, 7)
    frames = [_zstd(data, 19, write_checksum=True),
              _flushed(data, 3, 200)[:-4] + b"",            # no last block
              rewrite_header(_zstd(data, 1, write_checksum=True), len(data),
                             4, False)]
    decode = dc.zstd_decompress
    assert decode(frames[0], len(data)) == data
    assert _flips(frames[0], decode, data) > 0.95
    _truncations(frames[0], decode, len(data))
    with pytest.raises(ValueError, match="truncated"):
        decode(frames[1], len(data))
    assert _flips(frames[2], decode, data) > 0.95
    for size in (len(data) - 1, len(data) + 1, 0):
        with pytest.raises(ValueError):
            decode(frames[0], size)
    bad = frames[0][:-4] + bytes(4)
    with pytest.raises(ValueError, match="checksum"):
        decode(bad, len(data))
    rng = np.random.default_rng(10)
    for _ in range(200):
        noise = ZSTD_MAGIC + bytes([0x20, 0xFF]) + _random(
            int(rng.integers(1, 400)), int(rng.integers(1 << 30)))
        with pytest.raises(ValueError):
            decode(noise, 255)


def test_zstd_output_past_the_size_is_refused():
    """A frame with no content size that decodes past the size the caller
    gave stops at it: an error, never a write past the buffer."""
    data = _text(5000, 8)
    frame = _zstd(data, 3, write_content_size=False)
    with pytest.raises(ValueError, match="exceeds the expected size"):
        dc.zstd_decompress(frame, 4000)
    with pytest.raises(ValueError, match="exceeds the expected size"):
        dc.zstd_decompress(_zstd(data, 3), 4000)


# -- LZ4 --------------------------------------------------------------------------


@functools.cache
def _lz4_input() -> bytes:
    return (_text(40_000, 11) + _random(3000, 11) + b"ab" * 400
            + bytes(2000) + _text(30_000, 12) + _text(40_000, 11)[:20_000])


@pytest.mark.parametrize("block_size_id", [4, 5])
@pytest.mark.parametrize("content_size", [False, True])
@pytest.mark.parametrize("content_checksum", [False, True])
@pytest.mark.parametrize("block_checksum", [False, True])
@pytest.mark.parametrize("independent", [True, False])
def test_lz4_frame_matrix(independent, block_checksum, content_checksum,
                          content_size, block_size_id):
    data = _lz4_input()
    frame = lz4w.frame(data, block_size_id, independent, block_checksum,
                       content_checksum, content_size)
    got, modes = _modes_of(lambda: dc.lz4_frame_decompress(frame, len(data)))
    assert got == data
    assert modes["lz4_frame"] == 1
    assert ("lz4_independent" if independent else "lz4_linked") in modes
    assert ("lz4_block_checksum" in modes) == block_checksum
    assert ("lz4_content_checksum" in modes) == content_checksum
    assert ("lz4_content_size" in modes) == content_size
    assert {"lz4_literal_extension", "lz4_match_extension",
            "lz4_overlap"} <= modes.keys()
    if block_size_id == 4:
        assert modes["lz4_block_compressed"] == 2
        assert ("lz4_match_across_blocks" in modes) == (not independent)


def test_lz4_hand_written_frame():
    """A frame written out byte by byte from the format's description:
    the header of the ``lz4`` tool's default frame (FLG 0x64: version 1,
    independent blocks, a content checksum; BD 0x40: 64 KiB blocks; its
    checksum byte 0xA7), one block of 3 literals, a match at offset 3 of
    length 9 (overlapping itself) and 5 last literals, the end mark and
    XXH32 of the content."""
    content = b"abcabcabcabcxyzxy"
    frame = (bytes.fromhex("04224d18" "6440a7" "0c000000"
                           "35616263" "0300" "5078797a7879" "00000000")
             + struct.pack("<I", lz4w.xxh32(content)))
    assert lz4w.xxh32(b"") == dc.xxh32(b"") == 0x02CC5D05
    assert (lz4w.xxh32(b"\x64\x40") >> 8) & 0xFF == 0xA7
    assert dc.lz4_frame_decompress(frame, len(content)) == content
    assert lz4w.frame(content, content_checksum=True)[:7] == frame[:7]
    # a stored block (the size word's high bit) beside it
    stored = (bytes.fromhex("04224d18" "6440a7" "05000080") + b"hello"
              + bytes(4) + struct.pack("<I", lz4w.xxh32(b"hello")))
    assert dc.lz4_frame_decompress(stored + frame, 22) == b"hello" + content


def test_lz4_stored_blocks_concatenated_and_skippable_frames():
    a, b = _random(70_000, 13), _text(5000, 13)
    frame = (_skippable(b"x", 2) + lz4w.frame(a, 4, True, True, True, True)
             + _skippable(b"") + lz4w.frame(b, 6, False))
    got, modes = _modes_of(lambda: dc.lz4_frame_decompress(frame, len(a + b)))
    assert got == a + b
    assert modes["lz4_frame"] == 2 and modes["lz4_skippable_frame"] == 2
    assert modes["lz4_block_stored"] == 2


def test_lz4_hashes_equal_the_writer():
    rng = np.random.default_rng(14)
    for n in (0, 1, 3, 4, 15, 16, 17, 31, 100, 1000):
        data = _random(n, int(rng.integers(1 << 30)))
        assert dc.xxh32(data) == lz4w.xxh32(data)
        assert dc.xxh32(data, 1234) == lz4w.xxh32(data, 1234)


def test_lz4_corrupt_input_raises():
    data = _text(900, 15) + b"q" * 300 + _text(900, 16)
    frame = lz4w.frame(data, 4, False, True, True, True)
    decode = dc.lz4_frame_decompress
    assert decode(frame, len(data)) == data
    assert _flips(frame, decode, data) > 0.95
    _truncations(frame, decode, len(data))
    plain = lz4w.frame(data, 4, True)           # no checksum to catch flips
    for at in range(7, len(plain)):
        bad = bytearray(plain)
        bad[at] ^= 0x80
        try:
            decode(bytes(bad), len(data))
        except ValueError:
            pass
    for size in (len(data) - 1, len(data) + 1):
        with pytest.raises(ValueError):
            decode(frame, size)
    with pytest.raises(ValueError, match="checksum"):
        decode(frame[:-4] + bytes(4), len(data))
    hc = 4 + 2 + 8                  # magic, FLG, BD, the content size
    with pytest.raises(ValueError, match="header checksum"):
        decode(frame[:hc] + bytes([frame[hc] ^ 1]) + frame[hc + 1:],
               len(data))
    with pytest.raises(ValueError, match="dictionar"):
        desc = bytes([0x61, 0x40]) + bytes(4)
        decode(struct.pack("<I", lz4w.MAGIC) + desc
               + bytes([(lz4w.xxh32(desc) >> 8) & 0xFF]), 0)


# -- fixtures and the read path -------------------------------------------------------


def _fixture_frames() -> dict[str, tuple[str, bytes, bytes]]:
    """{name: (compression, content, frame)}: raw frames that together
    reach every mode the codec counts."""
    text = _text(200_000, 20)
    lit_data, lit_frame = _literals_rle()
    seq_data, seq_frame = _many_sequences()
    rep_data, rep_frame = _rep_minus_one()
    abc_data, abc_frame = _small_alphabet()
    none_data, none_frame = _no_sequences()
    small, flushed = _text(200, 21), _text(20_000, 22)
    mixed = _runs() + _random(20_000, 23)
    lz4_text = _text(150_000, 24) + b"ab" * 300 + _text(20_000, 24)
    lz4_mixed = _random(70_000, 25) + _text(5000, 25)
    return {
        "text_l19_checksum.zst": ("zstd", text,
                                  _zstd(text, 19, write_checksum=True)),
        "flush_300_l9.zst": ("zstd", flushed, _flushed(flushed, 9, 300)),
        "flush_50_l19.zst": ("zstd", flushed, _flushed(flushed, 19, 50)),
        "random_runs.zst": ("zstd", mixed, _zstd(mixed, 3)),
        "rare_modes.zst": (
            "zstd", lit_data + seq_data + rep_data + abc_data + none_data,
            lit_frame + seq_frame + rep_frame + abc_frame + none_frame),
        "header_forms.zst": (
            "zstd", small + flushed + small,
            _skippable(b"meta", 5) + _zstd(small, 3)
            + rewrite_header(_zstd(flushed, 3, write_checksum=True),
                             len(flushed), 8, False)
            + rewrite_header(_zstd(small, 3), len(small), 4, True)),
        "text_linked.lz4": ("lz4", lz4_text, lz4w.frame(
            lz4_text, 4, False, True, True, True)),
        "stored_independent.lz4": (
            "lz4", lz4_mixed + lz4_text[:3000],
            _skippable(b"x") + lz4w.frame(lz4_mixed, 4, True, False, True)
            + lz4w.frame(lz4_text[:3000], 5, True)),
    }


def _bag_messages(cs) -> list:
    msgs, _, _ = cs.mixed_messages()
    return msgs + [cs.camera_info_record()]


@functools.cache
def _expected() -> dict:
    return json.loads((FIXTURES / "expected.json").read_text())


def test_fixtures_decode_to_their_digests_and_reach_every_mode():
    expected = _expected()
    names = sorted(p.name for p in FIXTURES.iterdir()
                   if p.suffix in (".zst", ".lz4", ".mcap"))
    assert names == sorted([*expected["frames"], *expected["bags"]])
    assert sum(p.stat().st_size for p in FIXTURES.iterdir()) < FIXTURE_BUDGET

    def decode_all():
        for name, want in expected["frames"].items():
            data = (FIXTURES / name).read_bytes()
            fn = (dc.zstd_decompress if want["compression"] == "zstd"
                  else dc.lz4_frame_decompress)
            got = fn(data, want["size"])
            assert hashlib.sha256(got).hexdigest() == want["sha256"], name
            if want["compression"] == "zstd":
                assert got == _oracle(data, want["size"]), name

    _, modes = _modes_of(decode_all)
    names = dc.decoded_modes().keys()
    assert sorted(set(names) - modes.keys()) == []


def test_fixture_bags_read_without_zstandard_or_lz4(monkeypatch, tmp_path):
    cs = _chip_smoke()
    msgs = sorted(_bag_messages(cs))
    expected = _expected()["bags"]
    jbag = importlib.util.module_from_spec(importlib.util.spec_from_file_location(
        "jax_rosbag_reader", ROOT / "scripts" / "rosbag_reader.py"))
    jbag.__spec__.loader.exec_module(jbag)
    zbag = str(FIXTURES / "mixed_zstd.mcap")
    assert sorted(jbag.read_bag_any(zbag)) == msgs
    # the fixtures are what the port's writer writes for these records
    rosbag_reader.write_bag_mcap(str(tmp_path / "z.mcap"), msgs, "zstd")
    assert (tmp_path / "z.mcap").read_bytes() == pathlib.Path(zbag).read_bytes()
    lz4w.write_lz4_bag(tmp_path / "l.mcap", msgs)
    assert ((tmp_path / "l.mcap").read_bytes()
            == (FIXTURES / "mixed_lz4.mcap").read_bytes())
    for name in ("zstandard", "lz4"):
        monkeypatch.setitem(sys.modules, name, None)    # import raises
    for name, want in expected.items():
        assert sorted(rosbag_reader.read_bag_any(str(FIXTURES / name))) == msgs
        (comp, usize, data), = cs.mcap_chunks((FIXTURES / name).read_bytes())
        assert (comp, usize) == (want["compression"], want["chunk_size"])


def test_rechunked_zstd_bag_equals_the_writer(tmp_path):
    """``rechunk_mcap`` lays a chunk out as ``write_bag_mcap`` does: with
    zstd it writes the same bytes."""
    msgs = _bag_messages(_chip_smoke())
    rosbag_reader.write_bag_mcap(str(tmp_path / "p.mcap"), msgs)
    rosbag_reader.write_bag_mcap(str(tmp_path / "z.mcap"), msgs, "zstd")
    assert lz4w.rechunk_mcap((tmp_path / "p.mcap").read_bytes(), "zstd",
                        zstandard.ZstdCompressor().compress) \
        == (tmp_path / "z.mcap").read_bytes()


def test_unknown_chunk_compression_raises(tmp_path):
    msgs = _bag_messages(_chip_smoke())[:3]
    rosbag_reader.write_bag_mcap(str(tmp_path / "p.mcap"), msgs)
    (tmp_path / "b.mcap").write_bytes(lz4w.rechunk_mcap(
        (tmp_path / "p.mcap").read_bytes(), "bz2", lambda b: b))
    with pytest.raises(RuntimeError, match="unknown mcap chunk compression"):
        list(rosbag_reader.read_bag_any(str(tmp_path / "b.mcap")))


def test_port_imports_neither_module_outside_the_writer():
    found = []
    for path in sorted((ROOT / "f2nerf_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] in ("zstandard", "lz4") for n in names):
                found.append((path.name, tuple(
                    f.name for f in funcs
                    if f.lineno <= node.lineno <= f.end_lineno)))
    assert found == [("rosbag_reader.py", ("write_bag_mcap",))]


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LIBS", {})


def test_failed_build_raises_with_the_log(tmp_path, monkeypatch, fresh_build):
    """With ``zstandard`` installed all the same, a codec that does not
    compile raises with the compiler's log."""
    src = tmp_path / "chunk_codec.cpp"
    src.write_text("long long f2_zstd_decompress( {\n")
    monkeypatch.setitem(build.HOST_SOURCES, "chunk_codec", src)
    frame = _zstd(b"abc" * 100)
    with pytest.raises(RuntimeError, match="failed for chunk_codec") as e:
        dc.zstd_decompress(frame, 300)
    assert "error" in str(e.value)
    with pytest.raises(RuntimeError, match="failed for chunk_codec"):
        rosbag_reader._mcap_decompress("zstd", frame, 300)
    assert not list((tmp_path / "build").glob("*.so"))


def test_builds_into_a_fresh_directory(fresh_build):
    secs = build.build_all(["chunk_codec"])
    assert secs["chunk_codec"] > 0
    assert build.build_all(["chunk_codec"]) == {"chunk_codec": 0.0}
    assert "chunk_codec" not in build.kernel_names()
    assert dc.zstd_decompress(_zstd(b"abc" * 100), 300) == b"abc" * 100


# -- writing the fixtures --------------------------------------------------------------


def _jax_extraction(bag: pathlib.Path, calib: pathlib.Path,
                    out: pathlib.Path, topics: list) -> dict:
    """The JAX extractor on ``bag``: {"images": [pixel SHA-256s],
    "pose_tsv"}."""
    from PIL import Image

    cs = _chip_smoke()
    spec = importlib.util.spec_from_file_location(
        "jax_extract", ROOT / "scripts" / "extract_images_from_rosbag.py")
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT / "scripts"))
    argv = sys.argv
    try:
        spec.loader.exec_module(mod)
        sys.argv = ["extract_images_from_rosbag", str(bag), str(calib),
                    str(out), "--image_topics", *topics]
        mod.main()
    finally:
        sys.argv = argv
        sys.path.remove(str(ROOT / "scripts"))
    images = []
    for p in sorted((out / "images").glob("*.png")):
        with Image.open(p) as im:
            images.append(cs.pixels_sha256(np.asarray(im.convert("RGB"))))
    return {"images": images, "pose_tsv": (out / "pose.tsv").read_text()}


def make_fixtures() -> None:
    """Write the fixtures and ``expected.json``: each raw frame's length
    and SHA-256; each bag's chunk, and the JAX extractor's images and
    ``pose.tsv`` from the zstd bag (with ``zstandard``)."""
    import tempfile

    import yaml

    cs = _chip_smoke()
    FIXTURES.mkdir(parents=True, exist_ok=True)
    for p in FIXTURES.iterdir():
        p.unlink()
    expected = {"frames": {}, "bags": {}}
    for name, (comp, content, frame) in _fixture_frames().items():
        (FIXTURES / name).write_bytes(frame)
        expected["frames"][name] = {
            "compression": comp, "size": len(content),
            "sha256": hashlib.sha256(content).hexdigest()}
    msgs = _bag_messages(cs)
    _, topics, _ = cs.mixed_messages()
    rosbag_reader.write_bag_mcap(str(FIXTURES / "mixed_zstd.mcap"), msgs,
                                 "zstd")
    lz4w.write_lz4_bag(FIXTURES / "mixed_lz4.mcap", msgs)
    with tempfile.TemporaryDirectory() as tmp:
        calib = pathlib.Path(tmp) / "calib.yaml"
        calib.write_text(yaml.safe_dump(cs.zero_calibration()))
        result = _jax_extraction(FIXTURES / "mixed_zstd.mcap", calib,
                                 pathlib.Path(tmp) / "out", topics)
    (_, usize, chunk), = cs.mcap_chunks(
        (FIXTURES / "mixed_zstd.mcap").read_bytes())
    chunk = zstandard.ZstdDecompressor().decompress(chunk)
    for name, comp in (("mixed_zstd.mcap", "zstd"), ("mixed_lz4.mcap", "lz4")):
        expected["bags"][name] = {
            "compression": comp, "chunk_size": usize,
            "chunk_sha256": hashlib.sha256(chunk).hexdigest(), **result}
    (FIXTURES / "expected.json").write_text(
        json.dumps(expected, indent=1, sort_keys=True) + "\n")
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < FIXTURE_BUDGET, total
    print(f"wrote {len(expected['frames']) + 2} fixtures, {total} bytes")


if __name__ == "__main__":
    make_fixtures()
