"""An LZ4 frame writer for the tests, written from the LZ4 frame format
(1.6.x) and block format descriptions: the tests do not depend on the
``lz4`` module, so the chunk codec's LZ4 decoder is held against the
input this writer was given.

The block compressor is a greedy matcher over a hash of 4-byte prefixes.
It keeps the block format's end rules (the last 5 bytes are literals, no
match starts in the last 12), writes the 255-extension bytes of long
literal runs and matches, and takes the nearest earlier occurrence, so
that runs give overlapping matches (offset < length). Linked blocks may
match into the 64 KiB before them; a block that does not shrink is
stored (the size word's high bit), as ``LZ4F_compressFrame`` does.

:func:`write_lz4_bag` writes an mcap bag whose one chunk is such a frame,
laid out as ``rosbag_reader.write_bag_mcap`` lays out a zstd chunk.
"""

from __future__ import annotations

import pathlib
import struct

from f2nerf_tpu_torch.tools import rosbag_reader

MAGIC = 0x184D2204
_P = (2654435761, 2246822519, 3266489917, 668265263, 374761393)
_M = 0xFFFFFFFF
MIN_MATCH, LAST_LITERALS, MF_LIMIT = 4, 5, 12


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    n, i = len(data), 0
    if n >= 16:
        v = [(seed + _P[0] + _P[1]) & _M, (seed + _P[1]) & _M, seed,
             (seed - _P[0]) & _M]
        while n - i >= 16:
            for k in range(4):
                w = struct.unpack_from("<I", data, i + 4 * k)[0]
                v[k] = (_rotl((v[k] + w * _P[1]) & _M, 13) * _P[0]) & _M
            i += 16
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M
    else:
        h = (seed + _P[4]) & _M
    h = (h + n) & _M
    while n - i >= 4:
        w = struct.unpack_from("<I", data, i)[0]
        h = (_rotl((h + w * _P[2]) & _M, 17) * _P[3]) & _M
        i += 4
    while i < n:
        h = (_rotl((h + data[i] * _P[4]) & _M, 11) * _P[0]) & _M
        i += 1
    h ^= h >> 15
    h = (h * _P[1]) & _M
    h ^= h >> 13
    h = (h * _P[2]) & _M
    return h ^ (h >> 16)


def _length(v: int) -> bytes:
    """The 255-extension bytes of a length field's part past 15."""
    return b"\xff" * (v // 255) + bytes([v % 255])


def compress_block(data: bytes, prefix: bytes = b"") -> bytes:
    """One LZ4 block of ``data``; matches may reach into ``prefix`` (the
    output before the block, for linked blocks), at most 65535 back."""
    buf = prefix + data
    start, end = len(prefix), len(buf)
    table: dict[bytes, int] = {}
    for j in range(max(0, start - 65535), start - MIN_MATCH + 1):
        table[buf[j:j + MIN_MATCH]] = j
    out = bytearray()
    anchor = i = start
    match_end = end - LAST_LITERALS
    while i <= end - MF_LIMIT:
        key = buf[i:i + MIN_MATCH]
        cand = table.get(key)
        table[key] = i
        if cand is None or i - cand > 65535:
            i += 1
            continue
        ml = MIN_MATCH
        while i + ml < match_end and buf[cand + ml] == buf[i + ml]:
            ml += 1
        ll = i - anchor
        tok_l, tok_m = min(ll, 15), min(ml - MIN_MATCH, 15)
        out.append(tok_l << 4 | tok_m)
        if ll >= 15:
            out += _length(ll - 15)
        out += buf[anchor:i]
        out += struct.pack("<H", i - cand)
        if ml - MIN_MATCH >= 15:
            out += _length(ml - MIN_MATCH - 15)
        for j in range(i + 1, min(i + ml, end - MIN_MATCH + 1)):
            table[buf[j:j + MIN_MATCH]] = j
        i += ml
        anchor = i
    ll = end - anchor
    out.append(min(ll, 15) << 4)
    if ll >= 15:
        out += _length(ll - 15)
    out += buf[anchor:end]
    return bytes(out)


def frame(data: bytes, block_size_id: int = 4, independent: bool = True,
          block_checksum: bool = False, content_checksum: bool = False,
          content_size: bool = False) -> bytes:
    """One LZ4 frame of ``data`` (block maximum 64 KiB, 256 KiB, 1 MiB or
    4 MiB for ``block_size_id`` 4 to 7)."""
    flg = (1 << 6 | independent << 5 | block_checksum << 4
           | content_size << 3 | content_checksum << 2)
    desc = bytes([flg, block_size_id << 4])
    if content_size:
        desc += struct.pack("<Q", len(data))
    out = bytearray(struct.pack("<I", MAGIC) + desc
                    + bytes([(xxh32(desc) >> 8) & 0xFF]))
    block_max = 1 << (8 + 2 * block_size_id)
    for at in range(0, len(data), block_max):
        raw = data[at:at + block_max]
        prefix = b"" if independent else data[max(0, at - 65536):at]
        comp = compress_block(raw, prefix)
        body, word = (comp, len(comp)) if len(comp) < len(raw) else \
            (raw, len(raw) | 0x80000000)
        out += struct.pack("<I", word) + body
        if block_checksum:
            out += struct.pack("<I", xxh32(body))
    out += struct.pack("<I", 0)
    if content_checksum:
        out += struct.pack("<I", xxh32(data))
    return bytes(out)


def rechunk_mcap(plain: bytes, compression: str, compress) -> bytes:
    """An mcap file as ``write_bag_mcap`` writes it, its records moved
    into one chunk compressed by ``compress`` (named ``compression``)."""
    magic = rosbag_reader._MCAP_MAGIC
    records = list(rosbag_reader._mcap_records(plain[:-len(magic)],
                                               len(magic)))
    body = b"".join(rosbag_reader._mcap_record(op, c) for op, c in records
                    if op in (rosbag_reader._OP_SCHEMA,
                              rosbag_reader._OP_CHANNEL,
                              rosbag_reader._OP_MESSAGE))
    stamps = [struct.unpack_from("<Q", c, 6)[0] for op, c in records
              if op == rosbag_reader._OP_MESSAGE]
    comp = compress(body)
    chunk = rosbag_reader._mcap_record(
        rosbag_reader._OP_CHUNK,
        struct.pack("<QQQI", min(stamps, default=0), max(stamps, default=0),
                    len(body), 0)
        + rosbag_reader._mcap_str(compression)
        + struct.pack("<Q", len(comp)) + comp)
    head_end = len(magic) + 9 + len(records[0][1])
    tail = b"".join(rosbag_reader._mcap_record(op, c) for op, c in records
                    if op not in (rosbag_reader._OP_SCHEMA,
                                  rosbag_reader._OP_CHANNEL,
                                  rosbag_reader._OP_MESSAGE,
                                  rosbag_reader._OP_HEADER))
    return plain[:head_end] + chunk + tail + magic


def write_lz4_bag(path, messages) -> None:
    """``messages`` in an mcap file with one LZ4-frame chunk (linked
    blocks, both checksums), as ``write_bag_mcap`` lays it out."""
    plain = pathlib.Path(str(path) + ".plain")
    rosbag_reader.write_bag_mcap(str(plain), messages)
    pathlib.Path(path).write_bytes(rechunk_mcap(
        plain.read_bytes(), "lz4",
        lambda b: frame(b, 4, False, True, True, True)))
    plain.unlink()
