"""Pure-Python rosbag2 reader and writer (port of
``scripts/rosbag_reader.py``; the port keeps its own copy, since it
imports nothing of the JAX package's tree).

A rosbag2 ``.db3`` file is a sqlite database (tables ``topics`` +
``messages``) whose message blobs are CDR-encoded, and an ``.mcap`` file
is a record stream; both are read with the standard library:

* :func:`read_bag` / :func:`read_bag_mcap` / :func:`read_bag_any` —
  iterate (topic, type, timestamp, raw CDR bytes) in time order,
* a declarative CDR codec (:func:`decode` / :func:`encode`) for the
  message types the NeRF data pipeline needs (images, camera info,
  poses, tf),
* :func:`write_bag` / :func:`write_bag_mcap` — the inverse, used by the
  tests and by ``chip_smoke.py`` to build bags.

A compressed mcap chunk (``zstd`` or ``lz4``) is decoded by the port's
compiled chunk codec (``utils/decompress.py``), never by the
``zstandard`` or ``lz4`` modules the JAX reader imports, so such bags are
read where neither is installed. Where a chunk holds several zstd frames,
all are decoded (RFC 8878), where the JAX reader keeps only the first.
Only :func:`write_bag_mcap`'s ``compression='zstd'`` needs ``zstandard``.

CDR notes (XCDR1, the rosbag2 default): 4-byte encapsulation header
(0x00 0x01 = little-endian) followed by fields aligned to their
primitive size *relative to the byte after the header*; ``string`` is a
uint32 length (including NUL) + bytes + NUL; unbounded sequences are a
uint32 count + elements; fixed arrays have no count.
"""

from __future__ import annotations

import sqlite3
import struct
from typing import Any, Iterator

from f2nerf_tpu_torch.utils import decompress

# --------------------------------------------------------------------------
# message type specs: list of (field_name, type) where type is a primitive
# code, another spec name, ("seq", elem) for unbounded sequences, or
# ("arr", elem, n) for fixed arrays.
# --------------------------------------------------------------------------

SPECS: dict[str, list[tuple]] = {
    "builtin_interfaces/msg/Time": [("sec", "i4"), ("nanosec", "u4")],
    "std_msgs/msg/Header": [
        ("stamp", "builtin_interfaces/msg/Time"), ("frame_id", "str")],
    "geometry_msgs/msg/Vector3": [
        ("x", "f8"), ("y", "f8"), ("z", "f8")],
    "geometry_msgs/msg/Point": [("x", "f8"), ("y", "f8"), ("z", "f8")],
    "geometry_msgs/msg/Quaternion": [
        ("x", "f8"), ("y", "f8"), ("z", "f8"), ("w", "f8")],
    "geometry_msgs/msg/Pose": [
        ("position", "geometry_msgs/msg/Point"),
        ("orientation", "geometry_msgs/msg/Quaternion")],
    "geometry_msgs/msg/PoseStamped": [
        ("header", "std_msgs/msg/Header"),
        ("pose", "geometry_msgs/msg/Pose")],
    "geometry_msgs/msg/PoseWithCovariance": [
        ("pose", "geometry_msgs/msg/Pose"),
        ("covariance", ("arr", "f8", 36))],
    "geometry_msgs/msg/PoseWithCovarianceStamped": [
        ("header", "std_msgs/msg/Header"),
        ("pose", "geometry_msgs/msg/PoseWithCovariance")],
    "geometry_msgs/msg/Transform": [
        ("translation", "geometry_msgs/msg/Vector3"),
        ("rotation", "geometry_msgs/msg/Quaternion")],
    "geometry_msgs/msg/TransformStamped": [
        ("header", "std_msgs/msg/Header"),
        ("child_frame_id", "str"),
        ("transform", "geometry_msgs/msg/Transform")],
    "tf2_msgs/msg/TFMessage": [
        ("transforms", ("seq", "geometry_msgs/msg/TransformStamped"))],
    "sensor_msgs/msg/CompressedImage": [
        ("header", "std_msgs/msg/Header"),
        ("format", "str"), ("data", ("seq", "u1"))],
    "sensor_msgs/msg/Image": [
        ("header", "std_msgs/msg/Header"),
        ("height", "u4"), ("width", "u4"), ("encoding", "str"),
        ("is_bigendian", "u1"), ("step", "u4"), ("data", ("seq", "u1"))],
    "sensor_msgs/msg/RegionOfInterest": [
        ("x_offset", "u4"), ("y_offset", "u4"), ("height", "u4"),
        ("width", "u4"), ("do_rectify", "u1")],
    "sensor_msgs/msg/CameraInfo": [
        ("header", "std_msgs/msg/Header"),
        ("height", "u4"), ("width", "u4"), ("distortion_model", "str"),
        ("d", ("seq", "f8")), ("k", ("arr", "f8", 9)),
        ("r", ("arr", "f8", 9)), ("p", ("arr", "f8", 12)),
        ("binning_x", "u4"), ("binning_y", "u4"),
        ("roi", "sensor_msgs/msg/RegionOfInterest")],
}

_PRIM = {"i4": ("<i", 4), "u4": ("<I", 4), "f8": ("<d", 8),
         "u1": ("<B", 1)}


class _Cursor:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0          # relative to after the encapsulation header

    def align(self, n: int) -> None:
        self.pos += (-self.pos) % n


def _decode_value(cur: _Cursor, typ) -> Any:
    if isinstance(typ, tuple):
        kind = typ[0]
        if kind == "seq":
            cur.align(4)
            n = struct.unpack_from("<I", cur.buf, cur.pos)[0]
            cur.pos += 4
            if typ[1] == "u1":          # fast path for byte blobs
                out = cur.buf[cur.pos:cur.pos + n]
                cur.pos += n
                return bytes(out)
            return [_decode_value(cur, typ[1]) for _ in range(n)]
        if kind == "arr":
            return [_decode_value(cur, typ[1]) for _ in range(typ[2])]
        raise ValueError(typ)
    if typ == "str":
        cur.align(4)
        n = struct.unpack_from("<I", cur.buf, cur.pos)[0]
        cur.pos += 4
        s = cur.buf[cur.pos:cur.pos + n - 1].decode("utf-8")
        cur.pos += n
        return s
    if typ in _PRIM:
        fmt, size = _PRIM[typ]
        cur.align(size)
        v = struct.unpack_from(fmt, cur.buf, cur.pos)[0]
        cur.pos += size
        return v
    return {name: _decode_value(cur, t) for name, t in SPECS[typ]}


def decode(data: bytes, type_name: str) -> dict:
    """CDR bytes -> nested dict for one of the SPECS types."""
    if len(data) < 4 or data[1] not in (0, 1):
        raise ValueError("bad CDR encapsulation header")
    if data[1] != 1:
        raise NotImplementedError("big-endian CDR not supported")
    cur = _Cursor(data[4:])
    return _decode_value(cur, type_name)


class _Writer:
    def __init__(self):
        self.parts = bytearray()

    def align(self, n: int) -> None:
        self.parts.extend(b"\x00" * ((-len(self.parts)) % n))


def _encode_value(w: _Writer, typ, val) -> None:
    if isinstance(typ, tuple):
        kind = typ[0]
        if kind == "seq":
            w.align(4)
            if typ[1] == "u1":
                b = bytes(val)
                w.parts.extend(struct.pack("<I", len(b)))
                w.parts.extend(b)
                return
            w.parts.extend(struct.pack("<I", len(val)))
            for v in val:
                _encode_value(w, typ[1], v)
            return
        if kind == "arr":
            assert len(val) == typ[2]
            for v in val:
                _encode_value(w, typ[1], v)
            return
        raise ValueError(typ)
    if typ == "str":
        w.align(4)
        b = str(val).encode("utf-8") + b"\x00"
        w.parts.extend(struct.pack("<I", len(b)))
        w.parts.extend(b)
        return
    if typ in _PRIM:
        fmt, size = _PRIM[typ]
        w.align(size)
        w.parts.extend(struct.pack(fmt, val))
        return
    for name, t in SPECS[typ]:
        _encode_value(w, t, val[name])


def encode(msg: dict, type_name: str) -> bytes:
    """Nested dict -> CDR bytes (little-endian encapsulation)."""
    w = _Writer()
    _encode_value(w, type_name, msg)
    return b"\x00\x01\x00\x00" + bytes(w.parts)


# --------------------------------------------------------------------------
# sqlite3 storage
# --------------------------------------------------------------------------


def read_bag(db3_path: str, topics: list[str] | None = None
             ) -> Iterator[tuple[str, str, int, bytes]]:
    """Yield (topic_name, type_name, timestamp_ns, cdr_bytes) in time
    order from a rosbag2 sqlite3 file."""
    con = sqlite3.connect(f"file:{db3_path}?mode=ro", uri=True)
    try:
        tmap = {tid: (name, typ) for tid, name, typ in con.execute(
            "SELECT id, name, type FROM topics")}
        q = ("SELECT topic_id, timestamp, data FROM messages "
             "ORDER BY timestamp")
        for topic_id, ts, data in con.execute(q):
            name, typ = tmap[topic_id]
            if topics is None or name in topics:
                yield name, typ, ts, data
    finally:
        con.close()


def write_bag(db3_path: str,
              messages: list[tuple[str, str, int, bytes]]) -> None:
    """Write (topic, type, timestamp_ns, cdr_bytes) records as a rosbag2
    sqlite3 file (schema compatible with rosbag2's SequentialReader)."""
    con = sqlite3.connect(db3_path)
    try:
        con.execute(
            "CREATE TABLE topics(id INTEGER PRIMARY KEY, name TEXT NOT "
            "NULL, type TEXT NOT NULL, serialization_format TEXT NOT "
            "NULL, offered_qos_profiles TEXT NOT NULL)")
        con.execute(
            "CREATE TABLE messages(id INTEGER PRIMARY KEY, topic_id "
            "INTEGER NOT NULL, timestamp INTEGER NOT NULL, data BLOB "
            "NOT NULL)")
        ids: dict[str, int] = {}
        for topic, typ, _, _ in messages:
            if topic not in ids:
                ids[topic] = len(ids) + 1
                con.execute("INSERT INTO topics VALUES (?,?,?,?,?)",
                            (ids[topic], topic, typ, "cdr", ""))
        for i, (topic, _, ts, data) in enumerate(
                sorted(messages, key=lambda m: m[2])):
            con.execute("INSERT INTO messages VALUES (?,?,?,?)",
                        (i + 1, ids[topic], ts, data))
        con.commit()
    finally:
        con.close()


def stamp_to_sec(stamp: dict) -> float:
    return stamp["sec"] + stamp["nanosec"] * 1e-9


def make_stamp(t_sec: float) -> dict:
    sec = int(t_sec)
    return {"sec": sec, "nanosec": int(round((t_sec - sec) * 1e9))}


# --------------------------------------------------------------------------
# mcap storage (rosbag2's other storage plugin; spec: mcap.dev, v0)
# --------------------------------------------------------------------------

_MCAP_MAGIC = b"\x89MCAP0\r\n"
_OP_HEADER = 0x01
_OP_FOOTER = 0x02
_OP_SCHEMA = 0x03
_OP_CHANNEL = 0x04
_OP_MESSAGE = 0x05
_OP_CHUNK = 0x06
_OP_DATA_END = 0x0F


def _mcap_string(buf: bytes, off: int) -> tuple[str, int]:
    n = struct.unpack_from("<I", buf, off)[0]
    return buf[off + 4:off + 4 + n].decode(), off + 4 + n


def _mcap_records(buf: bytes, off: int = 0) -> Iterator[tuple[int, bytes]]:
    """Yield (opcode, content) records from a record stream."""
    end = len(buf)
    while off < end:
        op = buf[off]
        n = struct.unpack_from("<Q", buf, off + 1)[0]
        yield op, buf[off + 9:off + 9 + n]
        off += 9 + n


def _mcap_decompress(compression: str, data: bytes,
                     uncompressed_size: int) -> bytes:
    if compression in ("", "none"):
        return data
    if compression == "zstd":
        return decompress.zstd_decompress(data, uncompressed_size)
    if compression == "lz4":
        return decompress.lz4_frame_decompress(data, uncompressed_size)
    raise RuntimeError(f"unknown mcap chunk compression {compression!r}")


def read_bag_mcap(path: str, topics: list[str] | None = None
                  ) -> Iterator[tuple[str, str, int, bytes]]:
    """Yield (topic_name, type_name, log_time_ns, cdr_bytes) in time
    order from an mcap rosbag2 file (ros2 profile: schema name is the
    ROS type, message encoding cdr). Chunked (none/zstd/lz4) and
    unchunked files both work; messages are collected and sorted by
    log_time to match :func:`read_bag`'s ordering contract."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:8] != _MCAP_MAGIC:
        raise RuntimeError(f"{path}: not an mcap file")
    schemas: dict[int, str] = {}        # schema_id -> type name
    channels: dict[int, tuple[str, str]] = {}  # chan id -> (topic, type)
    out: list[tuple[str, str, int, bytes]] = []

    def handle(op: int, content: bytes) -> None:
        if op == _OP_SCHEMA:
            sid = struct.unpack_from("<H", content, 0)[0]
            name, _ = _mcap_string(content, 2)
            schemas[sid] = name   # ros2 profile: schema name IS the type
        elif op == _OP_CHANNEL:
            cid, sid = struct.unpack_from("<HH", content, 0)
            topic, _ = _mcap_string(content, 4)
            channels[cid] = (topic, schemas.get(sid, ""))
        elif op == _OP_MESSAGE:
            cid = struct.unpack_from("<H", content, 0)[0]
            log_time = struct.unpack_from("<Q", content, 6)[0]
            name, typ = channels[cid]
            if topics is None or name in topics:
                out.append((name, typ, log_time, content[22:]))
        elif op == _OP_CHUNK:
            usize = struct.unpack_from("<Q", content, 16)[0]
            compression, off = _mcap_string(content, 28)
            rec_len = struct.unpack_from("<Q", content, off)[0]
            records = _mcap_decompress(
                compression, content[off + 8:off + 8 + rec_len], usize)
            for op2, c2 in _mcap_records(records):
                handle(op2, c2)

    for op, content in _mcap_records(buf, 8):
        if op in (_OP_DATA_END, _OP_FOOTER):
            break
        handle(op, content)
    out.sort(key=lambda m: m[2])
    yield from out


def _mcap_record(op: int, content: bytes) -> bytes:
    return bytes([op]) + struct.pack("<Q", len(content)) + content


def _mcap_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def write_bag_mcap(path: str,
                   messages: list[tuple[str, str, int, bytes]],
                   compression: str = "") -> None:
    """Write records as a minimal valid mcap file (ros2 profile). With
    ``compression='zstd'`` the messages go into one compressed chunk —
    used by tests to exercise the chunked read path; that needs the
    ``zstandard`` module, which the machine with the card lacks."""
    schemas: dict[str, int] = {}
    channels: dict[str, int] = {}
    defs = b""
    body = b""
    for topic, typ, ts, data in sorted(messages, key=lambda m: m[2]):
        if typ not in schemas:
            schemas[typ] = len(schemas) + 1
            defs += _mcap_record(
                _OP_SCHEMA, struct.pack("<H", schemas[typ])
                + _mcap_str(typ) + _mcap_str("ros2msg")
                + struct.pack("<I", 0))
        if topic not in channels:
            channels[topic] = len(channels) + 1
            defs += _mcap_record(
                _OP_CHANNEL, struct.pack("<HH", channels[topic],
                                         schemas[typ])
                + _mcap_str(topic) + _mcap_str("cdr")
                + struct.pack("<I", 0))
        body += _mcap_record(
            _OP_MESSAGE, struct.pack("<HIQQ", channels[topic], 0, ts, ts)
            + data)
    records = defs + body
    if compression == "zstd":
        import zstandard
        comp = zstandard.ZstdCompressor().compress(records)
        t0 = min((m[2] for m in messages), default=0)
        t1 = max((m[2] for m in messages), default=0)
        payload = (struct.pack("<QQQI", t0, t1, len(records), 0)
                   + _mcap_str("zstd")
                   + struct.pack("<Q", len(comp)) + comp)
        records = _mcap_record(_OP_CHUNK, payload)
    out = (_MCAP_MAGIC
           + _mcap_record(_OP_HEADER, _mcap_str("ros2") + _mcap_str(""))
           + records
           + _mcap_record(_OP_DATA_END, struct.pack("<I", 0))
           + _mcap_record(_OP_FOOTER, struct.pack("<QQI", 0, 0, 0))
           + _MCAP_MAGIC)
    with open(path, "wb") as fh:
        fh.write(out)


def read_bag_any(path: str, topics: list[str] | None = None
                 ) -> Iterator[tuple[str, str, int, bytes]]:
    """Dispatch on storage format: .mcap or sqlite3 (.db3 / anything
    else, matching rosbag2's default)."""
    if str(path).endswith(".mcap"):
        return read_bag_mcap(path, topics)
    return read_bag(path, topics)
