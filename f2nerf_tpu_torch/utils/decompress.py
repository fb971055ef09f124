"""Zstandard and LZ4-frame decompression for compressed MCAP chunks.

The JAX package decompresses a bag's chunks with the ``zstandard`` and
``lz4`` modules, which the machine with the card lacks. The port decodes
them with its own C++ library, ``csrc/chunk_codec.cpp``, built at first
use by the system's C++ compiler (``kernels/build.py``); where it cannot
be built the call raises with the compiler's log. Nothing here turns to
``zstandard`` or ``lz4``, even where they are installed.

* :func:`zstd_decompress`: every frame of the data (RFC 8878; skippable
  frames skipped, concatenated frames joined, each content checksum
  verified). Frames with a dictionary and legacy (v0.x) frames raise.
* :func:`lz4_frame_decompress`: LZ4 frames, linked or independent
  blocks, every checksum verified. Frames with a dictionary raise.

Both take the size the data must decode to (an MCAP chunk's
``uncompressed_size``): output of any other size raises ``ValueError``,
as does corrupt or truncated input; the library checks every read and
write against its buffer.

:func:`decoded_modes` returns how often the library decoded each block,
literal and table mode in this process; the tests read it to show that
every branch was reached.
"""

from __future__ import annotations

import ctypes

from f2nerf_tpu_torch.kernels import build

_ERR_LEN = 512


def _codec() -> ctypes.CDLL:
    """``csrc/chunk_codec.cpp``, built at first use (raises with the
    compiler's log where it cannot be)."""
    lib = build.load_library("chunk_codec")
    if not hasattr(lib, "signatures_set"):
        args = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
        for fn in (lib.f2_zstd_decompress, lib.f2_lz4f_decompress):
            fn.argtypes, fn.restype = args, ctypes.c_longlong
        lib.f2_xxh32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                 ctypes.c_uint32]
        lib.f2_xxh32.restype = ctypes.c_uint32
        lib.f2_chunk_mode_names.restype = ctypes.c_char_p
        lib.f2_chunk_modes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.f2_chunk_modes.restype = ctypes.c_int
        lib.signatures_set = True
    return lib


def _decompress(fn_name: str, data: bytes, size: int) -> bytes:
    data = bytes(data)
    fn = getattr(_codec(), fn_name)
    out = bytearray(size)
    buf = (ctypes.c_char * size).from_buffer(out) if size else None
    err = ctypes.create_string_buffer(_ERR_LEN)
    got = fn(data, len(data), buf, size, err, _ERR_LEN)
    if got == -2:
        raise MemoryError("the chunk codec ran out of memory")
    if got < 0:
        raise ValueError(err.value.decode(errors="replace"))
    if got != size:
        raise ValueError(f"the data decodes to {got} bytes, not the "
                         f"expected {size}")
    return bytes(out)


def zstd_decompress(data: bytes, size: int) -> bytes:
    """Every Zstandard frame of ``data``, which must decode to ``size``
    bytes."""
    return _decompress("f2_zstd_decompress", data, size)


def lz4_frame_decompress(data: bytes, size: int) -> bytes:
    """Every LZ4 frame of ``data``, which must decode to ``size``
    bytes."""
    return _decompress("f2_lz4f_decompress", data, size)


def xxh32(data: bytes, seed: int = 0) -> int:
    """The library's XXH32, which checks LZ4 frames."""
    return _codec().f2_xxh32(bytes(data), len(data), seed)


def decoded_modes() -> dict[str, int]:
    """{mode: times decoded in this process}."""
    lib = _codec()
    names = lib.f2_chunk_mode_names().decode().rstrip(",").split(",")
    counts = (ctypes.c_longlong * len(names))()
    lib.f2_chunk_modes(counts, len(names))
    return dict(zip(names, counts))
