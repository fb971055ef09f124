"""Build and load the port's CUDA kernels and its host image codec.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled at first
use, on the machine with the card, by ``nvcc`` into a shared library
under ``kernels/build/`` (listed in ``.gitignore``), then loaded with
``ctypes``. The host sources (``HOST_SOURCES``: C++ with a plain C
interface, no CUDA) are built the same way by the system's C++ compiler
(``c++``, else ``g++``), on any machine. The library's file name carries
a hash of the source, of every header beside it (``*.cuh`` for a kernel,
``*.h`` for a host source: a source may include any of them) and of the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. The compiler's output is kept in
``build/<name>-<hash>.log`` (for a kernel, ``-Xptxas=-v``'s register and
spill report).

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")
# host libraries by name: C++ sources outside csrc/
HOST_SOURCES = {"image_codec": pathlib.Path(__file__).resolve().parents[1]
                / "utils" / "csrc" / "image_codec.cpp"}

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _cxx() -> str:
    for cand in ("c++", "g++"):
        found = shutil.which(cand)
        if found is not None:
            return found
    raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the image "
                       "codec is built from its source at first use")


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _source(name: str) -> tuple[pathlib.Path, str, tuple]:
    """(source, header pattern, flags) of a kernel or host library."""
    if name in HOST_SOURCES:
        return HOST_SOURCES[name], "*.h", CXX_FLAGS
    return CSRC / f"{name}.cu", "*.cuh", NVCC_FLAGS


def library_path(name: str) -> pathlib.Path:
    src, headers, flags = _source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob(headers)):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen | None:
    """Start the compiler for one source unless its library is already
    built."""
    out = library_path(name)
    if out.exists():
        return None
    src, _, flags = _source(name)
    compiler = _cxx() if name in HOST_SOURCES else _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src)]
    log = open(out.with_suffix(".log"), "w")
    try:
        return subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()


def _finish(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    rc = proc.wait()
    if rc != 0:
        log = out.with_suffix(".log").read_text()
        raise RuntimeError(f"{proc.args[0]} failed for {name} (rc {rc}):\n"
                           f"{log}")
    os.replace(tmp, out)       # atomic: a reader never sees a partial file


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Compile the named libraries (default: every ``csrc/*.cu`` kernel),
    all compiler processes started together. Returns wall seconds per name
    (0.0 where the library was already built)."""
    if names is None:
        names = kernel_names()
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    secs = {}
    for n, p in procs.items():
        _finish(n, p)
        secs[n] = time.perf_counter() - t0 if p is not None else 0.0
    return secs


def build_log(name: str) -> str:
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load a kernel or host library; cached per
    process."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
