"""Native (C++) IO layer loader.

Builds the library from io_native.cpp, align_native.cpp and
baseline_simd.cpp (copies of the JAX package's) on first use if a compiler
is present, loads it via ctypes, and exposes ``lib()``.  Beside the IO
layer it carries the scalar Gotoh aligner (native/align.py, the oracle's
twin) and the CPU banded-fill baseline, built twice from one source as the
JAX package's Makefile builds it (``ccsx_banded_fill_vec`` at the package
flags, ``ccsx_banded_fill_scalar`` at -O2 with the vectorizers off);
nothing on the run path calls those two.  Import never fails: callers check ``available()`` and fall back
to the pure-Python parsers (ccsx_tpu_torch.io.fastx / ccsx_tpu_torch.io.bam)
when the toolchain is absent.

The build is two ``g++`` calls (the scalar object, then the library), as
ops/cuda_ext.py calls ``nvcc``: into ``build/ccsx_tpu_torch_native/``
beside the package (never the package directory), named by a hash of the
sources, the flags and the host CPU (the flags say ``-march=native``),
written to temp files and moved into place with ``os.replace``, so
processes that build at the same moment each land a whole library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "io_native.cpp")
# the aligner and the baseline fill, linked beside the IO layer
AIDS = tuple(os.path.join(_DIR, f) for f in ("align_native.cpp",
                                             "baseline_simd.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "ccsx_tpu_torch_native")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-Wall", "-Wextra",
             "-std=c++17", "-pthread", "-shared")
LIBS = ("-lz", "-lpthread")
# baseline_simd.cpp's scalar control: identical source, vectorizers off
SCALAR_FLAGS = ("-O2", "-fno-tree-vectorize", "-fno-tree-slp-vectorize",
                "-fPIC", "-Wall", "-Wextra", "-std=c++17", "-pthread",
                "-DCCSX_VARIANT_SCALAR")
_lock = threading.Lock()
_lib = None
_tried = False
_build_error: "str | None" = None
# what the last lib() did: "built" (with its seconds) or "loaded"
load_state: dict = {}


def _log_path() -> str:
    return os.path.join(BUILD_DIR, "build.log")


def _note_failure(summary: str, output: str) -> None:
    """A failed/stale auto-rebuild used to be SILENT (the native path
    just disappeared and ingest got mysteriously slow): persist the
    compiler output, print one loud line with the path, and remember
    the summary for Metrics (booked as native_build_error in every
    metrics event)."""
    global _build_error
    log_hint = ""
    if output:
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            with open(_log_path(), "w", encoding="utf-8") as f:
                f.write(output)
            log_hint = f"; compiler log: {_log_path()}"
        except OSError:
            pass
    _build_error = summary
    print(f"[ccsx-tpu-torch] WARNING: native IO rebuild FAILED — falling "
          f"back to the pure-Python parsers (same bytes, slower ingest): "
          f"{summary}{log_hint}", file=sys.stderr)


def _host_key() -> bytes:
    """The CPU's model and feature flags: a library built with
    -march=native on one host must not load on another."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def target() -> str:
    """The library path: named by a hash of the sources, the flags and the
    host CPU."""
    h = hashlib.sha256()
    for src in (SOURCE,) + AIDS:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS + SCALAR_FLAGS).encode())
    h.update(_host_key())
    return os.path.join(BUILD_DIR, f"libccsx_io-{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    cxx = os.environ.get("CXX", "g++")
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    obj = f"{tmp}.scalar.o"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        for cmd in ([cxx, *SCALAR_FLAGS, "-c", "-o", obj, AIDS[1]],
                    [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, *AIDS, obj,
                     *LIBS]):
            r = subprocess.run(cmd, check=False, capture_output=True,
                               timeout=120, text=True)
            if r.returncode != 0:
                break
    except (OSError, subprocess.SubprocessError) as e:
        _note_failure(f"{type(e).__name__}: {e}", "")
        _unlink(tmp, obj)
        return False
    if r.returncode != 0:
        err = (r.stderr or r.stdout or "").strip()
        first = next((ln for ln in err.splitlines() if ln.strip()),
                     f"{cxx} rc {r.returncode}")
        _note_failure(first[:200], (r.stdout or "") + (r.stderr or ""))
        _unlink(tmp, obj)
        return False
    _unlink(obj)
    os.replace(tmp, out)
    return True


def _unlink(*paths: str) -> None:
    for p in paths:
        try:
            os.unlink(p)
        except OSError:
            pass


def build_error() -> "str | None":
    """One-line summary of a failed native auto-rebuild this process
    observed (None when the native path loaded or was never needed).
    Read by Metrics.snapshot() so every metrics event carries the
    degradation."""
    return _build_error


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    lib.ccsx_open.restype = c.c_void_p
    lib.ccsx_open.argtypes = [c.c_char_p, c.c_int]
    lib.ccsx_set_filter.restype = None
    lib.ccsx_set_filter.argtypes = [c.c_void_p, c.c_int32, c.c_int64,
                                    c.c_int64]
    lib.ccsx_next_zmw.restype = c.c_int
    lib.ccsx_next_zmw.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_char_p), c.POINTER(c.c_char_p),
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
        c.POINTER(c.POINTER(c.c_int32)), c.POINTER(c.c_int32),
    ]
    lib.ccsx_next_record.restype = c.c_int
    lib.ccsx_next_record.argtypes = [
        c.c_void_p,
        c.POINTER(c.c_char_p), c.POINTER(c.c_char_p),
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
        c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_int64),
    ]
    lib.ccsx_error.restype = c.c_char_p
    lib.ccsx_error.argtypes = [c.c_void_p]
    # filter accounting (guarded: a stale prebuilt .so without the
    # symbols must degrade to "counts unavailable", not fail to load)
    for name in ("ccsx_filter_counts", "ccsx_prefetch_filter_counts"):
        try:
            fn = getattr(lib, name)
        except AttributeError:
            continue
        fn.restype = None
        fn.argtypes = [c.c_void_p] + [c.POINTER(c.c_int64)] * 3
    # salvage-mode ingest (same stale-.so guard: native/io.py falls
    # back to the pure-Python salvage readers when these are absent)
    try:
        lib.ccsx_set_salvage.restype = None
        lib.ccsx_set_salvage.argtypes = [c.c_void_p, c.c_int, c.c_int64]
        lib.ccsx_prefetch_open_s.restype = c.c_void_p
        lib.ccsx_prefetch_open_s.argtypes = [
            c.c_char_p, c.c_int, c.c_int32, c.c_int64, c.c_int64,
            c.c_int32, c.c_int, c.c_int64]
        for name in ("ccsx_error_reason", "ccsx_prefetch_error_reason",
                     "ccsx_corrupt_summary",
                     "ccsx_prefetch_corrupt_summary"):
            fn = getattr(lib, name)
            fn.restype = c.c_char_p
            fn.argtypes = [c.c_void_p]
        for name in ("ccsx_corrupt_events",
                     "ccsx_prefetch_corrupt_events",
                     "ccsx_corrupt_exempt",
                     "ccsx_prefetch_corrupt_exempt"):
            fn = getattr(lib, name)
            fn.restype = c.c_int64
            fn.argtypes = [c.c_void_p]
    except AttributeError:
        pass
    lib.ccsx_close.restype = None
    lib.ccsx_close.argtypes = [c.c_void_p]
    for name in ("ccsx_encode", "ccsx_revcomp_ascii", "ccsx_revcomp_codes"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_uint8)]
    lib.ccsx_prefetch_open.restype = c.c_void_p
    lib.ccsx_prefetch_open.argtypes = [c.c_char_p, c.c_int, c.c_int32,
                                       c.c_int64, c.c_int64, c.c_int32]
    lib.ccsx_prefetch_next.restype = c.c_int
    lib.ccsx_prefetch_next.argtypes = lib.ccsx_next_zmw.argtypes
    lib.ccsx_prefetch_error.restype = c.c_char_p
    lib.ccsx_prefetch_error.argtypes = [c.c_void_p]
    lib.ccsx_prefetch_close.restype = None
    lib.ccsx_prefetch_close.argtypes = [c.c_void_p]
    lib.ccsx_writer_open.restype = c.c_void_p
    lib.ccsx_writer_open.argtypes = [c.c_char_p, c.c_int]
    lib.ccsx_writer_put_fasta.restype = c.c_int
    lib.ccsx_writer_put_fasta.argtypes = [c.c_void_p, c.c_char_p,
                                          c.POINTER(c.c_uint8), c.c_int64]
    lib.ccsx_writer_put_fastq.restype = c.c_int
    lib.ccsx_writer_put_fastq.argtypes = [c.c_void_p, c.c_char_p,
                                          c.POINTER(c.c_uint8),
                                          c.POINTER(c.c_uint8), c.c_int64]
    lib.ccsx_writer_close.restype = c.c_int
    lib.ccsx_writer_close.argtypes = [c.c_void_p]
    lib.ccsx_bgzf_pool_bench.restype = c.c_double
    lib.ccsx_bgzf_pool_bench.argtypes = [c.c_char_p, c.c_int, c.c_int]
    lib.ccsx_align_scalar.restype = c.c_int
    lib.ccsx_align_scalar.argtypes = [
        c.POINTER(c.c_uint8), c.c_int64, c.POINTER(c.c_uint8), c.c_int64,
        c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int64), c.POINTER(c.c_uint8), c.c_int64,
        c.POINTER(c.c_int64),
    ]
    # the CPU baseline's banded fill, vectorized and scalar builds
    for name in ("ccsx_banded_fill_vec", "ccsx_banded_fill_scalar"):
        fn = getattr(lib, name)
        fn.restype = c.c_int
        fn.argtypes = [c.POINTER(c.c_uint8), c.c_int64,
                       c.POINTER(c.c_uint8), c.c_int64,
                       c.c_int, c.c_int, c.c_int, c.c_int,
                       c.POINTER(c.c_int16)]
    lib.ccsx_banded_fill_many.restype = c.c_int64
    lib.ccsx_banded_fill_many.argtypes = [
        c.POINTER(c.c_uint8), c.POINTER(c.c_uint8), c.c_int64, c.c_int64,
        c.c_int64, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int, c.c_int,
        c.POINTER(c.c_int16)]
    return lib


def lib():
    """The loaded native library, or None when unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = target()
        if os.path.exists(so):
            load_state.update(state="loaded", seconds=0.0)
        else:
            t0 = time.perf_counter()
            if not _build(so):
                load_state.update(state="failed", seconds=0.0)
                return None
            load_state.update(state="built",
                              seconds=time.perf_counter() - t0)
        try:
            _lib = _bind(ctypes.CDLL(so))
        except OSError as e:
            # a built .so that will not load (e.g. a leftover TSAN/ASAN
            # instrumented build, static-TLS failures) is the same
            # silent degradation as a failed compile — say so
            _note_failure(f"libccsx_io.so failed to load: {e}", "")
            load_state.update(state="failed")
            _lib = None
    return _lib


def available() -> bool:
    return lib() is not None
