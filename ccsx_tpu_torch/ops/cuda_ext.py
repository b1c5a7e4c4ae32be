"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled on first use by its own ``nvcc`` process (all of
them started together) into a shared library with a plain C interface,
which is loaded with ctypes; the libraries go to ``build/ccsx_tpu_torch_ext``
beside the package, named by a hash of the source and the flags, so an
unchanged source is not rebuilt.  Kernels launch on PyTorch's current
stream; every launcher returns ``cudaGetLastError()`` and ``check`` raises
on anything but success.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels
its path went through.  A CUDA graph replay (pipeline/graphs.py) launches
without calling a wrapper: it adds the launches its capture recorded
(``add``), and what a thread counts inside ``tally()`` (a capture, which
launches nothing, or a program's priming run) goes to that tally instead.
What ``LAUNCHES`` gets is also added to the counts of the caller's
``scope()``, where there is one: a served job's own launches, eager refine
dispatches and graph replays, counted across its threads (the prep pool's
threads inherit the job's context through ``faultinject.inherit``) while
other jobs run beside it.  Under a device mesh (parallel/mesh.py) each
logical device's work runs inside ``lane(i)``, and what ``LAUNCHES`` gets
there is also added to ``LANE_LAUNCHES[i]``: the launches of each logical
device, which add up to ``LAUNCHES``' share of the mesh's steps.

Every launcher runs under ``torch.cuda.device(x.device)``: the libraries
carry their own CUDA runtime, which launches in whatever context is
current on the calling thread, so the thread's current device is made the
tensors' before the launch (and the stream passed is that device's current
one).

A kernel that fails to build or launch raises ``KernelError``, and a wrapper
that refuses its tensors on the card raises its subclass ``RefusedInputs``:
the caller cannot go on without the kernel, so no hole quarantine or
per-request replay may swallow either.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "ccsx_tpu_torch_ext")
SOURCES = ("banded_fill", "banded_rotband", "traceback_walk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-lineinfo", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"banded_global": 0, "banded_local": 0, "banded_rotband": 0,
            "traceback_walk": 0}

# logical device (a mesh entry's index) -> its launches, for lane()
LANE_LAUNCHES: dict = {}

_lock = threading.Lock()
_tls = threading.local()
# the counts of the calling context's scope(), or None
_scope: "contextvars.ContextVar[dict | None]" = contextvars.ContextVar(
    "ccsx_launch_scope", default=None)


class KernelError(RuntimeError):
    """A kernel did not build, load or launch."""


class RefusedInputs(KernelError):
    """A wrapper refused the tensors it was given for its kernel: a fault of
    the calling code, which every later call of that shape repeats, so it
    ends the run as a failed launch does."""


_libs: dict = {}


def count(name: str) -> None:
    tally_ = getattr(_tls, "tally", None)
    if tally_ is not None:
        tally_[name] += 1
        return
    with _lock:
        LAUNCHES[name] += 1
        sc = _scope.get()
        if sc is not None:
            sc["launches"][name] += 1
        _add_lane(name, 1)


def _add_lane(name: str, n: int) -> None:
    """Book ``n`` launches of ``name`` to this thread's lane (holds _lock)."""
    ln = getattr(_tls, "lane", None)
    if ln is not None:
        per = LANE_LAUNCHES.setdefault(ln, dict.fromkeys(LAUNCHES, 0))
        per[name] += n


@contextlib.contextmanager
def lane(i: int):
    """For the duration, book this thread's launches to logical device
    ``i`` too (``LANE_LAUNCHES``)."""
    prev = getattr(_tls, "lane", None)
    _tls.lane = i
    try:
        yield
    finally:
        _tls.lane = prev


@contextlib.contextmanager
def tally():
    """Count this thread's launches into a fresh dict, not LAUNCHES, for
    the duration."""
    prev = getattr(_tls, "tally", None)
    _tls.tally = dict.fromkeys(LAUNCHES, 0)
    try:
        yield _tls.tally
    finally:
        _tls.tally = prev


def add(counts: dict) -> None:
    """Add launches made without a wrapper call (a graph replay's)."""
    with _lock:
        sc = _scope.get()
        for name, n in counts.items():
            LAUNCHES[name] += n
            if sc is not None:
                sc["launches"][name] += n
            if n:
                _add_lane(name, n)


@contextlib.contextmanager
def scope():
    """For the duration, also count the calling context's launches (this
    thread's, and those of threads started with its context) into a fresh
    ``{"launches": {kernel: n}, "eager_dispatches": n, "graph_replays": n}``,
    which is yielded; the refine programs (pipeline/graphs.py) add their
    dispatches with ``scoped``."""
    counts = {"launches": dict.fromkeys(LAUNCHES, 0), "eager_dispatches": 0,
              "graph_replays": 0}
    token = _scope.set(counts)
    try:
        yield counts
    finally:
        _scope.reset(token)


def scoped(key: str) -> None:
    """Add one to ``key`` of the calling context's scope, if any."""
    sc = _scope.get()
    if sc is not None:
        with _lock:
            sc[key] += 1


def reset_counts() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        LANE_LAUNCHES.clear()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str) -> str:
    """The library path: named by a hash of the source and the code flags
    (the -Xptxas -v report flag changes no code and is left out)."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=SOURCES, ptxas_verbose: bool = False) -> dict:
    """Compile every listed source that has no up-to-date library, one nvcc
    process per source, all started together.  Returns {name: compiler
    output} for the sources it compiled (the -Xptxas -v report when asked)."""
    extra = ("-Xptxas", "-v") if ptxas_verbose else ()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    logs = {}
    for name, (proc, tmp, out) in procs.items():
        text = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise KernelError(f"nvcc failed on {name}.cu:\n{text}")
        os.replace(tmp, out)
        logs[name] = text
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(SOURCES)
            lib = ctypes.CDLL(_target(name))
            lib.ccsx_error_string.argtypes = [ctypes.c_int]
            lib.ccsx_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def load_all() -> None:
    """Build and load every kernel library now (a run on the card calls
    this before its first hole, so a build failure ends the run)."""
    for name in SOURCES:
        library(name)


def timed_build(ptxas_verbose: bool = False):
    """(seconds, logs) of building every kernel source."""
    t0 = time.perf_counter()
    logs = build(SOURCES, ptxas_verbose=ptxas_verbose)
    return time.perf_counter() - t0, logs


def is_device_fault(e: BaseException) -> bool:
    """A failure of the card or a kernel (sticky for every later hole), as
    opposed to one hole's bad data.  A CUDA out-of-memory error is neither:
    the batched driver recovers from it by splitting the slab."""
    import torch

    if isinstance(e, torch.cuda.OutOfMemoryError):
        return False
    if isinstance(e, KernelError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA" in str(e)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.ccsx_error_string(rc).decode(errors="replace")
        raise KernelError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(what: str, *tensors) -> None:
    """Every tensor on one CUDA device, contiguous in its last dimension (a
    last dimension of size 1 has no stride to speak of: a kernel only ever
    reads its element 0)."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev or x.device.type != "cuda":
            raise RefusedInputs(f"{what}: all inputs must be on one CUDA "
                                "device")
        if x.dim() and x.shape[-1] > 1 and x.stride(-1) != 1:
            raise RefusedInputs(f"{what}: inputs must be contiguous rows")
