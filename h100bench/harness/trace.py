"""The traced run's device record: ``torch.profiler`` (CUDA activity only)
over the whole window, and a sampler of what the driver thread was doing.

The profiler gives every kernel, copy and set on the device with its start
and length: read from its results, with no trace file, where their first
operation is the marker, else from the Chrome trace it writes.  The marker,
a kernel launched at a known host time, ties the profiler's clock to the
host's.  From them:

* ``busy_s``: the union of the device's operations inside the window;
* ``kernel_s``: seconds by kernel name (the name before its argument list);
* the idle gaps, each named by the program function the driver thread was
  in when sampled during it (every ``SAMPLE_S``), summed by that name.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
import threading
import time
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SAMPLE_S = 0.005
PACKAGE = "ccsx_tpu_torch"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list (the first parenthesis outside template brackets)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for at, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and at:
            name = name[:at]
            break
    return name[:120].strip()


def base_name(name: str) -> str:
    """``short_name`` without its template arguments."""
    return name.split("<", 1)[0]


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def busy_and_gaps(ops: List[Tuple[float, float]], lo: float, hi: float):
    """(busy seconds, idle gaps) of device operations [(start, end)] inside
    the window [lo, hi]."""
    busy = merge(clip(ops, lo, hi))
    gaps = []
    t = lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return sum(b - a for a, b in busy), gaps


def name_gaps(gaps, samples: List[Tuple[float, str]]) -> Dict[str, float]:
    """Idle seconds by what the host was doing: each gap's seconds shared
    among the labels sampled in it; a gap no sample fell in is booked as
    shorter than the sampling interval."""
    times = [t for t, _ in samples]
    out: Dict[str, float] = {}
    for a, b in gaps:
        i = bisect.bisect_left(times, a)
        j = bisect.bisect_right(times, b)
        labels = [samples[k][1] for k in range(i, j)]
        if not labels:
            key = f"gaps under {SAMPLE_S * 1e3:g} ms"
            out[key] = out.get(key, 0.0) + (b - a)
            continue
        share = (b - a) / len(labels)
        for lab in labels:
            out[lab] = out.get(lab, 0.0) + share
    return out


def frame_label(frame) -> str:
    """The innermost frame of the program, as package-relative file and
    function; the innermost frame if none is the program's."""
    f = frame
    while f is not None:
        fn = f.f_code.co_filename
        at = fn.rfind(os.sep + PACKAGE + os.sep)
        if at >= 0:
            rel = fn[at + len(PACKAGE) + 2:]
            return f"{rel}:{f.f_code.co_name}"
        f = f.f_back
    if frame is None:
        return "idle"
    return (f"{os.path.basename(frame.f_code.co_filename)}:"
            f"{frame.f_code.co_name}")


class Sampler:
    def __init__(self, thread_id: int, interval: float = SAMPLE_S):
        self.tid = thread_id
        self.interval = interval
        self.samples: List[Tuple[float, str]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="h100bench-sampler")

    def _run(self):
        while not self._stop.wait(self.interval):
            frame = sys._current_frames().get(self.tid)
            self.samples.append((time.perf_counter(), frame_label(frame)))

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=10)


def _ns(event, what: str) -> float:
    f = getattr(event, what + "_ns", None)
    return f() if f is not None else getattr(event, what + "_us")() * 1e3


def results_ops(prof, cats=DEVICE_CATS, device=None):
    """(name, start ns, length ns) of each device operation, read from the
    profiler's results; None where they hold none.  Where this torch's
    events do not name their kind (``cats``), the operations are every
    event on ``device`` (a ``torch.autograd.DeviceType``, the card's by
    default) but the annotations."""
    try:
        events = prof.profiler.kineto_results.events()
        mine = []
        if events and hasattr(events[0], "activity_type"):
            mine = [e for e in events if e.activity_type() in cats]
        if not mine:
            if device is None:
                from torch.autograd import DeviceType
                device = DeviceType.CUDA
            mine = [e for e in events if e.device_type() == device
                    and not getattr(e, "is_user_annotation",
                                    lambda: False)()]
        ops = [(e.name(), _ns(e, "start"), _ns(e, "duration"))
               for e in mine]
    except (AttributeError, ImportError):
        return None
    return ops or None


def file_ops(prof, path: str, cats=DEVICE_CATS):
    """The same from the profiler's Chrome trace, written to ``path``."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [(e.get("name", "?"), float(e["ts"]) * 1e3,
             float(e["dur"]) * 1e3)
            for e in events if e.get("cat") in cats and "dur" in e]


def device_ops(prof, path: str):
    """(the device's operations, where they were read): the profiler's
    results where their first operation is the marker (the spin_kernel of
    ``torch.cuda._sleep``), else its trace file."""
    ops = results_ops(prof)
    if ops and "spin_kernel" in min(ops, key=lambda o: o[1])[0]:
        return ops, "results"
    return file_ops(prof, path), "file"


class DeviceTrace:
    """Profile the device from ``start`` to ``stop``; ``analyse(lo, hi)``
    reads the window [lo, hi] of the host's ``perf_counter`` clock."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.ops: List[Tuple[str, float, float]] = []
        self.source = None
        self.sampler = Sampler(threading.get_ident())

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.sampler.start()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.sampler.stop()
        self.prof.__exit__(None, None, None)
        self.ops, self.source = device_ops(self.prof, self.path)
        self.prof = None

    def analyse(self, lo: float, hi: float) -> dict:
        if not self.ops:
            return {"busy_s": None, "window_s": hi - lo, "kernel_s": {},
                    "idle": {}}
        ops = sorted(self.ops, key=lambda o: o[1])
        # the first device operation is the marker launched at a known time
        mark, at = ops[0][1], self._marker_host
        spans = [((s - mark) * 1e-9 + at, (s + d - mark) * 1e-9 + at)
                 for _, s, d in ops[1:]]
        busy, gaps = busy_and_gaps(spans, lo, hi)
        kernel_s: Dict[str, float] = {}
        short: Dict[str, str] = {}
        for (name, _, _), (a, b) in zip(ops[1:], spans):
            if b <= lo or a >= hi:
                continue
            k = short.get(name)
            if k is None:
                k = short[name] = short_name(name)
            kernel_s[k] = kernel_s.get(k, 0.0) + (min(b, hi) - max(a, lo))
        return {"busy_s": busy, "window_s": hi - lo, "kernel_s": kernel_s,
                "idle": name_gaps(gaps, self.sampler.samples)}
