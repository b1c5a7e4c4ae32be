"""Crash-persistent black-box recorder (a copy of the JAX package's
utils/blackbox.py).

A hung or SIGKILLed process takes its in-memory trace buffer with it.
This module is the flight-data recorder: a small file-backed mmap ring
buffer per process into which the tracer and metrics planes mirror their
last-N events.  Because the ring is a *file-backed* mmap, dirty pages
survive the process — the kernel owns them the moment they are written,
so a SIGKILL (which gives the process no chance to flush anything) still
leaves a readable dump with the in-flight span named.

Format (version 1, the JAX package's, so either package reads the
other's dumps):

    [64-byte header] [capacity bytes of ring data]
    header: magic "CCSXBB01" (8) | u32 version | u32 pad
            | u64 capacity @16 | u64 head @24 | zeros
    data:   newline-terminated JSON records written at head % capacity,
            wrapping; head is the TOTAL bytes ever written (never
            wraps), so a reader knows both the write cursor and whether
            the ring has lapped.  After a lap the oldest line is
            usually torn mid-record; the reader drops it.

Writers never read the ring and readers never lock it: a dump is read
from a *dead* process' file (or a live one's, tolerating one torn
record at the seam).  Recording is enabled by the ``CCSX_BLACKBOX``
environment variable naming a DIRECTORY; each process writes
``blackbox.<pid>.bin`` there.  ``ccsx-tpu-torch blackbox <path>``
renders a dump (cli.py -> blackbox_main).

Deliberately dependency-free: it imports neither torch nor jax, so the
``blackbox`` subcommand reads a dump on a host whose card is wedged,
and a record costs about one dict dump.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import sys
import threading
import time
from typing import List, Optional

MAGIC = b"CCSXBB01"
VERSION = 1
HEADER = 64
_CAP_OFF = 16             # u64 capacity (after magic + version + pad)
_HEAD_OFF = 24            # u64 head = TOTAL bytes ever written
DEFAULT_CAPACITY = 1 << 18   # 256 KiB ~ last few thousand events
ENV_DIR = "CCSX_BLACKBOX"
ENV_CAP = "CCSX_BLACKBOX_CAP"


def box_path(d: str, pid: Optional[int] = None) -> str:
    """The per-process ring file name inside a black-box dir —
    deterministic from the pid, which is exactly what a reaper that
    only knows the dead child's pid needs."""
    return os.path.join(d, f"blackbox.{os.getpid() if pid is None else pid}.bin")


class BlackBox:
    """One process' ring writer.  Thread-safe (the tracer's watchdog
    thread and the driver record concurrently).  All record() failures
    are swallowed — the black box must never take the plane down."""

    def __init__(self, path: str, capacity: int = DEFAULT_CAPACITY):
        self.path = path
        self.capacity = max(int(capacity), 4096)
        self._lock = threading.Lock()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # O_CREAT without O_EXCL: a restarted pid reuses (and laps) its
        # old ring — the head read back from a valid header resumes it
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            size = HEADER + self.capacity
            st = os.fstat(self._fd)
            fresh = st.st_size != size
            if fresh:
                os.ftruncate(self._fd, size)
            self._mm = mmap.mmap(self._fd, size)
        except (OSError, ValueError):
            os.close(self._fd)
            raise
        if (not fresh and self._mm[:8] == MAGIC
                and struct.unpack_from("<Q", self._mm, _CAP_OFF)[0]
                == self.capacity):
            # a restarted pid resumes (and laps) its old ring
            self.head = struct.unpack_from("<Q", self._mm, _HEAD_OFF)[0]
        else:
            self.head = 0
            self._mm[:HEADER] = b"\0" * HEADER
            self._mm[:8] = MAGIC
            struct.pack_into("<II", self._mm, 8, VERSION, 0)
            struct.pack_into("<Q", self._mm, _CAP_OFF, self.capacity)
        struct.pack_into("<Q", self._mm, _HEAD_OFF, self.head)

    def record(self, rec: dict) -> None:
        try:
            line = (json.dumps(rec, separators=(",", ":"))
                    .encode("utf-8", "replace") + b"\n")
        except (TypeError, ValueError):
            return
        if len(line) > self.capacity:
            return            # one giant record cannot lap itself
        with self._lock:
            try:
                pos = self.head % self.capacity
                end = pos + len(line)
                if end <= self.capacity:
                    self._mm[HEADER + pos:HEADER + end] = line
                else:
                    split = self.capacity - pos
                    self._mm[HEADER + pos:HEADER + self.capacity] = \
                        line[:split]
                    self._mm[HEADER:HEADER + end - self.capacity] = \
                        line[split:]
                self.head += len(line)
                struct.pack_into("<Q", self._mm, _HEAD_OFF, self.head)
            except (OSError, ValueError):
                pass

    def note(self, kind: str, **fields) -> None:
        """A convenience record with the standard envelope (wall ts +
        pid) — the 'inflight' notes the reaper greps for."""
        self.record({"bb": kind, "ts": round(time.time(), 6),
                     "pid": os.getpid(), **fields})

    def close(self) -> None:
        with self._lock:
            try:
                self._mm.close()
            except (OSError, ValueError):
                pass
            try:
                os.close(self._fd)
            except OSError:
                pass


# ---- process-global singleton ----------------------------------------------

_inst: Optional[BlackBox] = None
_inst_pid: Optional[int] = None
_inst_lock = threading.Lock()


def get() -> Optional[BlackBox]:
    """The process' recorder, or None when CCSX_BLACKBOX is unset (the
    plane-off default: zero cost, zero files).  Lazily opened; fork-
    aware (a forked child re-opens under its own pid so two processes
    never share one ring head)."""
    global _inst, _inst_pid
    d = os.environ.get(ENV_DIR)
    if not d:
        return None
    pid = os.getpid()
    if _inst is not None and _inst_pid == pid:
        return _inst
    with _inst_lock:
        if _inst is not None and _inst_pid == pid:
            return _inst
        try:
            cap = int(os.environ.get(ENV_CAP, "") or DEFAULT_CAPACITY)
        except ValueError:
            cap = DEFAULT_CAPACITY
        try:
            _inst = BlackBox(box_path(d), capacity=cap)
            _inst_pid = pid
        except (OSError, ValueError) as e:
            # an unwritable dir disables the recorder, loudly once
            print(f"[ccsx-tpu-torch] blackbox disabled: {e}", file=sys.stderr)
            os.environ.pop(ENV_DIR, None)
            _inst = None
        return _inst


def record(rec: dict) -> None:
    bb = get()
    if bb is not None:
        bb.record(rec)


def note(kind: str, **fields) -> None:
    bb = get()
    if bb is not None:
        bb.note(kind, **fields)


def reset() -> None:
    """Test hook: drop the singleton so a changed CCSX_BLACKBOX takes
    effect within one process."""
    global _inst, _inst_pid
    with _inst_lock:
        if _inst is not None:
            _inst.close()
        _inst = None
        _inst_pid = None


# ---- reader ----------------------------------------------------------------


def read_dump(path: str) -> List[dict]:
    """Reconstruct the event list from a ring file — typically a DEAD
    process' (no locking; a live writer costs at most one torn record
    at the seam).  Oldest first; torn/partial lines are dropped."""
    with open(path, "rb") as f:
        hdr = f.read(HEADER)
        if len(hdr) < HEADER or hdr[:8] != MAGIC:
            raise ValueError(f"{path}: not a ccsx black-box file")
        capacity = struct.unpack_from("<Q", hdr, _CAP_OFF)[0]
        head = struct.unpack_from("<Q", hdr, _HEAD_OFF)[0]
        data = f.read(capacity)
    if capacity <= 0 or len(data) < capacity:
        raise ValueError(f"{path}: truncated black-box file")
    if head <= capacity:
        # never lapped: bytes [0, head) are the whole story.  The
        # boundary matters — at head == capacity exactly, head %
        # capacity is 0 and a wrap-based slice would return nothing
        wrapped = False
        buf = data[:head]
    else:
        wrapped = True
        pos = head % capacity
        buf = data[pos:] + data[:pos]
    lines = buf.split(b"\n")
    if wrapped and lines:
        lines = lines[1:]     # the lap seam tears the oldest record
    out = []
    for ln in lines:
        ln = ln.strip(b"\0").strip()
        if not ln:
            continue
        try:
            out.append(json.loads(ln.decode("utf-8", "replace")))
        except ValueError:
            continue
    return out


def inflight(events: List[dict]) -> List[dict]:
    """The records naming UNFINISHED work at the moment of death:
    'inflight' notes (job/range claims) without a matching 'done' note,
    and span-begin mirrors without their close.  This is what the
    reaper and `ccsx-tpu blackbox` headline."""
    open_notes = {}
    open_spans = {}
    for ev in events:
        kind = ev.get("bb")
        if kind == "inflight":
            open_notes[(ev.get("what"), ev.get("id"))] = ev
        elif kind == "done":
            open_notes.pop((ev.get("what"), ev.get("id")), None)
        elif ev.get("ev") == "begin":
            open_spans[(ev.get("tid"), ev.get("name"))] = ev
        elif ev.get("ev") == "span":
            open_spans.pop((ev.get("tid"), ev.get("name")), None)
    return list(open_notes.values()) + list(open_spans.values())


def render(path: str, out=None, tail: int = 40) -> int:
    """Human rendering of one dump: headline the in-flight work, then
    the last `tail` events."""
    out = out or sys.stdout
    try:
        events = read_dump(path)
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"== black box {path}: {len(events)} event(s) recovered ==",
          file=out)
    live = inflight(events)
    if live:
        print(f"-- in-flight at death ({len(live)}) --", file=out)
        for ev in live:
            print("  " + json.dumps(ev, sort_keys=True), file=out)
    else:
        print("-- nothing in flight --", file=out)
    print(f"-- last {min(tail, len(events))} event(s) --", file=out)
    for ev in events[-tail:]:
        print("  " + json.dumps(ev, sort_keys=True), file=out)
    return 0


def blackbox_main(argv) -> int:
    """`ccsx-tpu blackbox <path|dir>...`: render ring dumps.  A
    directory argument expands to every blackbox.*.bin inside it."""
    import argparse
    import glob as globmod

    p = argparse.ArgumentParser(prog="ccsx-tpu-torch blackbox")
    p.add_argument("paths", nargs="+",
                   help="ring file(s) or dir(s) holding blackbox.*.bin")
    p.add_argument("--tail", type=int, default=40,
                   help="events of tail to print per dump [40]")
    args = p.parse_args(argv)
    paths = []
    for a in args.paths:
        if os.path.isdir(a):
            paths.extend(sorted(
                globmod.glob(os.path.join(a, "blackbox.*.bin"))))
        else:
            paths.append(a)
    if not paths:
        print("Error: no black-box files found", file=sys.stderr)
        return 1
    rc = 0
    for path in paths:
        rc = max(rc, render(path, tail=args.tail))
    return rc
