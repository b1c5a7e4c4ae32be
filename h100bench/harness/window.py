"""The timed window: admission under a deadline, over the corpus stream.

``Window.stream`` wraps the program's own ZMW stream (the native reader the
run opened on the corpus BAM).  The window opens at the first hole the
program takes from it; once ``seconds`` have passed, the next request finds
the stream ended, so admission stops and the holes in flight drain.  The
window closes when ``run_pipeline`` returns.  If the corpus runs dry first,
the stream opens it again (a lap) and hands its holes over under new hole
numbers (``index + lap * pool_holes``), so the window never runs short.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, List, Optional, Tuple


class Window:
    def __init__(self, seconds: float, pool_holes: int,
                 reopen: Callable[[], Iterator],
                 clock: Callable[[], float] = time.perf_counter):
        self.seconds = seconds
        self.pool_holes = pool_holes
        self.reopen = reopen
        self.clock = clock
        self.t_open: Optional[float] = None
        self.laps = 0
        # (hole name as handed over, corpus index), in admission order
        self.admitted: List[Tuple[str, int]] = []

    def stream(self, inner: Iterator):
        inner = iter(inner)
        try:
            while True:
                now = self.clock()
                if self.t_open is None:
                    self.t_open = now
                elif now - self.t_open >= self.seconds:
                    return
                try:
                    z = next(inner)
                except StopIteration:
                    close = getattr(inner, "close", None)
                    if close is not None:
                        close()
                    self.laps += 1
                    inner = iter(self.reopen())
                    try:
                        z = next(inner)
                    except StopIteration:
                        return
                index = int(z.hole)
                if self.laps:
                    z = dataclasses.replace(
                        z, hole=str(index + self.laps * self.pool_holes))
                self.admitted.append((z.hole, index))
                yield z
        finally:
            close = getattr(inner, "close", None)
            if close is not None:
                close()


def read_fasta(path: str) -> List[Tuple[str, str]]:
    """(name, sequence) of each record, in file order."""
    out = []
    name, seq = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(seq)))
                name, seq = line[1:], []
            else:
                seq.append(line)
    if name is not None:
        out.append((name, "".join(seq)))
    return out


def order_faults(admitted: List[str], records: List[str]) -> int:
    """Records that break the guarantee of one record per admitted hole in
    admission order: a name of no admitted hole, a second record of a hole,
    or a record behind one of a later hole."""
    rank = {h: k for k, h in enumerate(admitted)}
    faults = 0
    last = -1
    seen = set()
    for h in records:
        k = rank.get(h)
        if k is None or h in seen:
            faults += 1
            continue
        seen.add(h)
        if k < last:
            faults += 1
        last = max(last, k)
    return faults
