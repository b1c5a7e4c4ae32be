"""This process's use of the host's CPUs over the window, for a run's
earlier lines: a cell whose program is host-bound reads the host's speed as
much as its own, and the CPU seconds the process took a second of window,
beside the prep workers the program ran, show how much of the host it held.
"""

from __future__ import annotations

import os
import resource
import time


class HostClock:
    def start(self):
        self.t0 = time.perf_counter()
        self.r0 = resource.getrusage(resource.RUSAGE_SELF)

    def stop(self, prep_workers=None) -> str:
        wall = time.perf_counter() - self.t0
        r1 = resource.getrusage(resource.RUSAGE_SELF)
        cpu = (r1.ru_utime - self.r0.ru_utime) + (r1.ru_stime
                                                  - self.r0.ru_stime)
        return (f"host over the window: this process "
                f"{cpu / wall if wall else 0.0:.3f} of {os.cpu_count()} "
                f"CPUs, prep workers {prep_workers}")
