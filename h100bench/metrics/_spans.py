"""The driver thread's spans of a traced window, for the span readers.

While torch.profiler records (the traced window), the port's
``run_pipeline`` keeps its spans in memory (``ccsx_tpu_torch/utils/
capture.py``) and leaves the capture on the window's ``RunMetrics`` as
``capture``: records of name, category, thread, start and end on the
host's ``perf_counter`` clock, self seconds and thread-CPU seconds.  A
program without it leaves no capture, and every span reader reads None.
"""

from __future__ import annotations


def driver_spans(obs):
    """The records of the thread that called ``run_pipeline`` (the batched
    driver's) that started in the window's last ``window_s`` seconds
    before the capture closed; None where the run kept no capture."""
    cap = getattr(obs.metrics, "capture", None)
    if cap is None or cap.end is None or not obs.window_s:
        return None
    lo = cap.end - obs.window_s
    return [r for r in cap.records if r.thread == cap.thread
            and r.start >= lo]


def self_s(records, *names) -> float:
    return sum(r.self_s for r in records if r.name in names)
