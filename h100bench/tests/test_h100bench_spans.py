"""The idle-gap split by the program's spans (harness/spans.py) and the
four span readers (metrics/_spans.py), on hand-built spans."""

import collections
import types

import pytest

from h100bench.harness import spans as spans_mod
from h100bench.harness import spec

Rec = collections.namedtuple("Rec",
                             "name cat thread start end self_s cpu_s")
DRIVER, WORKER = 1, 2
OUT = spans_mod.OUTSIDE


def rec(name, start, end, thread=DRIVER, self_s=None, cpu_s=0.0):
    return Rec(name, "compute", thread, start, end,
               end - start if self_s is None else self_s, cpu_s)


# a sweep [10, 20] holding a pack [11, 12], a launch [12, 13] and a step
# [15, 19]; an emit [21, 22]; a worker's span over everything, which the
# driver's split never sees
RECORDS = [rec("slab_pack", 11, 12), rec("refine_packed", 12, 13),
           rec("hole_step", 15, 19), rec("refine_sweep", 10, 20),
           rec("emit", 21, 22), rec("prep_hole", 0, 30, thread=WORKER)]


def test_nested_spans_name_each_instant_by_the_innermost():
    segs = spans_mod.innermost(RECORDS, DRIVER)
    assert segs == [(10, 11, "refine_sweep"), (11, 12, "slab_pack"),
                    (12, 13, "refine_packed"), (13, 15, "refine_sweep"),
                    (15, 19, "hole_step"), (19, 20, "refine_sweep"),
                    (20, 21, OUT), (21, 22, "emit")]


@pytest.mark.parametrize("gaps,want", [
    # inside one span, and across the boundary of a nested one
    ([(15.5, 16.5)], {"hole_step": 1.0}),
    ([(12.5, 14.0)], {"refine_packed": 0.5, "refine_sweep": 1.0}),
    # outside any span: before the first, between two, after the last
    ([(5.0, 10.5)], {OUT: 5.0, "refine_sweep": 0.5}),
    ([(19.5, 21.5)], {"refine_sweep": 0.5, OUT: 1.0, "emit": 0.5}),
    ([(21.5, 25.0)], {"emit": 0.5, OUT: 3.0}),
    # several gaps, unsorted, summed by name
    ([(18.0, 19.0), (11.0, 11.5), (15.0, 16.0)],
     {"hole_step": 2.0, "slab_pack": 0.5}),
])
def test_gaps_split_by_span(gaps, want):
    got = spans_mod.split(gaps, RECORDS, DRIVER)
    assert got == pytest.approx(want)
    assert sum(got.values()) == pytest.approx(sum(b - a for a, b in gaps))


def test_no_spans_books_every_gap_outside():
    assert spans_mod.split([(1.0, 2.0), (3.0, 3.5)], [], DRIVER) == \
        pytest.approx({OUT: 1.5})


def test_device_gaps_map_the_marker_clock():
    t = types.SimpleNamespace(_marker_host=100.0, ops=[
        ("marker", 7e9, 1e3), ("k", 8e9, 0.5e9), ("k", 9e9, 1e9)])
    # on the host's clock the kernels run [101, 101.5] and [102, 103]
    assert spans_mod.device_gaps(t, 100.5, 104.0) == \
        pytest.approx([(100.5, 101.0), (101.5, 102.0), (103.0, 104.0)])


def obs(records, window_s=10.0, end=50.0, thread=DRIVER):
    cap = types.SimpleNamespace(records=records, thread=thread, start=0.0,
                                end=end)
    return types.SimpleNamespace(window_s=window_s,
                                 metrics=types.SimpleNamespace(capture=cap))


WINDOW = [
    # before the window (it opens at 40): left out
    rec("hole_step", 35.0, 39.0),
    rec("refine_sweep", 41.0, 46.0, self_s=0.5),
    rec("plan", 41.0, 41.5, cpu_s=0.4),
    rec("slab_pack", 41.5, 41.7, cpu_s=0.2),
    rec("refine_packed", 41.7, 41.8),
    rec("slab_pack", 41.8, 42.0, cpu_s=0.2),
    rec("refine_packed", 42.0, 42.1),
    rec("materialize", 42.1, 43.1),
    rec("unpack", 43.1, 43.3, cpu_s=0.2),
    rec("materialize", 43.3, 43.8),
    rec("unpack", 43.8, 44.0, cpu_s=0.2),
    rec("hole_step", 44.0, 46.0, cpu_s=1.5),
    rec("emit", 47.0, 48.0, self_s=0.5, cpu_s=0.5),
    rec("write_record", 47.2, 47.7, cpu_s=0.2),
    # another thread's: left out
    rec("hole_step", 41.0, 49.0, thread=WORKER),
    rec("materialize", 41.0, 49.0, thread=WORKER),
]


@pytest.mark.parametrize("name,want", [
    ("hole_step_share", 100.0 * 2.0 / 10.0),
    ("dispatch_host_ms", 1000.0 * (0.2 + 0.1 + 0.2 + 0.1 + 0.2 + 0.2) / 2),
    ("readback_wait_share", 100.0 * 1.5 / 10.0),
    # wall 0.5 + 0.2 + 0.2 + 0.2 + 0.2 + 2.0 + 1.0 = 4.3 s, CPU 3.2 s
    ("driver_offcpu_share", 100.0 * (1.0 - 3.2 / 4.3)),
])
def test_span_readers_on_a_hand_built_window(name, want):
    assert spec.reader(name).read(obs(WINDOW)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["hole_step_share", "dispatch_host_ms",
                                  "readback_wait_share",
                                  "driver_offcpu_share"])
def test_span_readers_read_none_without_a_capture(name):
    mod = spec.reader(name)
    no_capture = types.SimpleNamespace(
        window_s=10.0, metrics=types.SimpleNamespace(holes_out=3))
    assert mod.read(no_capture) is None
    assert mod.read(obs(WINDOW, window_s=0.0)) is None
    open_cap = obs(WINDOW)
    open_cap.metrics.capture.end = None
    assert mod.read(open_cap) is None
    empty = mod.read(obs([]))
    assert empty is None or empty == 0.0
    # a span with no thread-CPU reading (not on the capture's thread)
    unclocked = mod.read(obs([rec("plan", 45.0, 46.0, cpu_s=None)]))
    assert unclocked is None or unclocked == 0.0
