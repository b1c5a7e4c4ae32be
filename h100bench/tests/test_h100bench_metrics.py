"""The readers and the roofline work counts."""

import json
import os
import shutil

import numpy as np
import pytest

from h100bench.gen import corpus
from h100bench.gen.holes import FULL, PARTIAL, READ_THROUGH
from h100bench.harness import spec, trace, work

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def manifest(*holes):
    lens = [np.array(h[0], np.int32) for h in holes]
    kinds = [np.array(h[1], np.int8) for h in holes]
    offs = np.zeros(len(holes) + 1, np.int64)
    np.cumsum([len(x) for x in lens], out=offs[1:])
    return corpus.Manifest(np.concatenate(lens), np.concatenate(kinds), offs,
                           np.array([h[2] for h in holes], np.int32))


def test_counts_of_a_plain_hole_by_hand():
    # partials are out of the template group and end the walk's sides:
    # the consensus keeps the three full passes, no pair is checked
    m = manifest(([500, 1000, 1010, 990, 400],
                  [PARTIAL, FULL, FULL, FULL, PARTIAL], 1000))
    c = work.counts(m, [0], refine_iters=2, max_passes=32)
    rows = (1000 + 1010 + 990) * 3
    cols = 3 * 1000 * 3
    assert c["global_fill"] == (rows * 128 * 14, rows * 133 + cols)
    assert c["traceback_walk"] == ((rows + cols) * 6,
                                   rows * 133 + cols * 9)
    assert c["local_fill"] == (0, 0)


def test_counts_of_a_read_through_by_hand():
    # the read-through is out of group and longer than the template: it is
    # checked (2000 rows) and kept clipped to one traversal; the next pass
    # is doubtful and checked too (1000 rows), then trusted again
    m = manifest(([1000, 1000, 2000, 1000, 1000],
                  [FULL, FULL, READ_THROUGH, FULL, FULL], 1000))
    kept, checks = work.kept_and_checked(*m.passes(0), max_passes=32)
    assert sorted(kept) == [1000] * 5 and checks == [2000, 1000]
    c = work.counts(m, [0, 0], refine_iters=1, max_passes=3)
    assert c["local_fill"] == (2 * 3000 * 128 * 27,
                               2 * ((2000 + 1000 + 44) + (1000 + 1000 + 44)))
    assert c["global_fill"][0] == 2 * 3000 * 2 * 128 * 14


def test_least_time_names_its_bound():
    t, by = work.least_seconds(work.PEAK_INT32_OPS, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = work.least_seconds(1.0, work.PEAK_BYTES * 2)
    assert by == "bytes" and t == pytest.approx(2.0)


def test_idle_share_on_a_synthetic_timeline():
    ops = [(0.5, 1.0), (0.8, 1.5), (2.0, 2.5), (3.9, 5.0), (-1.0, 0.2)]
    busy, gaps = trace.busy_and_gaps(ops, 0.0, 4.0)
    assert busy == pytest.approx(0.2 + 1.0 + 0.5 + 0.1)
    assert gaps == [(0.2, 0.5), (1.5, 2.0), (2.5, 3.9)]
    samples = [(0.3, "a"), (1.6, "b"), (1.9, "b"), (3.0, "c"), (3.1, "a")]
    named = trace.name_gaps(gaps, samples)
    assert named == pytest.approx({"a": 0.3 + 0.7, "b": 0.5, "c": 0.7})


def test_kernel_names():
    assert trace.short_name("(anonymous namespace)::local_fill_kernel<false>"
                            "(unsigned char const*, int)") == \
        "local_fill_kernel<false>"
    assert trace.base_name("local_fill_kernel<false>") == "local_fill_kernel"
    assert trace.short_name("void at::native::k<at::f(int)::{lambda()#1}>"
                            "(int, float)") == "at::native::k<at::f(int)::" \
        "{lambda()#1}>"


def test_the_profilers_results_and_its_trace_file_agree(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = torch.ones(1000)
        for _ in range(5):
            (x + 1).sum()
    cats = ("cpu_op",)
    a = sorted(trace.results_ops(prof, cats), key=lambda o: o[1])
    b = sorted(trace.file_ops(prof, str(tmp_path / "t" / "trace.json"),
                              cats), key=lambda o: o[1])
    assert len(a) == len(b) > 5
    for (na, sa, da), (nb, sb, db) in zip(a, b):
        assert na == nb and abs(da - db) < 2
        assert abs((sa - a[0][1]) - (sb - b[0][1])) < 2


def test_events_that_do_not_name_their_kind_are_read_by_device(tmp_path):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (torch.ones(1000) + 1).sum()

    class Unnamed:
        """An event of a torch whose events have no ``activity_type``."""

        def __init__(self, e):
            self.name, self.device_type = e.name, e.device_type
            self.start_ns, self.duration_ns = e.start_ns, e.duration_ns

    class Older:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [Unnamed(e) for e in
                            prof.profiler.kineto_results.events()]

    ops = trace.results_ops(Older, ("cpu_op",), DeviceType.CPU)
    assert ops == trace.results_ops(prof, ("cpu_op",)) and len(ops) > 3
    assert trace.results_ops(Older, ("cpu_op",), DeviceType.CUDA) is None


def test_results_without_the_marker_fall_back_to_the_trace_file(tmp_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        (torch.ones(1000) + 1).sum()
    path = tmp_path / "t" / "trace.json"
    assert trace.device_ops(prof, str(path)) == ([], "file")
    assert path.exists()


def test_analyse_reads_the_window_from_the_marker():
    t = trace.DeviceTrace("unused")
    t._marker_host = 100.0
    # the marker at 7 s on the profiler's clock, then two kernels and a copy
    t.ops = [("void k<int>(int*)", 8e9, 0.5e9), ("marker", 7e9, 1e3),
             ("k<int>", 9e9, 1e9), ("Memcpy DtoH", 9.5e9, 0.25e9)]
    r = t.analyse(101.25, 103.0)
    assert r["busy_s"] == pytest.approx(0.25 + 1.0)
    assert r["kernel_s"] == pytest.approx({"k<int>": 1.25,
                                           "Memcpy DtoH": 0.25})


def test_every_named_metric_has_its_reader():
    bench = spec.load_bench()
    names = [m["name"] for m in bench["per_layer"]]
    assert set(names) <= set(spec.available_metrics())
    for m in bench["per_layer"]:
        mod = spec.reader(m["name"])
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
        assert mod.UNIT == m["unit"]


def test_a_dropped_in_metric_traffic_and_cell_are_found(tmp_path):
    root = tmp_path / "root"
    shutil.copytree(BENCH, root / "h100bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = spec.load_bench()
    (root / "h100bench" / "metrics" / "holes_written.py").write_text(
        'LAYER = "batched driver and packer"\n'
        'MOVES = "subread_bases_per_s"\nUNIT = "holes"\n\n\n'
        'def read(obs):\n    return obs.metrics.holes_out or None\n')
    (root / "h100bench" / "traffic" / "ins12k.json").write_text(
        (root / "h100bench" / "traffic" / "ins15k.json").read_text())
    bench["per_layer"].append(
        {"name": "holes_written", "unit": "holes", "better": "higher",
         "source": "program_counter", "layer": "batched driver and packer",
         "moves": "subread_bases_per_s"})
    bench["workloads"].append(
        {"name": "hifi_wgs.ins12k", "config": "hifi_wgs", "traffic": "ins12k",
         "chips": 1, "why": "a cell added by files and entries alone"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.cell("hifi_wgs.ins12k", str(root))
    assert c.mix == spec.cell("hifi_wgs.ins15k", str(root)).mix
    for name in ("hifi_wgs.ins12k", "hifi_wgs.ins15k"):
        assert "holes_written" in [
            m["name"] for m in spec.cell(name, str(root)).per_layer]
    bd = str(root / "h100bench")
    assert "holes_written" in spec.available_metrics(bd)

    class Obs:
        class metrics:
            holes_out = 7

    assert spec.reader("holes_written", bd).read(Obs) == 7
