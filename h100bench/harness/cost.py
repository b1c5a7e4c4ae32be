"""What recording costs a window, by hand: the port's in-memory span
capture (``ccsx_tpu_torch/utils/capture.py``, opened here through its
Python API) and the traced run's profiler (harness/trace.py's
``DeviceTrace``, under which the port opens its own capture)::

    python3 -m h100bench.harness.cost --workload <cell> --seed <n> \\
        --seconds 51 --modes off,capture,capture,off,profiler,capture

One process on the card: the cell's corpus, kernels and warm lap once,
then one window a mode, in the order given, each driven and timed as the
benchmark's (harness/cell.py: the CLI flags of the configuration, the
admission deadline, bases of the holes written over the window's
seconds); no reference check.  ``off`` records nothing; ``capture`` keeps
every span in memory; ``profiler`` is the traced window, whose profiler
results are collected after it (``stop_s``).  One JSON line a window:
mode, window seconds, subread bases per second, spans kept.  Before
them, one line of what a span costs the host alone (``span_us``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def span_us(n: int = 100_000) -> dict:
    """Host microseconds of one packed dispatch's pair of spans (a plain
    span, then a device span) with no capture open and with one, the
    least of two rounds each."""
    from ccsx_tpu_torch.utils import capture, trace

    tr = trace.Tracer(None, stall_timeout=0)
    out: dict = {}
    for mode in ("off", "capture", "off", "capture"):
        cap = capture.Capture().open() if mode == "capture" else None
        t0 = time.perf_counter()
        for _ in range(n):
            with tr.span("slab_pack", cat="compute"):
                pass
            with tr.device_span("refine_packed", group="g"):
                pass
        us = (time.perf_counter() - t0) / n * 1e6
        if cap is not None:
            cap.close()
        out[mode] = min(out.get(mode, us), us)
    tr.close()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="h100bench.harness.cost")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--modes", default="off,capture,capture,off")
    args = p.parse_args(argv)
    modes = args.modes.split(",")
    if set(modes) - {"off", "capture", "profiler"}:
        p.error(f"unknown mode in {args.modes!r}")

    from h100bench.harness import cell as cell_mod
    from h100bench.harness import spec

    c = spec.cell(args.workload)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(
        cell_mod.WORK_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(cell_mod.WORK_DIR, "triton"))
    import torch

    if not torch.cuda.is_available():
        cell_mod.log("no CUDA device")
        return 3
    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import cuda_ext
    from ccsx_tpu_torch.pipeline import run
    from ccsx_tpu_torch.utils import capture
    from ccsx_tpu_torch.utils.run_metrics import RunMetrics
    from h100bench.gen import corpus
    from h100bench.harness.trace import DeviceTrace
    from h100bench.harness.window import Window, read_fasta

    bam, manifest, _, _ = corpus.build(
        os.path.join(cell_mod.WORK_DIR, "corpus", c.name), args.seed,
        int(c.mix["pool_holes"]), c.mix, c.config["errors"],
        c.config["movie"])
    out_dir = os.path.join(cell_mod.WORK_DIR, "out", c.name)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "cost.fa")
    cargs = cli.build_parser().parse_args(
        [bam, out, *c.config["flags"], "--device", "cuda"])
    cfg = cli.config_from_args(cargs)
    cuda_ext.load_all()
    print(json.dumps({"span_pair_us": span_us()}), flush=True)

    def warm_io(m):
        stream, journal, writer = run.open_run_io(bam, out, cfg, m, None)
        return (cell_mod._limited(stream, int(c.mix["warm_holes"])),
                journal, writer)

    assert run.run_pipeline(bam, out, cfg, batch=cargs.batch,
                            inflight=cargs.inflight, open_io=warm_io,
                            metrics=RunMetrics()) == 0
    torch.cuda.synchronize()
    for k, mode in enumerate(modes):
        metrics = RunMetrics()
        win = Window(args.seconds, manifest.n_holes,
                     reopen=lambda: run.open_zmw_stream(bam, cfg, metrics))

        def window_io(m):
            stream, journal, writer = run.open_run_io(bam, out, cfg, m,
                                                      None)
            return win.stream(stream), journal, writer

        prof = cap = None
        if mode == "profiler":
            prof = DeviceTrace(os.path.join(cell_mod.WORK_DIR, "trace",
                                            f"{c.name}.cost.json"))
            prof.start()
        elif mode == "capture":
            cap = capture.Capture().open()
        rc = run.run_pipeline(bam, out, cfg, batch=cargs.batch,
                              inflight=cargs.inflight, open_io=window_io,
                              metrics=metrics)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        stop_s = None
        if cap is not None:
            cap.close()
        if prof is not None:
            prof.stop()
            stop_s = time.perf_counter() - t_end
            cap = metrics.capture
        window_s = t_end - win.t_open
        written = {n.split("/")[1] for n, _ in read_fasta(out)
                   if n.count("/") == 2}
        emitted = [i for h, i in win.admitted if h in written]
        bases = int(manifest.hole_bases[emitted].sum()) if emitted else 0
        print(json.dumps({
            "window": k, "mode": mode, "rc": rc, "window_s": window_s,
            "subread_bases_per_s": bases / window_s,
            "spans": len(cap.records) if cap is not None else 0,
            "stop_s": stop_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
