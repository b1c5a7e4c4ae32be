"""One run of one cell: set-up, the timed window, the check, the result line.

Set-up makes (or reuses) the cell's corpus, timed apart as the harness's
cost; loads the port's kernels; runs a warm lap of ``warm_holes`` holes
through the same entry so the cell's refine programs exist before the
window.  The window drives ``ccsx_tpu_torch.pipeline.run.run_pipeline`` on
the corpus BAM with the configuration's CLI flags, as a user's run would,
through ``open_io``: the program's own reader and writer, behind the
admission deadline (window.py).  After it the program's programs and pools
are dropped, and the reference checks the records (check.py).

Standard output's last line is the result: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` the ``breakdown``,
and last the numbers compared with their limits (``checks``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Dict, Optional

from h100bench.harness import spec
from h100bench.harness.window import Window, read_fasta

FORBIDDEN = ("jax", "jaxlib", "flax", "ccsx_tpu")
WORK_DIR = os.path.join(spec.ROOT, "build", "h100bench")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[h100bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Observed:
    """What a per-layer metric's reader reads (metrics/*.py)."""

    window_s: float
    metrics: object               # the window's RunMetrics
    graph_stats: Dict[str, dict]  # pipeline/graphs.stats() of the window
    trace: Optional[dict]         # DeviceTrace.analyse() of the window
    peak_bytes: int
    manifest: object
    emitted: list                 # corpus index of each hole with a record
    cfg: object                   # the program's CcsConfig


def parse(argv):
    p = argparse.ArgumentParser(prog="h100bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _limited(stream, n: int):
    try:
        for k, z in enumerate(stream):
            if k >= n:
                return
            yield z
    finally:
        close = getattr(stream, "close", None)
        if close is not None:
            close()


def main(argv=None, t_start: Optional[float] = None) -> int:
    if t_start is None:
        t_start = time.perf_counter() - process_age_s()
    args = parse(argv)
    cell = spec.cell(args.workload)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(WORK_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(WORK_DIR, "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"no CUDA device for {args.workload}: available="
            f"{torch.cuda.is_available()}, devices="
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f", cell asks for {cell.chips}")
        return 3

    from h100bench.gen import corpus

    mix, config = cell.mix, cell.config
    cdir = os.path.join(WORK_DIR, "corpus", cell.name)
    bam, manifest, gen_s, reused = corpus.build(
        cdir, args.seed, int(mix["pool_holes"]), mix, config["errors"],
        config["movie"])
    print(f"[h100bench] corpus {cell.name} seed {args.seed}: "
          f"{manifest.n_holes} holes, {int(manifest.hole_bases.sum())} "
          f"subread bases, {'reused' if reused else 'made'} in "
          f"{gen_s:.3f} s (not set-up)", flush=True)
    r = run_cell(cell, args, bam, manifest, t_start, gen_s)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in this process: {bad}")
        return 4
    for name, c in r["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(r), flush=True)
    return 0


def run_cell(cell, args, bam, manifest, t_start, gen_s,
             device: str = "cuda", extra_flags=(),
             work_dir: str = WORK_DIR) -> dict:
    """The run after the corpus: ``device`` "cpu" (with ``extra_flags``
    such as ``--batch on``) drives the same window and check on the host,
    for the harness's own tests; its numbers are no device's."""
    import torch

    from ccsx_tpu_torch import cli
    from ccsx_tpu_torch.ops import cuda_ext
    from ccsx_tpu_torch.pipeline import graphs, run
    from ccsx_tpu_torch.utils.run_metrics import RunMetrics
    from h100bench.harness import check as check_mod
    from h100bench.harness.host import HostClock
    from h100bench.harness.trace import DeviceTrace

    mix, config = cell.mix, cell.config
    out_dir = os.path.join(work_dir, "out", cell.name)
    os.makedirs(out_dir, exist_ok=True)
    warm_out = os.path.join(out_dir, "warm.fa")
    out = os.path.join(out_dir, "window.fa")
    on_card = device == "cuda"
    cargs = cli.build_parser().parse_args(
        [bam, out, *config["flags"], "--device", device, *extra_flags])
    cfg = cli.config_from_args(cargs)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    if on_card:
        cuda_ext.load_all()

    # the warm lap: every refine program of the cell's shapes built
    def warm_io(m):
        opened = run.open_run_io(bam, warm_out, cfg, m, None)
        if opened is None:
            return None
        stream, journal, writer = opened
        return _limited(stream, int(mix["warm_holes"])), journal, writer

    rc = run.run_pipeline(bam, warm_out, cfg, batch=cargs.batch,
                          inflight=cargs.inflight, open_io=warm_io,
                          metrics=RunMetrics())
    if rc != 0:
        raise RuntimeError(f"the warm lap ended with rc {rc}")
    sync()

    metrics = RunMetrics()
    win = Window(args.seconds, manifest.n_holes,
                 reopen=lambda: run.open_zmw_stream(bam, cfg, metrics))

    def window_io(m):
        opened = run.open_run_io(bam, out, cfg, m, None)
        if opened is None:
            return None
        stream, journal, writer = opened
        return win.stream(stream), journal, writer

    devices = range(cell.chips) if on_card else ()
    for d in devices:
        torch.cuda.reset_peak_memory_stats(d)
    graphs.reset_stats()
    host = HostClock()
    host.start()
    tracer = None
    if args.trace:
        tracer = DeviceTrace(os.path.join(work_dir, "trace",
                                          cell.name + ".json"))
        tracer.start()
    rc = run.run_pipeline(bam, out, cfg, batch=cargs.batch,
                          inflight=cargs.inflight, open_io=window_io,
                          metrics=metrics)
    sync()
    t_end = time.perf_counter()
    host_line = host.stop(getattr(metrics, "prep_threads", None))
    if tracer is not None:
        tracer.stop()
    t_open = win.t_open if win.t_open is not None else t_end
    window_s = t_end - t_open
    setup_s = t_open - t_start - gen_s
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
               default=0)
    gstats = graphs.stats()
    graphs.clear()
    gc.collect()

    records = read_fasta(out)
    written = {n.split("/")[1] for n, _ in records if n.count("/") == 2}
    emitted = [i for h, i in win.admitted if h in written]
    attempted = len(win.admitted)
    bases = int(manifest.hole_bases[emitted].sum()) if emitted else 0
    print(f"[h100bench] window {window_s:.3f} s: {attempted} holes handed "
          f"over in {win.laps + 1} lap(s) of the corpus, {len(emitted)} "
          f"records, rc {rc}", flush=True)
    print(f"[h100bench] {host_line}", flush=True)

    trace_rec = None
    if tracer is not None:
        trace_rec = tracer.analyse(t_open, t_end)
        print(f"[h100bench] trace: {len(tracer.ops)} device operations "
              f"from the profiler's {tracer.source}, read by "
              f"{time.perf_counter() - t_end:.3f} s after the window",
              flush=True)
    obs = Observed(window_s=window_s, metrics=metrics, graph_stats=gstats,
                   trace=trace_rec, peak_bytes=peak, manifest=manifest,
                   emitted=emitted, cfg=cfg)
    if args.trace:
        values = {}
        for m in cell.per_layer:
            v = spec.reader(m["name"]).read(obs)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"subread_bases_per_s": bases / window_s if window_s else 0.0,
               "setup_s": setup_s}
        values = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                  for m in cell.end_to_end}

    res = check_mod.check(records, win.admitted, manifest, args.seed, mix,
                          config, device=device)
    log(f"reference: {res['checked']} holes checked in "
        f"{res['reference_s']:.3f} s")
    numbers = res["numbers"]
    correct = (rc == 0 and attempted > 0 and bool(emitted)
               and check_mod.verdict(numbers))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": attempted - len(emitted), "metrics": values,
              "device": dev}
    if trace_rec is not None:
        dev["busy_s"] = trace_rec["busy_s"]
        dev["window_s"] = trace_rec["window_s"]
        top = sorted(trace_rec["kernel_s"].items(), key=lambda kv: -kv[1])
        gaps = sorted(trace_rec["idle"].items(), key=lambda kv: -kv[1])
        result["breakdown"] = {"device_ops": [list(x) for x in top[:10]],
                               "idle_gaps": [list(x) for x in gaps[:10]]}
    result["checks"] = {k: {"value": v, "limit": check_mod.LIMITS[k]}
                        for k, v in numbers.items()}
    return result
