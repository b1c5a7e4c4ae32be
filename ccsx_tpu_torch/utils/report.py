"""`ccsx-tpu-torch report`: a self-contained static HTML run report (a
copy of the JAX package's utils/report.py; the port's trace and metrics
JSONL keep the JAX schema, so the same page comes out of either).

A run's JSONL artifacts (``--trace`` spans, ``--metrics`` events)
render one human-readable page next to them — the
artifact an operator actually opens before JSONL archaeology:

* run header + health banner (degraded mark, stalls, fallbacks);
* a timeline strip of the trace spans (one lane per thread, colored by
  span category, compile calls hatched out by a marker) — the
  Chrome-export view without needing Perfetto;
* the per-shape-group compile/execute table and the per-category stage
  self-time breakdown (both re-derived through utils/trace.summarize,
  the SAME finalizer the stats subcommand and metrics events use);
* occupancy / fill stat tiles;
* the stall + recovery incident log;
* the ETA-vs-actual curve from the progress estimator's periodic
  events, with a median-error recap (how trustworthy was the live ETA).

Self-contained: inline CSS, inline SVG, zero JS, zero external fetches
— the file can be committed, mailed, or served from a dumb bucket.
Light and dark mode both render from the palette below (selected steps,
not an automatic flip).  No torch or jax import — safe on a host
whose card is hung (same discipline as `stats`).

Streaming bounds: span rectangles are capped to the MAX_TIMELINE
longest (a million-hole trace renders the load-bearing spans, with the
drop counted in the caption — no silent truncation), incidents to
MAX_INCIDENTS, and the second pass reuses summarize()'s own streaming
discipline.
"""

from __future__ import annotations

import heapq
import html
import json
import os
import sys
from typing import List, Optional

from ccsx_tpu_torch.utils import trace as trace_mod

MAX_TIMELINE = 4000     # span rects kept (longest win); rest counted
MAX_INCIDENTS = 300
MAX_LANES = 16          # timeline thread lanes

# span categories in fixed categorical-slot order (identity colors are
# assigned by this order, never cycled — the palette below validates
# adjacency in this order in both modes)
CAT_ORDER = ("device", "compute", "ingest", "prep", "write", "journal",
             "host", "recover")
# categorical slots 1..8 (light, dark) — validated reference palette
_SLOTS = (("#2a78d6", "#3987e5"), ("#eb6834", "#d95926"),
          ("#1baf7a", "#199e70"), ("#eda100", "#c98500"),
          ("#e87ba4", "#d55181"), ("#008300", "#008300"),
          ("#4a3aa7", "#9085e9"), ("#e34948", "#e66767"))

# snapshot keys the occupancy/fill tiles render (schema-drift guard:
# tests cross-check these against Metrics.snapshot())
REPORT_TILE_KEYS = (
    "zmws_per_sec", "dp_occupancy", "dp_row_fill",
    "packed_holes_per_dispatch", "fused_slot_fill", "compile_share",
    "prep_share", "prep_overlap_share",
    "distinct_slab_shapes", "holes_filtered",
)
# final-event counters the header table renders (device_hangs /
# breaker_* are the resilient-execution story: abandoned dispatches and
# the circuit breaker's verdict ride every run report)
REPORT_HEADER_KEYS = (
    "holes_in", "holes_out", "holes_failed", "holes_filtered",
    "holes_corrupt",
    "windows", "device_dispatches", "oom_resplits", "host_fallbacks",
    "device_hangs", "breaker_trips", "breaker_state",
    "stalls", "elapsed_s", "ingest_bytes",
)


def collect(paths: List[str]) -> dict:
    """One streaming pass over mixed trace/metrics JSONL: bounded span
    set for the timeline, progress-event series for the ETA curve,
    incident log, and the last/final metrics snapshot."""
    spans_heap: list = []    # min-heap of (dur, seq, lite-span)
    seq = 0
    n_spans = 0
    t_end = 0.0
    progress: list = []      # (elapsed_s, eta_s, pct, done)
    incidents: list = []
    meta = None
    final = None
    last_metrics = None
    for path in paths:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                ev = rec.get("ev")
                if ev == "meta":
                    meta = rec
                elif ev == "span":
                    n_spans += 1
                    t_end = max(t_end, rec["mono"] + rec["dur"])
                    args = rec.get("args", {})
                    lite = {"name": rec["name"], "cat": rec["cat"],
                            "mono": rec["mono"], "dur": rec["dur"],
                            "tid": rec.get("tid", "main"),
                            "compile": bool(rec.get("compile")),
                            "warmup": bool(rec.get("warmup")),
                            "group": args.get("group")}
                    seq += 1
                    if len(spans_heap) < MAX_TIMELINE:
                        heapq.heappush(spans_heap,
                                       (rec["dur"], seq, lite))
                    elif rec["dur"] > spans_heap[0][0]:
                        heapq.heapreplace(spans_heap,
                                          (rec["dur"], seq, lite))
                    if args.get("error") and len(incidents) < MAX_INCIDENTS:
                        incidents.append(
                            (rec["mono"], "error",
                             f"dispatch {rec['name']} "
                             f"group={args.get('group')} failed after "
                             f"{rec['dur']:.3f}s"))
                elif ev == "instant":
                    if (rec.get("cat") == "recover"
                            and len(incidents) < MAX_INCIDENTS):
                        incidents.append(
                            (rec["mono"], "recover",
                             f"{rec['name']} "
                             f"{json.dumps(rec.get('args', {}))}"))
                elif ev == "stall":
                    if len(incidents) < MAX_INCIDENTS:
                        incidents.append(
                            (rec.get("mono", 0.0), "stall",
                             f"STALL: {rec.get('name')} "
                             f"group={rec.get('group')} open "
                             f"{rec.get('open_s')}s"
                             + (" (repeat)" if rec.get("repeat")
                                else "")))
                elif "event" in rec:
                    last_metrics = rec
                    if rec["event"] == "final":
                        final = rec
                    prog = rec.get("progress")
                    if prog and prog.get("elapsed_s") is not None:
                        progress.append((prog["elapsed_s"],
                                         prog.get("eta_s"),
                                         prog.get("pct"),
                                         prog.get("done")))
    spans = [s for _, _, s in
             sorted(spans_heap, key=lambda t: t[2]["mono"])]
    incidents.sort(key=lambda t: t[0])
    return {"spans": spans, "n_spans": n_spans, "t_end": t_end,
            "progress": progress, "incidents": incidents, "meta": meta,
            "final": final, "last_metrics": last_metrics}


def collect_fleet(d: str) -> dict:
    """Stitch a FLEET's per-process JSONL files (a spool/fleet dir and
    its immediate subdirs — fan-out dirs, worker trace files) into
    per-JOB span sets keyed by correlation id.

    Per-process monotonic clocks do not compose, so cross-process
    alignment uses the WALL timestamp every span record carries
    (``ts``, stamped at span open); within one fleet the boxes are
    NTP-close and the render granularity is milliseconds.  Spans
    without a ``cid`` belong to no job (server warmup, idle scans) and
    are left out of the per-job timelines."""
    import glob as globmod

    paths = sorted(set(
        globmod.glob(os.path.join(d, "*.jsonl"))
        + globmod.glob(os.path.join(d, "*", "*.jsonl"))))
    jobs: dict = {}
    for path in paths:
        src = os.path.basename(path)
        if src.endswith(".jsonl"):
            src = src[:-len(".jsonl")]
        try:
            f = open(path, encoding="utf-8")
        except OSError:
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                cid = rec.get("cid")
                if (rec.get("ev") != "span" or not cid
                        or rec.get("ts") is None):
                    continue
                args = rec.get("args", {})
                # parse BEFORE creating the job entry: a cid whose
                # every record is malformed/torn must not leave an
                # empty-span job that crashes the alignment below
                try:
                    span = {
                        "name": rec["name"],
                        "cat": rec.get("cat", "host"),
                        "ts": float(rec["ts"]),
                        "dur": float(rec["dur"]),
                        "tid": f"{src}:{rec.get('tid', 'main')}",
                        "compile": bool(rec.get("compile")),
                        "warmup": bool(rec.get("warmup")),
                        "group": args.get("group")}
                except (KeyError, TypeError, ValueError):
                    continue
                j = jobs.setdefault(cid, {"spans": [],
                                          "sources": set()})
                j["spans"].append(span)
                j["sources"].add(src)
    for j in jobs.values():
        spans = j["spans"]
        t0 = min(s["ts"] for s in spans)
        for s in spans:
            s["mono"] = s["ts"] - t0   # job-relative wall offset
        spans.sort(key=lambda s: s["mono"])
        j["t0"] = t0
        j["t_end"] = max(s["mono"] + s["dur"] for s in spans)
    return {"paths": paths, "jobs": jobs}


# ---- SVG helpers ----------------------------------------------------------

def _esc(v) -> str:
    return html.escape(str(v), quote=True)


def _timeline_svg(spans: List[dict], t_end: float, n_spans: int) -> str:
    """Per-thread lanes of category-colored span rects, with native
    <title> hover tooltips (the no-JS hover layer)."""
    if not spans or t_end <= 0:
        return "<p class='muted'>no trace spans in the input " \
               "(metrics-only report)</p>"
    lanes: dict = {}
    for s in spans:
        if s["tid"] not in lanes and len(lanes) < MAX_LANES:
            lanes[s["tid"]] = len(lanes)
    width, lane_h, pad_l = 1000, 20, 150
    height = lane_h * len(lanes) + 24
    out = [f"<svg viewBox='0 0 {width + pad_l} {height}' "
           f"role='img' aria-label='span timeline' "
           f"style='width:100%;height:auto'>"]
    # x-axis ticks (recessive)
    for i in range(5):
        x = pad_l + width * i / 4
        t = t_end * i / 4
        out.append(f"<line x1='{x:.1f}' y1='0' x2='{x:.1f}' "
                   f"y2='{height - 16}' class='grid'/>")
        anchor = "end" if i == 4 else "middle" if i else "start"
        out.append(f"<text x='{x:.1f}' y='{height - 4}' "
                   f"class='tick' text-anchor='{anchor}'>"
                   f"{t:.1f}s</text>")
    for tid, lane in lanes.items():
        y = lane * lane_h
        out.append(f"<text x='{pad_l - 8}' y='{y + 14}' class='tick' "
                   f"text-anchor='end'>{_esc(tid[:22])}</text>")
    dropped = 0
    for s in spans:
        lane = lanes.get(s["tid"])
        if lane is None:
            dropped += 1
            continue
        x = pad_l + s["mono"] / t_end * width
        w = max(s["dur"] / t_end * width, 0.75)
        y = lane * lane_h + 3
        cls = f"c-{s['cat']}" if s["cat"] in CAT_ORDER else "c-host"
        tip = (f"{s['name']} [{s['cat']}] {s['dur'] * 1e3:.2f} ms "
               f"@{s['mono']:.3f}s"
               + (f" group={s['group']}" if s["group"] else "")
               + (" COMPILE" if s["compile"] else "")
               + (" warmup" if s["warmup"] else ""))
        extra = " stroke='var(--ink)' stroke-width='0.6'" \
            if s["compile"] else ""
        out.append(f"<rect x='{x:.2f}' y='{y}' width='{w:.2f}' "
                   f"height='{lane_h - 6}' rx='2' class='{cls}'"
                   f"{extra}><title>{_esc(tip)}</title></rect>")
    out.append("</svg>")
    cap = ""
    if n_spans > len(spans) or dropped:
        cap = (f"<p class='muted'>showing the {len(spans) - dropped} "
               f"longest of {n_spans} spans"
               + (f"; {dropped} on threads beyond the first "
                  f"{MAX_LANES} lanes omitted" if dropped else "")
               + "</p>")
    return "".join(out) + cap


def _eta_svg(progress: list, actual_total: Optional[float]) -> str:
    """Predicted remaining (live ETA) vs actual remaining over elapsed
    time — two lines, direct-labeled."""
    pts = [(e, eta) for e, eta, _pct, _d in progress if eta is not None]
    if not pts or not actual_total:
        return ("<p class='muted'>no ETA samples (unknown-total run, "
                "or no periodic progress events in the metrics "
                "input)</p>")
    width, height, pad_l, pad_b = 640, 220, 56, 28
    xmax = max(actual_total, max(e for e, _ in pts)) or 1.0
    ymax = max(max(eta for _, eta in pts),
               max(actual_total - e for e, _ in pts), 1.0)

    def xy(e, v):
        x = pad_l + e / xmax * (width - pad_l - 8)
        y = 8 + (1 - v / ymax) * (height - pad_b - 16)
        return f"{x:.1f},{y:.1f}"

    pred = " ".join(xy(e, eta) for e, eta in pts)
    act = " ".join(xy(e, max(actual_total - e, 0.0)) for e, _ in pts)
    out = [f"<svg viewBox='0 0 {width} {height}' role='img' "
           f"aria-label='ETA vs actual' "
           f"style='max-width:{width}px;width:100%;height:auto'>"]
    for i in range(4):
        y = 8 + i * (height - pad_b - 16) / 3
        v = ymax * (1 - i / 3)
        out.append(f"<line x1='{pad_l}' y1='{y:.1f}' x2='{width - 8}' "
                   f"y2='{y:.1f}' class='grid'/>")
        out.append(f"<text x='{pad_l - 6}' y='{y + 4:.1f}' class='tick' "
                   f"text-anchor='end'>{v:.0f}s</text>")
    for i in range(5):
        x = pad_l + i * (width - pad_l - 8) / 4
        out.append(f"<text x='{x:.1f}' y='{height - 8}' class='tick' "
                   f"text-anchor='middle'>{xmax * i / 4:.0f}s</text>")
    out.append(f"<polyline points='{pred}' class='line-pred'/>")
    out.append(f"<polyline points='{act}' class='line-act'/>")
    # direct labels (identity never color-alone)
    out.append(f"<text x='{pad_l + 6}' y='20' class='lbl-pred'>"
               f"predicted remaining (live ETA)</text>")
    out.append(f"<text x='{pad_l + 6}' y='36' class='lbl-act'>"
               f"actual remaining</text>")
    out.append("</svg>")
    errs = [abs((e + eta) - actual_total) / actual_total
            for e, eta in pts]
    errs.sort()
    med = errs[len(errs) // 2] * 100
    out.append(f"<p class='muted'>{len(pts)} ETA samples; median "
               f"|predicted finish − actual| = {med:.1f}% of the "
               f"{actual_total:.0f}s wall</p>")
    return "".join(out)


def _stage_bars(stage_seconds: dict) -> str:
    if not stage_seconds:
        return "<p class='muted'>no span input — stage breakdown " \
               "needs a trace file</p>"
    total = sum(stage_seconds.values()) or 1.0
    rows = []
    for cat in sorted(stage_seconds, key=stage_seconds.get,
                      reverse=True):
        v = stage_seconds[cat]
        pct = v / total * 100
        cls = f"c-{cat}" if cat in CAT_ORDER else "c-host"
        rows.append(
            "<div class='bar-row'>"
            f"<span class='bar-lbl'>{_esc(cat)}</span>"
            f"<span class='bar-track'><span class='bar-fill {cls}' "
            f"style='width:{max(pct, 0.5):.2f}%'></span></span>"
            f"<span class='bar-val'>{v:.2f}s ({pct:.1f}%)</span>"
            "</div>")
    return ("<div class='bars'>" + "".join(rows)
            + "</div><p class='muted'>span self-seconds by category; "
              "nested children excluded (same sums as `ccsx-tpu "
              "stats`)</p>")


def _group_table(groups: dict, forced) -> str:
    if not groups:
        return "<p class='muted'>no shape groups in the input</p>"
    head = ("<tr><th>group</th><th>compiles</th><th>compile_s</th>"
            "<th>execute_s</th><th>dispatches</th><th>dp_cells</th>"
            "<th>dp_cells/s</th></tr>")
    rows = []
    for key, st in sorted(groups.items()):
        warn = " class='warn'" if st.get("compiles", 0) > 2 else ""
        cps = st.get("dp_cells_per_sec")
        rows.append(
            f"<tr{warn}><td class='mono'>{_esc(key)}</td>"
            f"<td>{st['compiles']}</td><td>{st['compile_s']}</td>"
            f"<td>{st['execute_s']}</td><td>{st['dispatches']}</td>"
            f"<td>{st['dp_cells']}</td>"
            f"<td>{cps if cps is not None else '—'}</td></tr>")
    note = ""
    if forced is False:
        note = ("<p class='warn-text'>⚠ UNFORCED timing (no --trace): "
                "per-group seconds are dispatch-queue bookkeeping on "
                "an async backend — counts exact, rates unreliable</p>")
    return note + "<table>" + head + "".join(rows) + "</table>"


def _tiles(snap: dict) -> str:
    tiles = []
    for k in REPORT_TILE_KEYS:
        v = snap.get(k)
        if v is None:
            continue
        tiles.append(f"<div class='tile'><div class='tile-v'>{_esc(v)}"
                     f"</div><div class='tile-k'>{_esc(k)}</div></div>")
    if not tiles:
        return "<p class='muted'>no metrics snapshot in the input</p>"
    return "<div class='tiles'>" + "".join(tiles) + "</div>"


def _incident_log(incidents: list, degraded) -> str:
    if not incidents and not degraded:
        return "<p class='muted'>no stalls, recoveries, or failed " \
               "dispatches recorded — clean run</p>"
    rows = []
    for mono, kind, text in incidents:
        cls = {"stall": "crit", "error": "crit",
               "recover": "warn-text"}.get(kind, "")
        rows.append(f"<li class='{cls}'><span class='mono'>"
                    f"{mono:9.3f}s</span> [{kind}] {_esc(text)}</li>")
    return "<ul class='log'>" + "".join(rows) + "</ul>"


# ---- page assembly --------------------------------------------------------

_CSS_TMPL = """
:root { color-scheme: light dark; }
body { margin: 2rem auto; max-width: 1080px; padding: 0 1rem;
  font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
  background: light-dark(#f9f9f7, #0d0d0d);
  color: light-dark(#0b0b0b, #ffffff); }
section { background: light-dark(#fcfcfb, #1a1a19);
  border: 1px solid light-dark(rgba(11,11,11,.10), rgba(255,255,255,.10));
  border-radius: 8px; padding: 1rem 1.25rem; margin: 1rem 0; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; }
.muted { color: #898781; font-size: .85rem; }
.mono { font-family: ui-monospace, monospace; font-size: .85em; }
.banner { border-radius: 6px; padding: .6rem 1rem; font-weight: 600; }
.banner.ok { background: color-mix(in srgb, #0ca30c 12%, transparent);
  color: light-dark(#006300, #0ca30c); }
.banner.bad { background: color-mix(in srgb, #d03b3b 14%, transparent);
  color: #d03b3b; }
table { border-collapse: collapse; width: 100%; font-size: .85rem;
  font-variant-numeric: tabular-nums; }
th, td { text-align: right; padding: .25rem .6rem;
  border-bottom: 1px solid light-dark(#e1e0d9, #2c2c2a); }
th:first-child, td:first-child { text-align: left; }
tr.warn td { color: #d03b3b; }
.warn-text { color: light-dark(#b87700, #fab219); }
.crit { color: #d03b3b; }
.tiles { display: flex; flex-wrap: wrap; gap: .75rem; }
.tile { border: 1px solid light-dark(#e1e0d9, #2c2c2a);
  border-radius: 6px; padding: .5rem .9rem; min-width: 7rem; }
.tile-v { font-size: 1.25rem; font-weight: 650; }
.tile-k { color: #898781; font-size: .72rem; }
.bars { display: grid; gap: .3rem; }
.bar-row { display: grid; grid-template-columns: 6rem 1fr 10rem;
  align-items: center; gap: .6rem; font-size: .85rem; }
.bar-track { background: light-dark(#e1e0d9, #2c2c2a);
  border-radius: 4px; height: 12px; overflow: hidden; display: block; }
.bar-fill { display: block; height: 100%; border-radius: 4px; }
.bar-val { font-variant-numeric: tabular-nums; color:
  light-dark(#52514e, #c3c2b7); }
.log { font-size: .85rem; list-style: none; padding-left: 0; }
.log li { padding: .12rem 0; }
.grid { stroke: light-dark(#e1e0d9, #2c2c2a); stroke-width: 1; }
.tick { fill: #898781; font-size: 11px; }
svg { --ink: light-dark(#0b0b0b, #ffffff); }
.line-pred { fill: none; stroke: light-dark(#2a78d6, #3987e5);
  stroke-width: 2; }
.line-act { fill: none; stroke: light-dark(#eb6834, #d95926);
  stroke-width: 2; }
.lbl-pred { fill: light-dark(#1c5cab, #86b6ef); font-size: 12px; }
.lbl-act { fill: light-dark(#b84f20, #e8824f); font-size: 12px; }
.legend { display: flex; flex-wrap: wrap; gap: .9rem;
  font-size: .8rem; margin: .4rem 0; }
.legend .sw { display: inline-block; width: 10px; height: 10px;
  border-radius: 2px; margin-right: .3rem; }
%CATS%
"""


def _cat_css() -> str:
    rules = []
    for cat, (lt, dk) in zip(CAT_ORDER, _SLOTS):
        rules.append(f".c-{cat} {{ fill: light-dark({lt}, {dk}); "
                     f"background: light-dark({lt}, {dk}); }}")
    return "\n".join(rules)


def render_html(paths: List[str], title: Optional[str] = None) -> str:
    data = collect(paths)
    summary = trace_mod.summarize(paths)
    snap = data["final"] or data["last_metrics"] or {}
    degraded = snap.get("degraded") or summary.get("degraded")
    prog = snap.get("progress") or {}
    actual_total = prog.get("elapsed_s") or snap.get("elapsed_s")
    title = title or f"ccsx-tpu-torch run report — {os.path.basename(paths[0])}"
    banner = (f"<div class='banner bad'>DEGRADED: {_esc(degraded)}"
              "</div>" if degraded else
              "<div class='banner ok'>healthy run — no watchdog "
              "stalls</div>")
    hdr_rows = "".join(
        f"<tr><td>{_esc(k)}</td><td>{_esc(snap.get(k))}</td></tr>"
        for k in REPORT_HEADER_KEYS if snap.get(k) is not None)
    legend = "<div class='legend'>" + "".join(
        f"<span><span class='sw c-{c}'></span>{c}</span>"
        for c in CAT_ORDER) + "</div>"
    gauges = "".join(
        f"<tr><td>{_esc(k)}</td><td>{_esc(snap[k])}</td></tr>"
        for k in ("peak_rss_bytes", "device_buffer_bytes")
        if snap.get(k) is not None)
    css = _CSS_TMPL.replace("%CATS%", _cat_css())
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{_esc(title)}</title>
<style>{css}</style></head><body>
<h1>{_esc(title)}</h1>
<p class='muted'>inputs: {_esc(' '.join(paths))} &middot;
{data['n_spans']} spans &middot; generated by `ccsx-tpu report`</p>
{banner}
<section><h2>Run summary</h2>
<table>{hdr_rows or "<tr><td class='muted'>no metrics input</td></tr>"}
{gauges}</table></section>
<section><h2>Timeline</h2>{legend}
{_timeline_svg(data['spans'], data['t_end'], data['n_spans'])}</section>
<section><h2>Stage self-time breakdown</h2>
{_stage_bars(summary.get('stage_seconds') or {})}</section>
<section><h2>Shape-group compile/execute table</h2>
{_group_table(summary.get('groups') or {}, summary.get('groups_forced'))}
</section>
<section><h2>Occupancy &amp; fill</h2>{_tiles(snap)}</section>
<section><h2>Progress: ETA vs actual</h2>
{_eta_svg(data['progress'], actual_total)}</section>
<section><h2>Stall &amp; recovery log</h2>
{_incident_log(data['incidents'], degraded)}</section>
</body></html>
"""


def render_fleet_html(d: str, title: Optional[str] = None) -> str:
    """`report --fleet`: one page, ONE merged timeline per job —
    every process that touched the job (holder replica, helper
    replicas, fan-out workers) interleaved on wall-aligned lanes,
    stitched by the correlation id the gateway minted at submission."""
    data = collect_fleet(d)
    jobs = data["jobs"]
    name = os.path.basename(os.path.normpath(d)) or d
    title = title or f"ccsx-tpu-torch fleet report — {name}"
    legend = "<div class='legend'>" + "".join(
        f"<span><span class='sw c-{c}'></span>{c}</span>"
        for c in CAT_ORDER) + "</div>"
    sections = []
    for cid in sorted(jobs, key=lambda c: jobs[c]["t0"]):
        j = jobs[cid]
        n = len(j["spans"])
        spans = j["spans"]
        if n > MAX_TIMELINE:
            spans = sorted(spans, key=lambda s: s["dur"],
                           reverse=True)[:MAX_TIMELINE]
            spans.sort(key=lambda s: s["mono"])
        srcs = ", ".join(sorted(j["sources"]))
        sections.append(
            f"<section><h2>Job <span class='mono'>{_esc(cid)}</span>"
            f"</h2><p class='muted'>{n} spans across "
            f"{len(j['sources'])} source(s): {_esc(srcs)}</p>"
            f"{legend}{_timeline_svg(spans, j['t_end'], n)}</section>")
    if not sections:
        sections = [
            "<section><p class='muted'>no correlated spans found — "
            "fleet timelines need per-process --trace JSONL carrying "
            "correlation ids (jobs submitted through the gateway or "
            "serve API)</p></section>"]
    css = _CSS_TMPL.replace("%CATS%", _cat_css())
    return f"""<!DOCTYPE html>
<html lang="en"><head><meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{_esc(title)}</title>
<style>{css}</style></head><body>
<h1>{_esc(title)}</h1>
<p class='muted'>fleet dir: {_esc(d)} &middot;
{len(data['paths'])} JSONL file(s) &middot; {len(jobs)} correlated
job(s) &middot; generated by `ccsx-tpu report --fleet`</p>
{"".join(sections)}
</body></html>
"""


def default_out_path(first_input: str) -> str:
    base = (first_input[:-6] if first_input.endswith(".jsonl")
            else first_input)
    return base + ".report.html"


def report_main(argv) -> int:
    """The `ccsx-tpu report` subcommand (dispatched from cli.main)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="ccsx-tpu-torch report",
        description="Render a self-contained HTML run report from "
                    "--trace / --metrics JSONL artifacts (any mix): "
                    "timeline strip, group compile/execute table, "
                    "stage breakdown, occupancy tiles, stall/recovery "
                    "log, ETA-vs-actual curve.")
    ap.add_argument("paths", nargs="*",
                    help="trace and/or metrics JSONL files")
    ap.add_argument("--fleet", default=None, metavar="DIR",
                    help="stitch a fleet/spool directory's per-process "
                         "JSONL into one merged per-job timeline page "
                         "keyed by correlation id (ignores positional "
                         "paths)")
    ap.add_argument("-o", "--out", default=None,
                    help="output HTML path "
                         "[<first input minus .jsonl>.report.html, or "
                         "<fleet dir>/fleet.report.html]")
    ap.add_argument("--title", default=None)
    a = ap.parse_args(argv)
    if not a.fleet and not a.paths:
        ap.error("need JSONL paths or --fleet DIR")
    if a.fleet:
        out = a.out or os.path.join(a.fleet, "fleet.report.html")
        try:
            page = render_fleet_html(a.fleet, title=a.title)
        except OSError as e:
            print(f"Error: report: {e}", file=sys.stderr)
            return 1
        try:
            with open(out, "w", encoding="utf-8") as f:
                f.write(page)
        except OSError as e:
            print(f"Error: report: cannot write {out!r}: {e}",
                  file=sys.stderr)
            return 1
        print(f"[ccsx-tpu-torch] report: {out}", file=sys.stderr)
        return 0
    out = a.out or default_out_path(a.paths[0])
    try:
        page = render_html(a.paths, title=a.title)
    except OSError as e:
        print(f"Error: report: {e}", file=sys.stderr)
        return 1
    try:
        with open(out, "w", encoding="utf-8") as f:
            f.write(page)
    except OSError as e:
        print(f"Error: report: cannot write {out!r}: {e}",
              file=sys.stderr)
        return 1
    print(f"[ccsx-tpu-torch] report: {out}", file=sys.stderr)
    return 0
