"""Configuration for ccsx_tpu_torch (a copy of the JAX package's config, so
the two build the same CcsConfig from one dict; see convert.py).

All parity-critical constants of the reference are collected here with their
source citations (the reference ccsx sources, catalogued in SURVEY.md §2.5).
TPU-specific knobs (buckets, band widths, microbatch sizes) are grouped at the
bottom; they control tiling only, never semantics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AlignParams:
    """Alignment scoring parameters.

    Defaults mirror the BSPOA parameters the reference wires up at
    main.c:841-850 (M=2 X=-6 O=-3 E=-2, bandwidth=128).  The reference's
    second affine channel is disabled there (Q=P=0), so we model a single
    affine gap.
    """

    match: int = 2
    mismatch: int = -6
    gap_open: int = -3     # charged on the first gap base *in addition* to gap_extend
    gap_extend: int = -2
    band: int = 128        # main.c:849 bandwidth=128 == TPU lane width


@dataclasses.dataclass
class CcsConfig:
    # ---- CLI-equivalent options (reference main.c:751-800) ----
    min_subread_len: int = 5000        # -m, main.c:753
    max_subread_len: int = 500000      # -M, main.c:753
    min_fulllen_count: int = 3         # -c (>=3 enforced, main.c:786-789);
    #   a hole is kept iff its subread count >= min_fulllen_count + 2 (main.c:659)
    split_subread: bool = True         # default shred mode; -P selects whole-read (main.c:754,766)
    is_bam: bool = True                # -A selects FASTA/Q (main.c:770)
    exclude_holes: Optional[frozenset] = None   # -X comma list (main.c:772-783)
    threads: int = 1                   # -j host-side worker threads (main.c:754)
    verbose: int = 0                   # -v repeatable (main.c:791-793)

    # ---- prepare / orientation (main.c:116-453) ----
    group_tolerance_pct: int = 10      # length-cluster tolerance (main.c:350)
    strand_identity_pct: int = 75      # strand_match accept identity (main.c:392)
    border_identity_pct: int = 70      # template border RC check (main.c:326,332)
    border_len: int = 1000             # border length for template check (main.c:324)
    border_min_template: int = 2000    # candidate median len must exceed (main.c:320)
    # candidate group must have >= 2 members and size*5 >= 4*size(best) (main.c:312-313)

    # ---- windowed consensus (ccs_for2, main.c:541-546) ----
    bp_window: int = 10                # breakpoint window: consecutive MSA cols
    bp_minwin: int = 5                 # min consensus-base cols in the window
    bp_rowrate: int = 80               # per-row agreement %, main.c:541
    bp_colrate: int = 80               # per-col agreement % (60 if <10 passes, main.c:546)
    bp_colrate_lowpass: int = 60
    window_init: int = 2048            # reference initlen=2000; we round to a lane
    window_add: int = 2048             # reference addlen=2000
    window_minlen: int = 1024          # reference minlen=1000: min tail beyond window
    max_window: int = 8192             # growth cap before force-flush (TPU memory bound)
    window_growth: str = "flush"       # at max_window: "flush" force-flushes a
    #   breakpoint (bounded shapes; documented delta), "grow" keeps growing like
    #   the reference's unbounded window (main.c:550,613-616) — geometric length
    #   buckets keep the compile count logarithmic, so parity mode stays viable

    # ---- consensus redesign knobs (no reference equivalent) ----
    refine_iters: int = 2              # realign-to-draft refinement rounds;
    #   intermediate rounds use liberal-insert/strict-delete (ops/msa.py)
    max_ins_per_col: int = 4           # inserted bases stored per (pass, template col)

    # ---- per-base quality output (extension; the reference writes FASTA
    #      only, main.c:714 — no qualities exist to compare against) ----
    emit_quality: bool = False         # CLI --fastq: write FASTQ with
    #   vote-margin Phred qualities (star.RoundResult.materialize_with_qual)
    bam_out: bool = False              # CLI --bam: unaligned BAM output with
    #   qual fields filled (implies emit_quality) + an rq aux tag
    # Coverage-conditioned vote-margin QV: Q = qv_base + qv_per_support*s
    # - qv_per_dissent*d for a column with s supporting / d dissenting
    # passes.  A dissenting pass is far stronger evidence of a real
    # ambiguity than a missing supporter (measured per-(s,d) error on the
    # synthetic pass distribution, r4: one dissent costs ~8 Q at fixed
    # support while each supporter adds ~3) — a single net-vote slope
    # cannot express both, which produced the r3 mid-range calibration
    # dip (quality_r03.json: predicted [15,20) observed worse than
    # [10,15)).
    qv_base: float = 8.0
    qv_per_support: float = 3.0
    qv_per_dissent: float = 6.0
    # The support slope flattens past qv_knee supporters: residual
    # consensus errors at moderate+ coverage are dominated by correlated
    # effects (homopolymer indels, window stitching) that extra coverage
    # does not vote away — the measured unanimous-column error plateaus
    # near Q27-28 at s=6-7 instead of following the low-coverage slope.
    # Past the knee each supporter adds qv_per_support_tail.  Unanimous
    # s=16 predicts Q34, tracking the measured Q37@16 (BASELINE.md);
    # the full coefficient fit is the r4 per-(s,d) error study — these
    # values give a 9/9-bin monotone calibration table at 5-Q
    # granularity, observed error conservative in every bin.
    qv_knee: int = 5
    qv_per_support_tail: float = 1.0
    # Homopolymer-run penalty: a consensus base inside a length-R run
    # loses qv_per_hp * min(R-1, qv_hp_cap) Q.  Fitted to the r5
    # correlated-error study (benchmarks/quality.py, hp_factor=0.6
    # hp_ins_same=0.7): at fixed predicted Q, observed Q drops ~6-9 per
    # run unit because homopolymer indels are CORRELATED across passes
    # — unanimous columns in long runs can be unanimously wrong, which
    # vote margins cannot see.  The cap reflects the measured flattening
    # past run ~5.  Under i.i.d. errors the penalty is merely
    # conservative (hp columns are no worse there); under realistic
    # correlated errors it is what keeps the calibration monotone.
    qv_per_hp: float = 7.0
    qv_hp_cap: int = 4
    qv_cap: int = 60                   # quality ceiling (vote margins with
    #   <=64 passes justify no more)

    # ---- alignment scoring ----
    align: AlignParams = dataclasses.field(default_factory=AlignParams)

    # ---- pipeline (worker_pipeline, main.c:649-720) ----
    chunk_size: int = 1024             # main.c:833; grows x4 to cap (main.c:686-691)
    chunk_growth: int = 4
    chunk_cap: int = 16384

    # ---- TPU tiling ----
    pass_buckets: tuple = (4, 8, 16, 32)   # passes padded to the next bucket
    #   (request/tensor shapes, the per-hole path, the mesh path, and the
    #   --pass-buckets bucketed A/B control; the packed batched path
    #   strips this padding back off before dispatch)
    pass_packing: bool = True          # batched pipeline: pack (hole, pass)
    #   rows into fixed (slab_rows, qmax) slabs (pipeline/pack.py) instead
    #   of grouping by pass bucket — kills pass-bucket and partial-Z
    #   padding at byte-identical output.  CLI --pass-buckets selects the
    #   bucketed control; a device mesh also keeps the bucketed layout
    max_passes: int = 32               # extra passes beyond this are dropped (deepest
    #   passes add negligible consensus signal; reference keeps all — documented delta)
    slab_rows: int = 128               # packed-slab row budget (power of two;
    #   the Z-bucket analog for packed dispatches)
    slab_shape_ladder: int = 2         # canonical tail-slab heights per
    #   (qmax, tmax, iters) group: budget >> k for k < ladder (CLI
    #   --slab-shape-ladder).  Bounds a packed group to <= ladder XLA
    #   programs ever (the r7 flight recorder caught the finer budget/8
    #   ladder paying 4-5 compiles per group); 1 = every slab dispatches
    #   at the full budget
    warmup_compile: bool = True        # AOT warmup precompiler (pipeline/
    #   warmup.py): a background thread compiles each packed group's
    #   canonical executables as soon as prep predicts them, overlapping
    #   cold compiles with ingest instead of stalling the first dispatch
    #   of every shape.  CLI --no-warmup disables
    zmw_microbatch: int = 64           # ZMWs per device dispatch; also the
    #   ADAPTIVE admission-window cap of the batched driver: without an
    #   explicit --inflight the window starts at cap/chunk_growth^2 and
    #   multiplies by chunk_growth per filled admission round — the
    #   reference's 1024 -> x4 -> 16384 policy (main.c:686-691) scaled
    prep_threads: Optional[int] = None  # overlapped prep plane (pipeline/
    #   prep_pool.py): background threads that ingest + run the
    #   orientation walk ahead of the admission window, feeding the
    #   batched driver through a ready queue so host prep overlaps
    #   device compute instead of adding to it.  None = auto-size to
    #   the host; 0 = the old inline behavior (CLI --prep-threads).
    #   Output bytes are identical either way
    # ---- pre-alignment plane (ops/sketch.py + ops/seed_device.py;
    #      ROADMAP item 4: the RASSA/SeGraM filter-before-DP lineage) ----
    prefilter: bool = True             # CLI --prefilter {on,off}: a
    #   batched device screen scores every wave of strand_match pair
    #   candidates (capped k-mer hits + best diagonal-window votes,
    #   bit-equal to the host seed gate's statistics) and rejects
    #   hopeless pairings BEFORE the banded DP — the long-template
    #   regime's dominant waste (a wrong-strand 100kb pair passes the
    #   legacy votes>=3 gate essentially always and pays a multi-second
    #   doomed DP).  Rejection is conservative (ops/sketch.py rules:
    #   seed-gate parity, margin-analyzed noise gate, provable band-
    #   overlap geometry); output bytes are identical on/off (pinned).
    #   On also lets the orientation walk speculate fwd+RC strand pairs
    #   as ONE batch (prepare.PairBatch) — the hopeless arm dies in the
    #   screen, halving the walk's sequential pair waves
    seed_device_min_t: int = 16384     # CLI --seed-device-min-t: the
    #   host/device seeding crossover — pairs whose template is at
    #   least this long take the batched device k-mer seeder
    #   (ops/seed_device.py, bit-equal to ops/seed.seed_diagonal);
    #   shorter ones keep the host sort-join with its per-template
    #   index cache.  0 disables device seeding entirely.  Purely a
    #   performance routing knob — either path yields the same hint
    len_bucket_quant: int = 512        # whole-read mode: lengths padded to multiple

    # ---- device/mesh ----
    device: str = "cuda"               # {cuda, cpu}: the card unless the
    #   caller asks for the CPU (utils/device.resolve_device)
    banded_impl: str = ""              # CLI --banded-impl: banded DP-fill
    #   arm {scan, pallas, rotband}; on the card "", scan and pallas
    #   launch the band-local kernel and rotband the rotating-band one
    #   (consensus/star.global_fill); on the CPU each arm runs its plain
    #   version.  All are bit-identical — a pure performance A/B knob
    mesh_shape: Optional[tuple] = None  # (data, pass) for the batched
    #   pipeline's device mesh, e.g. (4, 2); (D,) means (D, 1); None =
    #   all local devices on the data axis (CLI: --mesh D,P)

    # ---- observability (SURVEY.md §5.1/5.5: absent in the reference) ----
    metrics_path: Optional[str] = None  # JSON-lines metrics events
    trace_path: Optional[str] = None    # CLI --trace: dispatch flight
    #   recorder (utils/trace.py) — span JSONL + Chrome trace export,
    #   forced-execution device spans, per-shape-group compile/execute
    #   attribution merged into every metrics event
    stall_timeout_s: float = 120.0      # CLI --stall-timeout: the hang
    #   watchdog fires when a device-dispatch span stays open this long,
    #   dumping thread stacks + the in-flight shape group (0 disables)
    # ---- resilient execution (pipeline/resilience.py; the reference
    #      has no failure story at all beyond abort-or-soldier-on) ----
    dispatch_deadline_s: float = 0.0    # CLI --dispatch-deadline: bound
    #   every device dispatch/materialize wait; on expiry the wedged
    #   call is abandoned (thread parked, result discarded) and the
    #   group replays on the bit-exact host path.  First call of each
    #   (group, phase) gets the compile grace (x10, like the stall
    #   watchdog).  0 = off: a hung dispatch stalls the run forever
    #   (the watchdog observes but never kills — today's behavior)
    breaker_strikes: int = 3            # CLI --breaker-strikes: device
    #   failures (hangs, OOM ladder-bottoms, compile failures) within
    #   breaker_window_s that trip the circuit breaker open — remaining
    #   work runs on the host path.  0 disables the breaker
    breaker_window_s: float = 60.0      # strike-counting window
    breaker_probe_s: float = 0.0        # CLI --breaker-probe-s: half-
    #   open re-probe interval for a tripped breaker (one group is
    #   dispatched as a probe; success closes the breaker).  0 = a
    #   tripped breaker stays open for the rest of the run
    # ---- hostile-input ingest plane (io/corruption.py) ----
    salvage: bool = False              # CLI --salvage: classified input
    #   corruption (torn BGZF blocks, corrupt records, bad names,
    #   truncated FASTQ — the pinned taxonomy) is booked + RESYNCED
    #   past instead of killing the run: BGZF scans for the next valid
    #   block header, BAM scans for the next plausible record, FASTA/Q
    #   re-anchors on the next '>'/'@' line.  Off (default) = the
    #   historical fail-fast rc-1, byte-identical.  Corrupt events
    #   count into holes_corrupt, mark the run degraded, and feed the
    #   --max-failed-holes budget
    max_record_bytes: int = 256 * 1024 * 1024  # CLI --max-record-bytes:
    #   allocation bound on one BAM alignment record, enforced BEFORE
    #   allocating — a corrupt int32 length must not drive a multi-GB
    #   allocation (both reader stacks, salvage on or off)
    max_failed_holes: Optional[float] = None  # CLI --max-failed-holes:
    #   quarantine budget — an integer count (>= 0, checked per
    #   failure) or a fraction of processed holes in (0, 1) (checked at
    #   end of run / against a known total).  Exceeding it aborts with
    #   rc 2 (exitcodes.RC_FAILED_HOLES) instead of emitting a
    #   near-empty output at rc 0.  None = unbounded (historical)
    telemetry_port: int = 0             # CLI --telemetry-port: live
    #   telemetry endpoints (utils/telemetry.py — GET /metrics
    #   Prometheus text, /healthz ok|degraded, /progress JSON) served
    #   by a daemon thread for the run's duration.  0 = off (default);
    #   the port auto-bumps upward when taken, and sharded runs offset
    #   it per rank (parallel/distributed.py) so every rank is
    #   scrapeable — `ccsx-tpu top` aggregates them

    def metrics_stream(self):
        return open(self.metrics_path, "a") if self.metrics_path else None

    def __post_init__(self):
        if self.min_fulllen_count < 3:
            raise ValueError(
                f"min fulllen count={self.min_fulllen_count} (>=3)!"  # main.c:787
            )

    @property
    def min_pass_count(self) -> int:
        """A hole is kept iff subread count >= this (main.c:659)."""
        return self.min_fulllen_count + 2

    @property
    def qv_coeffs(self) -> tuple:
        """(base, per_support, per_dissent, knee, per_support_tail,
        per_hp, hp_cap) for materialize_with_qual."""
        return (self.qv_base, self.qv_per_support, self.qv_per_dissent,
                self.qv_knee, self.qv_per_support_tail,
                self.qv_per_hp, self.qv_hp_cap)
