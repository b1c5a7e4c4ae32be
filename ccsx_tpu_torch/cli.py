"""ccsx-compatible CLI of the PyTorch/CUDA port.

Same conventions as the JAX package's CLI and the reference's getopt loop:
positional INPUT OUTPUT with '-' for stdin/stdout, -A for FASTA/Q input,
-P for whole-read mode, -X hole exclusion, -c >= 3 enforced.  The run goes
to the card; ``--device cpu`` runs the plain PyTorch versions instead.
``--batch auto`` (the default) selects the batched driver on the card and
the per-hole driver on the CPU, as the JAX package does for an accelerator
and for its CPU backend; ``--pass-buckets`` switches the batched driver
from packed slabs to the bucketed (Z, P) grouping.  The tuning knobs keep
the JAX package's spellings, defaults and error messages.

    python -m ccsx_tpu_torch.cli [options] <INPUT> <OUTPUT>
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

from ccsx_tpu_torch import exitcodes
from ccsx_tpu_torch.config import CcsConfig

USAGE = """\
Program: ccsx-tpu-torch
Version: 1.0.0
Usage  : ccsx-tpu-torch  [options] <INPUT> <OUTPUT>
Generate circular consensus sequences (ccs) from subreads.

Options:
-h             Output this help
-v             debug
-m     <int>   Minimum total length of subreads in a hole to use for generating CCS. [5000]
-M     <int>   Maximum total length of subreads in a hole to use for generating CCS. [500000]
-c     <int>   Minimum number of subreads required to generate CCS. [3]
-A             For fasta/fastq input,gzip allowed
-P             primitive bsalign,subread shred by default
-X\t\t<str>   Exclude ZMWs from output file,a comma-separated list of ID
-j     <int>   Number of threads to use. [1]

Arguments:
input          Input file.
output         Output file.

Port options (long):
--device {cuda,cpu}   the card (default) or the plain CPU path
--batch {auto,on,off} batched packed driver (on) or per-hole driver (off);
                      auto: on for cuda, off for cpu [auto]
--inflight <int>      pin the batched driver's admission window to N holes
                      (default: adaptive, zmw_microbatch/16 growing x4 up
                      to zmw_microbatch, the reference's chunk policy)
--banded-impl {scan,pallas,rotband}
                      global-fill arm: scan and pallas (the default) run the
                      band-local kernel on the card, rotband the
                      rotating-band kernel; same output bytes either way.
                      With --device cpu each arm runs its plain version
--fastq               write FASTQ with per-base vote-margin qualities
--refine-iters <int>  speculative refinement rounds per window [2]
--max-passes <int>    passes beyond this are dropped [32]
--pass-buckets A,B,...
                      the bucketed A/B control: no pass packing, each
                      hole's passes padded to these buckets (ascending
                      ints, the last covering --max-passes); same output
                      bytes either way
--slab-rows <int>     pass-packing slab row budget (power of two) [128]
--slab-shape-ladder <int>
                      canonical tail-slab heights per packed shape group,
                      1-8 [2]
--prefilter {on,off}  reject hopeless strand-walk pairs before the local
                      fill (device screen + seed statistics); off also
                      stops the walk's fwd+RC speculation.  Same output
                      bytes either way [on]
--window-growth {flush,grow}
                      at the largest window with no breakpoint: force a
                      flush, or keep growing like the reference [flush]
--seed-device-min-t <int>
                      templates of at least this many bases seed on the
                      device (ops/seed_device.py), shorter ones on the
                      host; 0 seeds every pair on the host [16384]
"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ccsx-tpu-torch", add_help=False)
    p.add_argument("-h", "--help", action="store_true", dest="help")
    p.add_argument("input", nargs="?", default="-")
    p.add_argument("output", nargs="?", default="-")
    p.add_argument("-m", type=int, default=5000, dest="min_len")
    p.add_argument("-M", type=int, default=500000, dest="max_len")
    p.add_argument("-c", type=int, default=3, dest="min_count")
    p.add_argument("-A", action="store_true", dest="fastx")
    p.add_argument("-P", action="store_true", dest="primitive")
    p.add_argument("-X", default=None, dest="exclude")
    p.add_argument("-j", type=int, default=1, dest="threads")
    p.add_argument("-v", action="count", default=0, dest="verbose")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batch", default="auto", choices=["auto", "on", "off"])
    p.add_argument("--inflight", type=int, default=None)
    p.add_argument("--banded-impl", default="", dest="banded_impl",
                   choices=["", "scan", "pallas", "rotband"])
    p.add_argument("--fastq", action="store_true", dest="fastq")
    p.add_argument("--refine-iters", type=int, default=2)
    p.add_argument("--max-passes", type=int, default=32)
    p.add_argument("--pass-buckets", default=None, metavar="A,B,...")
    p.add_argument("--slab-rows", type=int, default=None, metavar="R")
    p.add_argument("--slab-shape-ladder", type=int, default=None,
                   metavar="N", dest="slab_shape_ladder")
    p.add_argument("--prefilter", default="on", choices=["on", "off"])
    p.add_argument("--window-growth", default="flush",
                   choices=["flush", "grow"])
    p.add_argument("--seed-device-min-t", type=int, default=None,
                   dest="seed_device_min_t", metavar="N")
    return p


def config_from_args(args) -> CcsConfig:
    if args.min_count < 3:
        print(f"Error! min fulllen count=[{args.min_count}] (>=3) !",
              file=sys.stderr)
        raise SystemExit(-1)
    exclude = None
    if args.exclude:
        exclude = frozenset(x for x in args.exclude.split(",") if x)
    pass_buckets = None
    if args.pass_buckets:
        try:
            pass_buckets = tuple(
                int(x) for x in args.pass_buckets.split(","))
            if (not pass_buckets or min(pass_buckets) < 1
                    or list(pass_buckets) != sorted(set(pass_buckets))):
                raise ValueError
        except ValueError:
            print("Error: --pass-buckets expects ascending positive "
                  f"integers, got {args.pass_buckets!r}", file=sys.stderr)
            raise SystemExit(1)
        if pass_buckets[-1] < args.max_passes:
            print(f"Error: --pass-buckets last bucket "
                  f"{pass_buckets[-1]} must cover --max-passes "
                  f"{args.max_passes}", file=sys.stderr)
            raise SystemExit(1)
    if args.slab_rows is not None and args.slab_rows < 1:
        print(f"Error: --slab-rows must be >= 1, got {args.slab_rows}",
              file=sys.stderr)
        raise SystemExit(1)
    ladder = args.slab_shape_ladder
    if ladder is not None and not 1 <= ladder <= 8:
        print(f"Error: --slab-shape-ladder must be in [1, 8], got "
              f"{ladder}", file=sys.stderr)
        raise SystemExit(1)
    min_t = args.seed_device_min_t
    if min_t is not None and min_t < 0:
        print(f"Error: --seed-device-min-t must be >= 0, got {min_t}",
              file=sys.stderr)
        raise SystemExit(1)
    return CcsConfig(
        min_subread_len=args.min_len,
        max_subread_len=args.max_len,
        min_fulllen_count=args.min_count,
        split_subread=not args.primitive,
        is_bam=not args.fastx,
        exclude_holes=exclude,
        threads=max(args.threads, 1),
        verbose=args.verbose,
        emit_quality=args.fastq,
        device=args.device,
        banded_impl=args.banded_impl,
        refine_iters=args.refine_iters,
        max_passes=args.max_passes,
        window_growth=args.window_growth,
        prefilter=args.prefilter != "off",
        # an explicit bucket list selects the bucketed control path; the
        # default is pass packing (pipeline/pack.py)
        pass_packing=pass_buckets is None,
        **({"pass_buckets": pass_buckets} if pass_buckets else {}),
        **({"slab_rows": args.slab_rows} if args.slab_rows else {}),
        **({"slab_shape_ladder": ladder} if ladder is not None else {}),
        **({"seed_device_min_t": min_t} if min_t is not None else {}),
    )


def main(argv: Optional[list] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    args = build_parser().parse_args(argv)
    if args.help:
        print(USAGE, end="")
        return exitcodes.RC_FATAL  # like the reference's usage()
    try:
        cfg = config_from_args(args)
    except SystemExit as e:
        return int(e.code or 0)
    from ccsx_tpu_torch.pipeline.run import run_pipeline

    return run_pipeline(args.input, args.output, cfg, batch=args.batch,
                        inflight=args.inflight)


if __name__ == "__main__":
    sys.exit(main())
