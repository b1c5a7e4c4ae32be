"""ccsx-compatible CLI of the PyTorch/CUDA port.

Same conventions as the JAX package's CLI and the reference's getopt loop:
positional INPUT OUTPUT with '-' for stdin/stdout, -A for FASTA/Q input,
-P for whole-read mode, -X hole exclusion, -c >= 3 enforced.  The run goes
to the card; ``--device cpu`` runs the plain PyTorch versions instead.
``--batch auto`` (the default) selects the batched packed driver on the
card and the per-hole driver on the CPU, as the JAX package does for an
accelerator and for its CPU backend.

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
    return p


def config_from_args(args) -> CcsConfig:
    if args.min_count < 3:
        print(f"Error! min fulllen count=[{args.min_count}] (>=3) !",
              file=sys.stderr)
        raise SystemExit(-1)
    exclude = None
    if args.exclude:
        exclude = frozenset(x for x in args.exclude.split(",") if x)
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
