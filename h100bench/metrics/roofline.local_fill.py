"""Roofline share of csrc/banded_fill.cu local_fill_kernel in the window
(metrics/_roofline.py)."""

from h100bench.metrics import _roofline

LAYER = "kernels"
MOVES = "subread_bases_per_s"
UNIT = "%"


def read(obs):
    return _roofline.share(obs, "local_fill")
