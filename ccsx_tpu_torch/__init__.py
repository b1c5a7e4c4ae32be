"""ccsx_tpu_torch: the PyTorch + CUDA port of ccsx_tpu for NVIDIA Hopper.

The JAX package (ccsx_tpu) is the reference; this package imports none of
it and keeps its own copies of the host modules it needs.  On CUDA tensors
the banded DP fills and the traceback walk run as hand-written kernels
(csrc/); on CPU tensors their plain PyTorch versions run instead.
"""

__version__ = "0.1.0"
