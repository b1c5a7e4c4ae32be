"""The plain reference of the consensus that the benchmark holds the port to.

It works out a hole's consensus record from the hole's subreads, in plain
PyTorch (the banded fills) and NumPy (everything else), with the
algorithm's published rules (the reference ccsx's ``main.c``, restated in
the port's ``config.py``):

* the read filters (``filters.keep``);
* the strand walk: length groups, template group, the outward walk with its
  pair checks by k-mer seed and banded local fill (``prepare``, ``seed``,
  ``fill.local``);
* the windowed consensus: windows, the refine rounds of global fill,
  traceback walk, column vote and materialisation, and the breakpoint scan
  (``windowed``, ``fill.global_moves``, ``walk``, ``vote``);
* ``driver`` runs many holes' walks and windows in lock step, so that one
  fill serves every hole's problems at once.

It imports nothing of the port or of JAX: it is a frozen restatement of the
semantics, with no kernels, no packing, no programs and no pipeline.
"""
