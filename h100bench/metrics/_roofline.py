"""A kernel's roofline share: the least time the chip could take for the
window's work of that kernel (harness/work.py, counted from the inputs)
over the kernel's summed device time in the window's trace."""

from h100bench.harness import work
from h100bench.harness.trace import base_name

# the profiler's name of each kernel
KERNELS = {"global_fill": "global_fill_kernel",
           "traceback_walk": "walk_kernel",
           "local_fill": "local_fill_kernel"}


def share(obs, kernel: str):
    t = obs.trace
    if not t:
        return None
    secs = sum(v for k, v in t["kernel_s"].items()
               if base_name(k) == KERNELS[kernel])
    if secs <= 0 or not obs.emitted:
        return None
    ops, nbytes = work.counts(obs.manifest, obs.emitted,
                              obs.cfg.refine_iters,
                              obs.cfg.max_passes)[kernel]
    least, _ = work.least_seconds(ops, nbytes)
    if least <= 0:
        return None
    return 100.0 * least / secs
