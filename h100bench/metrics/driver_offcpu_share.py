"""Share of the driver thread's host work spent off a CPU: over its
``plan``, ``slab_pack``, ``unpack``, ``hole_step`` and ``emit`` spans,
1 - thread-CPU seconds / wall seconds.  None of them waits on the card or
on the prep plane, so the rest is time the thread was runnable without
the interpreter lock (the prep workers, the harness's sampler) or a core,
or blocked in a write."""

from h100bench.metrics import _spans

LAYER = "host interpreter"
MOVES = "subread_bases_per_s"
UNIT = "%"
HOST_WORK = ("plan", "slab_pack", "unpack", "hole_step", "emit")


def read(obs):
    spans = _spans.driver_spans(obs)
    if spans is None:
        return None
    work = [r for r in spans if r.name in HOST_WORK and r.cpu_s is not None]
    wall = sum(r.end - r.start for r in work)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(r.cpu_s for r in work) / wall)
