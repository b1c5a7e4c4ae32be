"""Per-shape refine programs: the port's counterpart of the executable cache
that ``jax.jit`` keeps for the JAX package's refine steps.

The JAX package runs a slab's whole refine loop as one compiled program per
canonical shape (a device ``while_loop``), dispatched once.  Here a program
is a CUDA graph of the step at one shape: the ``iters + 1`` rounds of the
device-only refine loop (pipeline/batch._refine_loop), the breakpoint scan
and the output packing, captured once and replayed for every slab of that
shape, so a dispatch costs a copy in, one graph launch and a copy out
instead of some forty torch op launches a round.

``dispatch`` is the driver's entry.  The first ``CAPTURE_AT - 1``
dispatches of a shape run the step eagerly (a capture costs about as much
host time as an eager run, so a shape that is dispatched once is not
worth one); the next builds the shape's program from the same step object,
and every later one replays it.  The eager runs double as the priming a
capture needs (the torch ops' lazy module loads, the walk's one-time
shared-memory attribute, the closure's lazily made constants), so such a
build captures without a priming run of its own.  ``program`` builds ahead
of any dispatch (the warmup plane, pipeline/warmup.py) and then primes.

A program owns static input buffers (the step's wire buffers), one static
output, and, on the card, the graph.  Its life:

* build, once per key, one build at a time in the process: the priming
  run (when asked for) on the all-zero inputs, then the capture, both on
  the lane's one capture stream, in thread-local capture mode, so that
  other threads (the driver, the prep pool's pump) go on launching on the
  default stream while a warmup thread captures.  A lane is a logical
  device of a mesh (parallel/mesh.py; lane 0 without one), and every
  program of a lane captures into ONE shared memory pool: a replay's
  intermediates are dead when it ends, and each program's static output
  stays allocated for its life, but a program captured later may hold its
  static output where an earlier one keeps intermediates (and the
  reverse), so a replay of one program clobbers the other's output.  Every
  replay therefore runs on its caller's stream (for lane 0 the device's
  default stream, on the driver and the warmup thread; under a mesh the
  entry's own stream) with its clone of the static output, under one lock
  of the process: no replay of another program, from any thread, comes
  between a replay and its clone.  Two lanes on one card replay on two
  streams at once, so they never share a pool;
* ``run``: copy the caller's host buffers into the static inputs, replay,
  and clone the static output, all on the caller's current stream and
  under the program's lock, so two slabs of one shape in flight never see
  each other's buffers (the second copy-in is ordered after the first
  clone);
* ``warm``: the same with all-zero inputs, waited for (the warmup plane's
  replay).

On the CPU a program runs the eager step (the early-exit loop) through the
same static buffers and static output, and ``dispatch`` follows the same
rule, so the CPU tests hold the protocol.

Programs live as long as the process, as jit's executables do, until
``clear()``, which the driver calls after a device out-of-memory error
before it splits the slab: every program, the shared pool and the
allocator's cached memory go.  Under the serving plane one job's OOM clears
every job's programs, so ``clear`` takes the replay lock and waits for the
card before it drops anything: no replay of another thread's is between
its replay and its clone then, and none is still running on the card when
its graph goes.  A program a thread already holds stays whole until that
thread lets go of it.  A key holds everything the step's closure
depends on (the shape, the arm, the run's scores and constants, the device
and the step's factory), so runs of other configurations never share a
program.

Launch counts (ops/cuda_ext.LAUNCHES): a replay calls no wrapper, so each
program keeps the launches its capture recorded and adds them to
``cuda_ext.LAUNCHES`` at every ``run``.  The priming run and the warm
replays are build work: their launches are kept apart, in ``stats()``.  An
eager dispatch's launches count as they happen, and ``stats()`` keeps a
copy.  ``stats()`` is for the process; a served job's own eager dispatches
and replays go to its ``cuda_ext.scope()`` as well.

A build, capture or replay that raises raises ``cuda_ext.KernelError`` (the
run ends; the step is never rerun eagerly), except an out-of-memory error,
which stays one so that the driver's resplit ladder takes it.  A build
runs on all-zero inputs, so its failure is never the data's.  An eager
dispatch, and on the CPU ``run``'s eager step, may raise on a slab's own
data: that error is left as it is, for the driver's per-request replay.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, Sequence, Tuple

import torch

from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.utils import trace

# The dispatch of a shape that builds its program; those before it run the
# step eagerly.  2: a shape's first slab runs eagerly, its second captures
# (PERF.md §6: cold CLI processes on the card with 1, 2 and no capture).
CAPTURE_AT = 2

_programs: Dict[tuple, "Program"] = {}
# key -> [its step, dispatches taken, eager dispatches completed]
_eager: Dict[tuple, list] = {}
# (card index, lane) -> its programs' shared pool, and its capture stream
_pools: Dict[tuple, tuple] = {}
_streams: Dict[tuple, "torch.cuda.Stream"] = {}
_lock = threading.Lock()          # the cache and the stats
_build_lock = threading.Lock()    # one build (and capture) at a time
# a graph replay and the clone of its static output, one pair at a time
_replay_lock = threading.Lock()
_stats: Dict[tuple, dict] = {}


def _stat(key, p: "Program" = None) -> dict:
    """The stats of ``key`` (created with its program's, if built)."""
    st = _stats.get(key)
    if st is None:
        st = _stats[key] = {"builds": 0, "graph": False, "eager": 0,
                            "replays": 0, "warm_replays": 0,
                            "build_s": 0.0, "launches": {},
                            "eager_launches": {}, "prime_launches": {},
                            "build_parts": {}}
    if p is not None:
        st["graph"] = p.graph is not None
        st["launches"] = dict(p.launches)
    return st


class Program:
    """One step at one shape (see the module docstring).  ``step(*inputs)``
    returns one tensor; ``specs`` are the inputs' (shape, dtype);
    ``prime``: run the step once on the zero inputs before the capture
    (False when eager dispatches of the same step object already did);
    ``lane``: the logical device whose pool and capture stream it uses."""

    def __init__(self, key, step: Callable, specs: Sequence[Tuple],
                 device, prime: bool = True, lane: int = 0):
        self.key = key
        self.lane = lane
        self.device = torch.device(device)
        self.step = step
        self.inputs = [torch.zeros(shape, dtype=dtype, device=self.device)
                       for shape, dtype in specs]
        self.out = None
        self.graph = None
        self.launches: Dict[str, int] = {}      # one replay's
        self.prime_launches: Dict[str, int] = {}
        # host seconds of the build's parts (on the card)
        self.build_parts: Dict[str, float] = {}
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            # a shape built inside a measured window shows by name
            with trace.span("graph_capture", cat="compute"):
                self._capture(prime)
        elif prime:
            self.out = self.step(*self.inputs)

    def _capture(self, prime: bool) -> None:
        dev = self.device
        card = (dev.index if dev.index is not None else
                torch.cuda.current_device(), self.lane)
        side = _streams.get(card)
        if side is None:
            side = _streams[card] = torch.cuda.Stream(dev)
        pool = _pools.get(card)
        if pool is None:
            pool = _pools[card] = torch.cuda.graph_pool_handle()
        side.wait_stream(torch.cuda.current_stream(dev))
        t = [time.perf_counter()]
        if prime:
            with torch.cuda.stream(side):
                with cuda_ext.tally() as primed:
                    self.step(*self.inputs)
            self.prime_launches = {k: v for k, v in primed.items() if v}
        t.append(time.perf_counter())
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), cuda_ext.tally() as rec:
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self.step(*self.inputs)
                except BaseException:
                    # end the capture, or the side stream stays in it
                    with contextlib.suppress(Exception):
                        graph.capture_end()
                    raise
                t.append(time.perf_counter())
                graph.capture_end()      # and instantiate
            t.append(time.perf_counter())
            if prime:
                side.synchronize()       # the priming run's device work
            t.append(time.perf_counter())
        except torch.cuda.OutOfMemoryError:
            raise
        except Exception as e:
            raise cuda_ext.KernelError(
                f"refine program {self.key[:7]}: the CUDA graph capture "
                f"raised {type(e).__name__}: {e}") from e
        self.out = out
        self.graph = graph
        self.launches = {k: v for k, v in rec.items() if v}
        self.build_parts = dict(zip(("prime_s", "capture_s", "end_s",
                                     "wait_s"), (b - a for a, b in
                                                 zip(t, t[1:]))))

    def _replay(self, warm: bool) -> torch.Tensor:
        """One run of the step on the static inputs; the clone of the
        static output.  Holds the program's lock (the caller's)."""
        if self.graph is None:
            res = self.step(*self.inputs)
            if self.out is None:
                self.out = torch.empty_like(res)
            self.out.copy_(res)
            out = self.out.clone()
        else:
            try:
                with _replay_lock:
                    self.graph.replay()
                    out = self.out.clone()
            except torch.cuda.OutOfMemoryError:
                raise
            except Exception as e:
                raise cuda_ext.KernelError(
                    f"refine program {self.key[:7]}: the replay raised "
                    f"{type(e).__name__}: {e}") from e
            if not warm:
                cuda_ext.add(self.launches)
        if not warm:
            cuda_ext.scoped("graph_replays")
        with _lock:
            _stat(self.key, self)["warm_replays" if warm else "replays"] += 1
        return out

    def run(self, *host: torch.Tensor) -> torch.Tensor:
        """The step on ``host`` (tensors of the inputs' shapes and dtypes;
        pinned host tensors copy without blocking): a fresh output
        tensor on the program's device, ordered on the current stream."""
        with self._lock:
            for buf, x in zip(self.inputs, host):
                buf.copy_(x, non_blocking=True)
            return self._replay(warm=False)

    def warm(self) -> None:
        """One replay on all-zero inputs, waited for (the warmup plane's:
        its launches are not the main path's)."""
        with self._lock:
            for buf in self.inputs:
                buf.zero_()
            self._replay(warm=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()


def program(key, make_step: Callable[[], Callable], specs: Sequence[Tuple],
            device, prime: bool = True, lane: int = 0) -> Program:
    """The cached program of ``key``, built on first request from
    ``make_step()``; one build at a time in the process, each key once.
    ``key`` must hold everything the step's closure depends on, the lane
    included."""
    with _lock:
        p = _programs.get(key)
    if p is not None:
        return p
    with _build_lock:
        with _lock:
            p = _programs.get(key)
        if p is not None:
            return p
        t0 = time.perf_counter()
        try:
            p = Program(key, make_step(), specs, device, prime, lane)
        except (cuda_ext.KernelError, torch.cuda.OutOfMemoryError):
            raise
        except Exception as e:
            raise cuda_ext.KernelError(
                f"refine program {key[:7]}: the build raised "
                f"{type(e).__name__}: {e}") from e
        with _lock:
            _programs[key] = p
            _eager.pop(key, None)
            st = _stat(key, p)
            st["builds"] += 1
            st["build_s"] += time.perf_counter() - t0
            st["prime_launches"] = dict(p.prime_launches)
            st["build_parts"] = dict(p.build_parts)
    return p


def dispatch(key, make_step: Callable[[], Callable], specs: Sequence[Tuple],
             device, *host: torch.Tensor, lane: int = 0) -> torch.Tensor:
    """The step of ``key`` on ``host`` (as Program.run): an eager run for
    the shape's first ``CAPTURE_AT - 1`` dispatches, then its program,
    built at the next from the step those eager runs used, in ``lane``."""
    with _lock:
        p = _programs.get(key)
        seen = _eager.get(key) if p is None else None
    if p is None:
        if seen is None:
            step = make_step()
            with _lock:
                seen = _eager.setdefault(key, [step, 0, 0])
        with _lock:
            # this dispatch's ordinal, taken before it runs: two threads
            # dispatching one shape at once (two served jobs) never both
            # run eagerly where only one may
            n = seen[1]
            seen[1] += 1
        if n + 1 < CAPTURE_AT:
            return _run_eager(key, seen, device, host)
        # no priming where an eager run of this step came first
        p = program(key, lambda: seen[0], specs, device, prime=not seen[2],
                    lane=lane)
    return p.run(*host)


def _run_eager(key, seen: list, device, host) -> torch.Tensor:
    """One eager dispatch: its launches count (in LAUNCHES and the key's
    stats) even when the step raises part way."""
    dev = torch.device(device)
    ok = False
    try:
        with cuda_ext.tally() as t:
            out = seen[0](*(h.to(dev, non_blocking=True) for h in host))
        ok = True
    finally:
        cuda_ext.add(t)
        with _lock:
            st = _stat(key)
            for name, n in t.items():
                if n:
                    st["eager_launches"][name] = \
                        st["eager_launches"].get(name, 0) + n
            if not ok:
                seen[1] -= 1     # a failed run leaves its ordinal free
    with _lock:
        seen[2] += 1
        st["eager"] += 1
    cuda_ext.scoped("eager_dispatches")
    return out


def config_key(cfg, device) -> tuple:
    """What a refine step's closure takes from the run's configuration
    beyond its shape key: the scores, max_ins, the breakpoint constants
    and the device."""
    return (dataclasses.astuple(cfg.align), cfg.max_ins_per_col,
            cfg.bp_window, cfg.bp_minwin, cfg.bp_rowrate, cfg.bp_colrate,
            cfg.bp_colrate_lowpass, str(torch.device(device)))


def stats() -> Dict[tuple, dict]:
    """Per key since the last reset_stats(): builds, whether the program
    is a graph, eager dispatches, replays and warm replays, build seconds
    (and their parts on the card: the priming run's issue, the capture's,
    the end of the capture with the graph's instantiation, the wait for
    the priming run), one replay's launches, the eager dispatches' and the
    priming run's."""
    with _lock:
        return {k: {**v, "launches": dict(v["launches"]),
                    "eager_launches": dict(v["eager_launches"]),
                    "prime_launches": dict(v["prime_launches"]),
                    "build_parts": dict(v["build_parts"])}
                for k, v in _stats.items()}


def reset_stats() -> None:
    with _lock:
        _stats.clear()


def clear() -> None:
    """Drop every program, the eager counts and the shared pools, and hand
    the card's cached memory back (a program's graph and its share of the
    pool go with the last reference to it).  No build runs meanwhile, and no
    replay: every replay already made has run on the card, clone included,
    before anything is dropped."""
    cuda = torch.cuda.is_initialized()
    with _build_lock:
        with _replay_lock, _lock:
            if cuda:
                torch.cuda.synchronize()
            _programs.clear()
            _eager.clear()
            _pools.clear()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


def pool_bytes() -> int:
    """Bytes of the card's memory reserved by the programs' shared pools
    (the allocator's segments of those pools)."""
    with _lock:
        pools = {tuple(p) for p in _pools.values()}
    if not pools:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) in pools)


def totals() -> dict:
    """``stats()`` summed over its keys — builds, eager dispatches,
    replays, warm replays and build seconds — with the shared pools' bytes
    on the card: the serving plane's cumulative counts
    (pipeline/serve.ServeMetrics)."""
    st = stats()
    out = {k: sum(v[k] for v in st.values())
           for k in ("builds", "eager", "replays", "warm_replays",
                     "build_s")}
    out["pool_bytes"] = pool_bytes() if torch.cuda.is_initialized() else 0
    return out
