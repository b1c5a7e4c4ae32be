"""Overlapped prep plane: a bounded background host-prep pool (a copy of
the JAX package's pipeline/prep_pool.py).

Why: the batched driver's inline path ALTERNATES ingest/prep and device
sweeps on one thread, so host prep time and card time add instead of
overlap.  The reference hides prep entirely inside its 3-stage
read->compute->write pipeline (kthread.c:228-256); this module is that
overlap for the batched scheduler:

* ``PrepPool`` — N worker threads pull ZMWs off the (lock-serialized)
  input stream ahead of the admission window, run each hole's combined
  prep generator (encode + group_lens + the orientation/strand walk,
  consensus/prepare.py) to its FIRST consensus request, and publish the
  prepped hole on a thread-safe ready queue.  The driver's sweep loop
  keeps dispatching device work the whole time; it only blocks on the
  queue when it has nothing dispatchable (that wait is
  ``Metrics.t_prep_blocked`` — the critical-path prep exposure
  ``prep_share`` reads).

* ``_PairGate`` — the walk's pair-alignment requests still batch across
  holes: a worker whose generator yields a PairRequest parks on the
  gate, and one pump thread collects the concurrently-parked requests
  into a single ``PairExecutor.run`` (the same batched device path as
  the inline driver's pair sweep, recovery ladder included).  So the
  pump launches the screen and seed steps and the local fill on the
  card; the driver thread launches the refine steps (global fill and
  walk).  Both use the device's default stream: their work runs in
  order on the card.

Invariants preserved (pinned by tests/test_torch_prep_pool.py):

* Output bytes are IDENTICAL with the pool on or off: pair/refine
  results are batch-composition-invariant by the masked-padding design,
  per-hole prep is deterministic, and ordered emission + the journal's
  flush-before-cursor invariant live unchanged in the driver (the
  writer path does not change).
* A prep-thread exception quarantines exactly that hole (hole.err set,
  generator closed), never the run — the same contract as the inline
  ``_start_hole``.  An INGEST failure (corrupt stream) is re-raised on
  the driver thread so the drivers' existing clean-rc-1 handling fires:
  by ``emit_ok``, at a point in the emission order that the threads'
  timing cannot move (the holes written before a given stream error are
  the same in every run; the JAX package's pool raises it at the first
  ``poll``/``get`` that finds nothing prepped, which depends on how far
  prep got).
* A fault of the card or a kernel (``cuda_ext.is_device_fault``) is not
  one hole's: the pump or the worker that meets it keeps it aside as a
  ``cuda_ext.KernelError``, and the driver thread re-raises it at its
  next ``poll``/``get`` — rc 1, "device failure, run aborted", no hole
  quarantined and nothing replayed, as on the inline path.
* Backpressure: at most ``max_outstanding`` holes are ingested but not
  yet retired (the driver releases one permit per emitted hole).  The
  COUNT bound matches the inline loop's ``next_idx - next_emit <
  4 x inflight``, but the pool preps ahead, so up to that many holes
  can hold full prep state (generator + encoded passes) where inline
  held only ~window prepped holes plus instantly-done parked ones —
  bounded, but a deliberately higher steady-state RSS than inline;
  shrink ``--inflight``/``zmw_microbatch`` if it ever matters.

``--prep-threads 0`` disables the pool entirely (the inline A/B
control); the default (None) auto-sizes to the host.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import List, Optional

from ccsx_tpu_torch.consensus import prepare as prep_mod
from ccsx_tpu_torch.ops import cuda_ext
from ccsx_tpu_torch.utils import faultinject
from ccsx_tpu_torch.utils import trace


def resolve_prep_threads(cfg) -> int:
    """cfg.prep_threads -> worker count: explicit N pins (0 = inline),
    None auto-sizes — half the cores, capped small: prep is
    Python/NumPy host work that competes with the dispatch stream and
    the warmup compiler for cores, and a few workers already cover the
    admission burst."""
    pt = getattr(cfg, "prep_threads", None)
    if pt is None:
        return min(4, max(1, (os.cpu_count() or 2) // 2))
    return max(0, int(pt))


class _PairGate:
    """Batches pair alignments across concurrently-prepping holes.

    Workers call ``align(req)`` and block; the single pump thread
    drains every parked request into one ``PairExecutor.run`` (host
    seeding + batched banded fill + the shared recovery ladder) and
    delivers results.  A result that is an Exception (the executor's
    host replay failed for that pair) quarantines the CALLING hole —
    exactly what the inline driver's ``_feed_hole`` does.  A device fault
    goes to ``on_fatal`` (the pool keeps it for the driver thread) and
    answers every later request without touching the card."""

    # short accumulation window after the first request arrives: the
    # other walkers' requests of the same instant join the batch, while
    # a lone walker is delayed by ~nothing against the DP it waits for
    linger_s = 0.002

    def __init__(self, pair_executor, metrics, on_fatal):
        self._pe = pair_executor
        self._metrics = metrics
        self._on_fatal = on_fatal
        self._fatal: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._pending: List[list] = []   # [req, Event, result]
        self._stop = False
        # faultinject.inherit: the pump must stay inside the spawning
        # job's fault scope (serve runs many jobs in one process)
        self._thread = threading.Thread(
            target=faultinject.inherit(self._pump), daemon=True,
            name="ccsx-prep-pairs")
        self._thread.start()

    def align(self, req):
        slot = [req, threading.Event(), None]
        with self._cv:
            if self._stop:
                return RuntimeError("prep pool closed")
            self._pending.append(slot)
            self._cv.notify()
        slot[1].wait()
        return slot[2]

    def _pump(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._stop:
                    self._cv.wait()
                if not self._pending and self._stop:
                    return
            time.sleep(self.linger_s)
            with self._cv:
                batch, self._pending = self._pending, []
            try:
                if self._fatal is not None:
                    raise self._fatal
                with self._metrics.timer("prep"), \
                        trace.span("pair_sweep", cat="prep",
                                   n=len(batch)):
                    results = self._pe.run([s[0] for s in batch])
            except Exception as e:
                # PairExecutor.run owns the per-pair recovery ladder;
                # anything escaping it is delivered per caller so each
                # hole quarantines instead of the pump dying silently —
                # but a fault of the card or a kernel ends the run: it is
                # kept for the driver thread before any caller wakes
                if self._fatal is None and cuda_ext.is_device_fault(e):
                    self._fatal = self._on_fatal(e)
                results = [e] * len(batch)
            for slot, r in zip(batch, results):
                slot[2] = r
                slot[1].set()

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        with self._cv:
            stragglers, self._pending = self._pending, []
        for slot in stragglers:
            slot[2] = RuntimeError("prep pool closed")
            slot[1].set()


class PrepPool:
    """The background ingest+prep pool feeding the batched driver."""

    def __init__(self, stream, cfg, pair_executor, metrics,
                 threads: int, max_outstanding: int, resume: int = 0,
                 hole_factory=None, finish=None):
        # _Hole/_finish are injected by the driver (pipeline/batch.py)
        # to avoid a circular import; they are the SAME objects the
        # inline path uses, so a prepped hole is indistinguishable
        # downstream.
        from ccsx_tpu_torch.pipeline import batch as batch_mod

        self._stream = stream
        self._cfg = cfg
        self._metrics = metrics
        self._resume = int(resume)
        self._hole = hole_factory or batch_mod._Hole
        self._finish = finish or batch_mod._finish
        self._gate = _PairGate(pair_executor, metrics, self._keep_fatal)
        self._cv = threading.Condition()
        self._ready: List[object] = []
        self._budget = threading.Semaphore(max(1, int(max_outstanding)))
        self._ingest_lock = threading.Lock()
        self._next_idx = 0
        self._outstanding = 0        # ingested, not yet handed to driver
        self._exhausted = False      # stream EOF (or ingest error) seen
        self._ingest_error: Optional[BaseException] = None
        self._error_at = 0           # holes ingested before the error
        self._fatal: Optional[cuda_ext.KernelError] = None
        self._stop = False
        metrics.prep_threads = max(1, int(threads))
        # workers run inside the spawning job's fault scope (see pump)
        self._threads = [
            threading.Thread(target=faultinject.inherit(self._work),
                             daemon=True, name=f"ccsx-prep-{i}")
            for i in range(max(1, int(threads)))]
        for t in self._threads:
            t.start()

    # ---- worker side -----------------------------------------------------

    def _acquire_budget(self) -> bool:
        while not self._stop:
            if self._budget.acquire(timeout=0.2):
                if self._stop:
                    self._budget.release()
                    return False
                return True
        return False

    def _work(self) -> None:
        while True:
            if not self._acquire_budget():
                return
            h = self._ingest_one()
            if h is None:
                self._budget.release()
                return
            if not h.done:
                self._prep(h)
            self._publish(h)

    def _ingest_one(self):
        """One hole off the shared stream (serialized; stream iterators
        are not thread-safe), with the same ingest accounting, fault
        point, and resume-skip logic as the inline admission loop."""
        with self._ingest_lock:
            if self._stop or self._exhausted:
                return None
            m = self._metrics
            try:
                with m.timer("ingest"), \
                        trace.span("ingest_hole", cat="ingest"):
                    z = next(self._stream)
                    faultinject.fire("ingest")
            except StopIteration:
                self._set_exhausted()
                return None
            except Exception as e:
                # surfaced to the driver thread by emit_ok, so the
                # drivers' invalid-input rc-1 handling stays theirs; set
                # before the exhausted flag, which emit_ok reads first
                self._error_at = self._next_idx
                self._ingest_error = e
                self._set_exhausted()
                return None
            m.holes_in += 1          # serialized by _ingest_lock
            h = self._hole(idx=self._next_idx, zmw=z)
            self._next_idx += 1
            if m.holes_in <= self._resume:
                h.done = h.resumed = True
            with self._cv:
                self._outstanding += 1
            return h

    def _set_exhausted(self) -> None:
        self._exhausted = True
        with self._cv:
            self._cv.notify_all()

    def _prep(self, h) -> None:
        """Run one hole's combined prep generator to its first
        consensus request — the off-thread twin of the inline
        ``_start_hole`` + pair-sweep loop.  Pair waits are excluded
        from t_prep (the pump books its own prep seconds) and recorded
        on the span for honesty."""
        from ccsx_tpu_torch.consensus.hole import full_gen_for_zmw

        t0 = time.perf_counter()
        wait_s = 0.0
        try:
            with trace.span("prep_hole", cat="prep",
                            hole=str(h.zmw.hole)) as sp:
                faultinject.fire("compute")
                h.gen = full_gen_for_zmw(h.zmw, self._cfg)
                req = next(h.gen)
                while isinstance(req, (prep_mod.PairRequest,
                                       prep_mod.PairBatch)):
                    w0 = time.perf_counter()
                    res = self._gate.align(req)
                    wait_s += time.perf_counter() - w0
                    if isinstance(res, list):
                        # PairBatch result: its first embedded failure
                        # quarantines, like a scalar one below
                        exc = next((r for r in res
                                    if isinstance(r, Exception)), None)
                        if exc is not None:
                            res = exc
                    if isinstance(res, Exception):
                        # the executor's last-resort host replay failed
                        # for this pair: quarantine this hole (same as
                        # the inline _feed_hole contract)
                        raise res
                    req = h.gen.send(res)
                h.req = req
                if wait_s and sp is not None and hasattr(sp, "args"):
                    sp.args = dict(sp.args, pair_wait=round(wait_s, 6))
        except StopIteration as e:
            # skipped (<3 passes -> None) or consensus without device work
            h.done, h.cns = True, self._finish(e.value)
        except Exception as e:   # quarantine: one bad hole, not the run
            if cuda_ext.is_device_fault(e):
                # not this hole's fault: the driver re-raises it before
                # it takes this hole (the fault is kept before publish)
                self._keep_fatal(e)
            h.done, h.req, h.err = True, None, e
            if h.gen is not None:
                try:
                    h.gen.close()
                except Exception:
                    pass
        finally:
            self._metrics.add_stage(
                "prep", max(time.perf_counter() - t0 - wait_s, 0.0))

    def _publish(self, h) -> None:
        with self._cv:
            self._ready.append(h)
            d = len(self._ready)
            self._metrics.prep_queue_depth = d
            if d > self._metrics.prep_queue_peak:
                self._metrics.prep_queue_peak = d
            self._cv.notify_all()

    def _keep_fatal(self, e: BaseException) -> cuda_ext.KernelError:
        """Keep a device fault (the first) for the driver thread, as a
        ``cuda_ext.KernelError``, and wake a blocked ``get``."""
        with self._cv:
            if self._fatal is None:
                if isinstance(e, cuda_ext.KernelError):
                    self._fatal = e
                else:
                    self._fatal = cuda_ext.KernelError(str(e))
                    self._fatal.__cause__ = e
            self._cv.notify_all()
            return self._fatal

    # ---- driver side -----------------------------------------------------

    def _raise_fatal_locked(self) -> None:
        if self._fatal is not None:
            raise self._fatal

    def _take_locked(self):
        h = self._ready.pop(0)
        self._outstanding -= 1   # the driver owns it from here
        self._metrics.prep_queue_depth = len(self._ready)
        return h

    def poll(self):
        """Next prepped hole without blocking, or None."""
        with self._cv:
            self._raise_fatal_locked()
            if self._ready:
                return self._take_locked()
        return None

    def get(self, timeout: float = 1.0):
        """Next prepped hole, blocking up to ``timeout`` — the driver's
        nothing-dispatchable wait (timed by the caller into
        t_prep_blocked)."""
        with self._cv:
            self._cv.wait_for(
                lambda: (self._ready or self.drained()
                         or self._fatal is not None), timeout=timeout)
            self._raise_fatal_locked()
            if self._ready:
                return self._take_locked()
        return None

    def emit_ok(self, idx: int, lead: int) -> bool:
        """May the driver write hole ``idx`` now?  Only once the stream
        has been read ``lead`` holes past it, or to its clean end; a
        stream error within ``lead`` holes of it is raised here instead.
        So the holes a stream error leaves written are those more than
        ``lead`` before it, whatever the threads' timing (the inline
        driver, which admits a window before it sweeps, writes none of
        the first window's holes either)."""
        ended = self._exhausted   # read first: the error is set before it
        err = self._ingest_error
        if err is not None and idx + lead >= self._error_at:
            raise err
        return self._next_idx > idx + lead or (ended and err is None)

    def drained(self) -> bool:
        """True once no hole will ever be published again."""
        return (self._exhausted and self._outstanding == 0
                and not self._ready)

    def release(self, n: int = 1) -> None:
        """The driver retired (emitted) ``n`` holes: free that much
        ingest-ahead budget.  The budget spans ingest to EMISSION, so
        it is the pool-mode form of the inline loop's
        ``next_idx - next_emit < 4 x inflight`` memory bound."""
        for _ in range(n):
            self._budget.release()

    def close(self) -> None:
        """Stop workers + the pair pump.  Idempotent; driver-finally
        safe.  Queued-but-untaken holes are dropped (the run is ending
        — either complete, in which case none exist, or failing, in
        which case the driver's rc already says so)."""
        self._stop = True
        with self._cv:
            self._cv.notify_all()
        self._gate.close()
        for t in self._threads:
            t.join(timeout=10.0)
        alive = [t.name for t in self._threads if t.is_alive()]
        if alive:
            print(f"[ccsx-tpu-torch] prep pool: threads still alive at "
                  f"close: {alive}", file=sys.stderr)
