"""Device mesh construction and the sharded consensus step.

The reference's only parallelism is host threads over independent ZMWs
(kt_for, kthread.c:34-65).  The JAX package shards two axes, and so does
the port:

  data axis — ZMW batches (each hole independent: pure data parallelism,
      no cross-device traffic in the hot loop);
  pass axis — MSA rows (passes) of each hole: each device aligns its rows
      against the shared draft and the column vote's counts are summed
      over the pass axis.

A mesh here is an array of logical devices (``Entry``): a torch device, its
index in the mesh's list, and on the card a CUDA stream of its own.  One
card may appear several times in the list (``devices=[cuda:0] * 8``): each
entry is then its own queue of work on the shared card, the way the JAX
package's tests run eight virtual devices on one CPU.  Work of an entry
runs inside ``scope(entry)`` (its stream current, its launches booked to
``cuda_ext.LANE_LAUNCHES[index]``); a tensor crosses from one entry to
another through ``send``, which orders the receiver's stream after the
sender's and, between two cards, copies.

``make_sharded_round`` is the explicit reference formulation (the JAX
package's shard_map round): each (data, pass) entry fills and walks its
block, the pass entries' int32 vote counts are summed onto the data shard's
first entry, and the argmax is taken there.  Integer sums are exact in any
order, so all five outputs equal the unsharded per-hole round bit for bit
(tests/test_torch_mesh.py).  The batched executor (pipeline/batch.py) runs
its refine loop over the same layout under --mesh D,P, and its fused
packed dispatch over ``build_slab_mesh``'s 1-D list.

The JAX package's ``shard_map_compat`` exists only for JAX's API split and
has no counterpart here.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ccsx_tpu_torch.config import AlignParams
from ccsx_tpu_torch.consensus.star import global_fill
from ccsx_tpu_torch.ops import cuda_ext, msa, traceback


@dataclasses.dataclass(eq=False)
class Entry:
    """One logical device: ``device``, its ``index`` in the mesh's device
    list, and on the card its own ``stream`` (None on the CPU)."""
    device: torch.device
    index: int
    stream: Optional["torch.cuda.Stream"] = None


def make_entries(devices: Sequence) -> List[Entry]:
    """One Entry per listed device, each card entry with a fresh stream."""
    out = []
    for i, d in enumerate(devices):
        d = torch.device(d)
        s = torch.cuda.Stream(d) if d.type == "cuda" else None
        out.append(Entry(d, i, s))
    return out


@dataclasses.dataclass(eq=False)
class Mesh:
    """``entries``: an object array of Entry of shape ``shape``, named
    ``axis_names``; ``devices`` the same array of their torch devices."""
    entries: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> tuple:
        return tuple(self.entries.shape)

    @property
    def devices(self) -> np.ndarray:
        return np.vectorize(lambda e: e.device, otypes=[object])(
            self.entries)

    @property
    def flat(self) -> List[Entry]:
        return list(self.entries.reshape(-1))


def build_slab_mesh(devices) -> Mesh:
    """A 1-D ('slab',) mesh over the given devices: the fused packed
    dispatch runs one slab of a wave on each entry."""
    ents = np.empty(len(devices), object)
    ents[:] = make_entries(devices)
    return Mesh(ents, ("slab",))


def build_mesh(shape: Optional[Tuple[int, ...]] = None,
               axis_names: Tuple[str, ...] = ("data", "pass"),
               devices=None) -> Mesh:
    """A (data, pass) mesh over ``devices`` (default: the card's local
    devices, utils/device.local_devices).

    Default split: the pass axis gets 2 devices when there are >= 4 devices
    and their number is even, otherwise 1 (pure data parallelism)."""
    if devices is None:
        from ccsx_tpu_torch.utils import device as device_mod

        devices = device_mod.local_devices("cuda")
    n = len(devices)
    if shape is None:
        p = 2 if n >= 4 and n % 2 == 0 else 1
        shape = (n // p, p)
    ents = np.empty(n, object)
    ents[:] = make_entries(devices)
    return Mesh(ents.reshape(shape), tuple(axis_names))


# ---- work on an entry and between entries ---------------------------------

@contextlib.contextmanager
def scope(entry: Entry):
    """Run the body as ``entry``'s work: its stream current (on the card)
    and its launches booked to its lane."""
    with cuda_ext.lane(entry.index):
        if entry.stream is None:
            yield
        else:
            with torch.cuda.stream(entry.stream):
                yield


def send(x: torch.Tensor, src: Entry, dst: Entry) -> torch.Tensor:
    """``x`` (made on ``src``'s stream) for use on ``dst``'s: the same
    tensor when both are one queue or on the CPU; on one card, the same
    memory, with ``dst``'s stream ordered after ``src``'s and the memory
    kept alive for it; between cards, a copy on ``dst``'s stream."""
    if src is dst or src.stream is None:
        return x
    ev = torch.cuda.Event()
    ev.record(src.stream)
    dst.stream.wait_event(ev)
    if src.device == dst.device:
        x.record_stream(dst.stream)
        return x
    with torch.cuda.stream(dst.stream):
        return x.to(dst.device, non_blocking=True)


def put(host: torch.Tensor, entry: Entry) -> torch.Tensor:
    """A host tensor on ``entry``'s device, copied on its stream (without
    blocking when ``host`` is pinned)."""
    with scope(entry):
        return host.to(entry.device, non_blocking=True)


class Placed:
    """A step's outputs on several entries: ``parts[i]`` was made on
    ``entries[i]``'s stream.  ``read`` brings each to the host on its own
    stream (so it waits for exactly that entry's work) and joins them with
    ``join`` (np.stack for a fused wave's slabs, np.concatenate for a
    mesh's data shards); ``synchronize`` waits for every entry's stream."""

    def __init__(self, parts: Sequence[torch.Tensor],
                 entries: Sequence[Entry], join: Callable = np.stack):
        self.parts = list(parts)
        self.entries = list(entries)
        self.join = join

    @property
    def shape(self) -> tuple:
        first = tuple(self.parts[0].shape)
        if self.join is np.stack:
            return (len(self.parts),) + first
        return (sum(p.shape[0] for p in self.parts),) + first[1:]

    def synchronize(self) -> None:
        for e in self.entries:
            if e.stream is not None:
                e.stream.synchronize()

    def read(self) -> np.ndarray:
        out = []
        for p, e in zip(self.parts, self.entries):
            with scope(e):
                out.append(p.cpu().numpy())
        return self.join(out)


# ---- the sharded round ------------------------------------------------------

def block_rows(fill, qs, qlens, draft, dlen, tmax: int, max_ins: int):
    """Fill and walk a (Z, P) block of passes against its holes' (Z, tmax)
    drafts: (aligned (Z, P, tmax), ins_cnt (Z, P, tmax), ins_b (Z, P, tmax,
    max_ins), lead_ins (Z, P)).  The drafts are gathered per row into a
    contiguous (Z·P, tmax) tensor (the kernels take one row stride), so the
    block is one fill and one walk launch."""
    Z, P, qmax = qs.shape
    hole = torch.arange(Z, device=qs.device)[:, None].expand(
        Z, P).reshape(-1)                       # each hole P times
    ts_r = draft.index_select(0, hole)          # (Z·P, tmax)
    tl_r = dlen.to(torch.int32).index_select(0, hole)
    q_r = qs.reshape(Z * P, qmax).contiguous()
    ql_r = qlens.reshape(Z * P).to(torch.int32).contiguous()
    _, moves, offs = fill(q_r, ql_r, ts_r, tl_r)
    aligned, ins_cnt, ins_b, lead_ins = traceback.project(
        moves, offs, q_r, ql_r, tl_r, tmax, max_ins)
    return (aligned.view(Z, P, tmax), ins_cnt.view(Z, P, tmax),
            ins_b.view(Z, P, tmax, max_ins), lead_ins.view(Z, P))


def shard_round(shard: Sequence[Entry], blocks, draft, dlen, fill,
                tmax: int, max_ins: int):
    """One star round of one data shard over its pass entries ``shard``
    (``shard[0]`` leads and holds the shard's (Zd, tmax) ``draft`` and
    ``dlen``); ``blocks[k]`` = (qs, qlens, row_mask) of entry k's passes,
    on its device.  Each entry fills, walks and counts its rows; the counts
    are summed on the lead, which takes the argmax.  Returns the hole
    outputs (cons, ins_base, ins_votes, ncov, nwin) on the lead and, per
    entry, its rows' (match, aligned, ins_cnt, lead_ins) on its own
    device."""
    lead = shard[0]
    counts = None
    rows = []
    for e, (qs, qlens, row_mask) in zip(shard, blocks):
        with scope(e):
            aligned, ins_cnt, ins_b, lead_ins = block_rows(
                fill, qs, qlens, send(draft, lead, e), send(dlen, lead, e),
                tmax, max_ins)
            c = msa.vote_counts(aligned, ins_cnt, ins_b, row_mask, max_ins)
        rows.append((aligned, ins_cnt, lead_ins))
        with scope(lead):
            c = send(c, e, lead)
            counts = c if counts is None else counts + c
    with scope(lead):
        cons, ins_base, ins_votes, ncov, nwin = msa.vote_from_counts(
            counts, max_ins)
    per_entry = []
    for e, (_, _, row_mask), (aligned, ins_cnt, lead_ins) in zip(
            shard, blocks, rows):
        with scope(e):
            match = (aligned == send(cons, lead, e)[:, None, :]) \
                & row_mask[..., None]
        per_entry.append((match, aligned, ins_cnt, lead_ins))
    return (cons, ins_base, ins_votes, ncov, nwin), per_entry


def split_passes(P: int, pass_dim: int) -> int:
    """The pass entries a (Z, P) group spreads over: ``pass_dim`` when it
    divides P, else 1 (the pass axis replicated: the shard's first entry
    holds every pass, and no pass work is duplicated)."""
    return pass_dim if P % pass_dim == 0 else 1


def place_blocks(shard: Sequence[Entry], host_blocks) -> list:
    """Each entry's (qs, qlens, row_mask) host arrays on its device, in
    one pinned copy each on its stream."""
    out = []
    for e, arrays in zip(shard, host_blocks):
        pin = e.device.type == "cuda"
        out.append(tuple(
            put(torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
                if pin else torch.from_numpy(np.ascontiguousarray(a)), e)
            for a in arrays))
    return out


def make_sharded_round(mesh: Mesh, params: AlignParams, tmax: int,
                       max_ins: int = 4, impl: str = ""):
    """The mesh-sharded star round.

    Inputs (host arrays, global shapes): qs (Z, Pp, W) uint8, qlens (Z, Pp)
    int32, ts (Z, tmax) uint8 (each hole's draft, sent to every pass entry
    of its data shard), tlens (Z,) int32, row_mask (Z, Pp) bool; Z a
    multiple of the data dimension, Pp of the pass dimension.

    Output (host arrays): cons (Z, tmax) uint8, ins_base (Z, tmax, R)
    uint8, ins_votes (Z, tmax, R) int32, ncov (Z, tmax) int32, nwin (Z,
    tmax) int32."""
    fill = global_fill(params, impl)
    D, Pd = mesh.shape

    def step(qs, qlens, ts, tlens, row_mask):
        Z, Pp = qs.shape[:2]
        if Z % D or Pp % Pd:
            raise ValueError(f"(Z, P) = ({Z}, {Pp}) does not split over "
                             f"the mesh {mesh.shape}")
        Zd, Pb = Z // D, Pp // Pd
        parts, leads = [], []
        for d in range(D):
            shard = list(mesh.entries[d])
            hs = slice(d * Zd, (d + 1) * Zd)
            blocks = place_blocks(shard, [
                (qs[hs, p * Pb:(p + 1) * Pb], qlens[hs, p * Pb:(p + 1) * Pb],
                 row_mask[hs, p * Pb:(p + 1) * Pb]) for p in range(Pd)])
            draft, dlen = (put(torch.from_numpy(np.ascontiguousarray(a)),
                               shard[0]) for a in (ts[hs], tlens[hs]))
            with scope(shard[0]):
                outs, _ = shard_round(shard, blocks, draft, dlen, fill,
                                      tmax, max_ins)
            parts.append(outs)
            leads.append(shard[0])
        return tuple(Placed([p[k] for p in parts], leads,
                            np.concatenate).read() for k in range(5))

    return step
