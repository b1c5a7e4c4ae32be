"""ZMW group-by-hole streaming over any subread record source.

Equivalent of the reference's kseq_zmw_read (seqio.h:152-201): subread names
follow the PacBio convention ``movie/hole/region``; consecutive records with
the same (movie, hole) belong to one ZMW and are accumulated into a single
concatenated buffer plus a lengths vector.  A name that does not split into
exactly 3 '/'-fields is invalid (seqio.h:168-172; the reference kills the
whole stream there — we raise by default, or quarantine when configured).

Filters (applied by the pipeline's read step in the reference,
main.c:659-672) are provided here as `zmw_filter`.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Optional

import numpy as np

from ccsx_tpu_torch.config import CcsConfig
from ccsx_tpu_torch.io.corruption import CorruptionError
from ccsx_tpu_torch.io.fastx import FastxRecord
from ccsx_tpu_torch.utils import trace


class InvalidZmwName(CorruptionError):
    """Malformed movie/hole/region subread name — classified
    ``zmw_bad_name`` in the corruption taxonomy (io/corruption.py);
    still a ValueError for pre-taxonomy handlers."""

    def __init__(self, msg: str):
        super().__init__("zmw_bad_name", msg)


@dataclasses.dataclass
class Zmw:
    """One hole's worth of subreads (reference zmw_t, main.c:42-48)."""

    movie: str
    hole: str
    seqs: bytes                # concatenated subread bases (ASCII)
    lens: np.ndarray           # int32 per-subread lengths
    offs: np.ndarray           # int32 prefix offsets into seqs
    ccs: Optional[bytes] = None   # filled by the consensus stage

    @property
    def n_passes(self) -> int:
        return len(self.lens)

    @property
    def total_len(self) -> int:
        return len(self.seqs)

    def subread(self, i: int) -> bytes:
        o = int(self.offs[i])
        return self.seqs[o:o + int(self.lens[i])]


def split_name(name: str) -> tuple:
    fields = name.split("/")
    if len(fields) != 3:
        raise InvalidZmwName(f"invalid zmw name :{name}")
    return fields[0], fields[1], fields[2]


def group_zmws(records: Iterable[FastxRecord],
               salvage=None) -> Iterator[Zmw]:
    """Group consecutive records by (movie, hole) into Zmw objects.

    A malformed name kills the whole stream by default (reference
    parity, seqio.h:168-172); with ``salvage`` (a
    corruption.SalvageSink) the poisoned record is dropped and booked
    as ``zmw_bad_name``, and grouping re-anchors on the next record —
    the hole the record truly belonged to emits from its surviving
    passes (the native streamer applies the same rule in-library)."""
    cur_key = None
    cur_seqs: List[bytes] = []
    for rec in records:
        try:
            movie, hole, _region = split_name(rec.name)
        except InvalidZmwName:
            if salvage is None:
                raise
            salvage.record("zmw_bad_name")
            continue
        key = (movie, hole)
        if cur_key is None:
            cur_key, cur_seqs = key, [rec.seq]
        elif key == cur_key:
            cur_seqs.append(rec.seq)
        else:
            yield _build(cur_key, cur_seqs)
            cur_key, cur_seqs = key, [rec.seq]
    if cur_key is not None:
        yield _build(cur_key, cur_seqs)


def _build(key: tuple, seqs: List[bytes]) -> Zmw:
    lens = np.array([len(s) for s in seqs], dtype=np.int32)
    offs = np.zeros(len(seqs), dtype=np.int32)
    if len(seqs) > 1:
        np.cumsum(lens[:-1], out=offs[1:])
    return Zmw(movie=key[0], hole=key[1], seqs=b"".join(seqs),
               lens=lens, offs=offs)


def filter_reason(zmw: Zmw, cfg: CcsConfig) -> Optional[str]:
    """None when the hole passes the read-step filters
    (main.c:659-672), else the drop-reason bucket — the same reason
    taxonomy the native streamer reports (ccsx_filter_counts)."""
    if zmw.n_passes < cfg.min_pass_count:
        return "few_passes"
    total = zmw.total_len
    if total > cfg.max_subread_len:
        return "too_long"
    if total < cfg.min_subread_len:
        return "too_short"
    if cfg.exclude_holes and zmw.hole in cfg.exclude_holes:
        return "excluded"
    return None


def zmw_filter(zmw: Zmw, cfg: CcsConfig) -> bool:
    """Keep/drop rule of the pipeline read step (main.c:659-672)."""
    return filter_reason(zmw, cfg) is None


def stream_zmws(records: Iterable[FastxRecord], cfg: CcsConfig,
                metrics=None, salvage=None) -> Iterator[Zmw]:
    for z in group_zmws(records, salvage=salvage):
        reason = filter_reason(z, cfg)
        if reason is None:
            yield z
        else:
            # filtered holes are otherwise invisible in a trace: the
            # driver's ingest spans only see what this generator
            # yields.  Counted into Metrics (reason-bucketed) when the
            # driver passes its object; the native C++ streamer
            # (native/io.py) applies the same filters in-library and
            # surfaces its counts at stream EOF instead
            if metrics is not None:
                metrics.holes_filtered += 1
                metrics.filtered_reasons[reason] = (
                    metrics.filtered_reasons.get(reason, 0) + 1)
            trace.instant("zmw_filtered", cat="ingest", hole=z.hole,
                          passes=z.n_passes, bases=z.total_len,
                          reason=reason)
