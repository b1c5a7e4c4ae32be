"""BGZF hole index: byte-range sharded BAM ingest (a copy of the JAX
package's io/bamindex.py, with the same sidecar name and version: either
package reads the index the other writes).

The round-robin multi-host design (parallel/distributed.py) has every
host decode the FULL input and keep 1/N of the holes — zero
coordination, but N x redundant parsing (SURVEY §5.8 wants "each host
reads its own input shard").  This module removes the redundancy for
BGZF BAM inputs using the container's block structure (the same
structure the native reader's parallel inflate exploits,
io_native.cpp):

* ``build_index`` — ONE sequential indexing pass (run once per input,
  ``ccsx-tpu-torch --make-index``) records the BGZF virtual offset
  (compressed block offset, offset within the inflated block) of every
  K-th hole boundary plus the total raw hole count, into a JSON
  sidecar ``<in>.bam.ccsx_idx`` fingerprinted by file size+mtime.
* sharded runs split the RAW hole ordinal space contiguously —
  rank r owns [r*H/N, (r+1)*H/N) — and each rank seeks to the nearest
  indexed boundary at or before its range, inflates only its ~1/N of
  the compressed bytes (plus at most K holes of lead-in), and streams
  records through the SAME filters as a single-host run.
* output ordering: contiguous ranges make ``start_ordinal +
  local_filtered_idx`` a globally monotone merge key (a range's
  filtered hole count never exceeds its raw count, so keys never reach
  the next rank's start), so ``merge_shards`` reproduces the
  single-host byte-identical output with no new merge machinery.

Reference mapping: the reference is single-host and reads sequentially
(bamlite.h:13-19, no random access); this is the distributed-ingest
capability SURVEY §5.8 adds on top.  Virtual offsets follow the BGZF
convention (coffset<<16 | uoffset) so the sidecar is interoperable
with htslib-style tooling expectations.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Iterator, List, Optional, Tuple

from ccsx_tpu_torch.io.bam import (BamError, check_record_length,
                             read_bam_header)
from ccsx_tpu_torch.io.fastx import FastxRecord

INDEX_SUFFIX = ".ccsx_idx"
INDEX_VERSION = 1


class BgzfBlockReader:
    """Sequential reader over BGZF blocks that tracks virtual offsets.

    ``read(n)`` returns inflated bytes; ``voffset()`` reports the
    (coffset, uoffset) of the NEXT unread byte — exactly what the index
    stores for a record boundary.  Raises BamError on a non-BGZF
    member (sharding requires real BGZF; the plain-gzip fallback path
    keeps using the sequential reader)."""

    def __init__(self, f, coffset: int = 0):
        self._f = f
        f.seek(coffset)
        # spans: (start_pos_in_buf_stream, coffset, ulen) per loaded block
        self._buf = bytearray()
        self._pos = 0            # read cursor within _buf
        self._spans: List[Tuple[int, int, int]] = []
        self._consumed = 0       # bytes compacted away from _buf's front
        self.compressed_bytes = 0   # total compressed bytes inflated

    def _load_block(self) -> bool:
        coffset = self._f.tell()
        head = self._f.read(18)
        if len(head) == 0:
            return False
        if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04":
            raise BamError("not a BGZF block (sharded ingest requires "
                           "a real BGZF container)", "bgzf_bad_block")
        (xlen,) = struct.unpack_from("<H", head, 10)
        extra = head[12:18]
        # walk the extra subfields for BC (usually first)
        bsize = None
        off = 0
        extra += self._f.read(max(0, xlen - 6))
        while off + 4 <= len(extra):
            si1, si2, slen = extra[off], extra[off + 1], struct.unpack_from(
                "<H", extra, off + 2)[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                (bsize,) = struct.unpack_from("<H", extra, off + 4)
                break
            off += 4 + slen
        if bsize is None:
            raise BamError("BGZF block missing BC subfield",
                           "bgzf_bad_block")
        payload_len = bsize + 1 - 12 - xlen - 8
        if payload_len < 0:
            raise BamError(f"BGZF block BSIZE {bsize} smaller than its "
                           "own header", "bgzf_bad_block")
        comp = self._f.read(payload_len)
        tail = self._f.read(8)
        if len(comp) < payload_len or len(tail) < 8:
            raise BamError("truncated BGZF block", "bgzf_torn_tail")
        try:
            data = zlib.decompress(comp, -15)
        except zlib.error as e:
            raise BamError(f"BGZF block inflate failed: {e}",
                           "bgzf_bad_deflate") from None
        crc, isize = struct.unpack("<II", tail)
        if isize != len(data) & 0xFFFFFFFF or zlib.crc32(data) != crc:
            raise BamError("BGZF block CRC/ISIZE mismatch",
                           "bgzf_bad_deflate")
        self.compressed_bytes += bsize + 1
        if data:
            self._spans.append(
                (self._consumed + len(self._buf), coffset, len(data)))
            self._buf += data
        return True

    def read(self, n: int) -> bytes:
        while len(self._buf) - self._pos < n:
            if not self._load_block():
                break
        take = self._buf[self._pos:self._pos + n]
        self._pos += len(take)
        self._compact()
        return bytes(take)

    def skip(self, n: int) -> None:
        self.read(n)

    def _compact(self) -> None:
        # drop fully-consumed leading blocks so memory stays ~2 blocks
        while len(self._spans) > 1 and (
                self._spans[1][0] - self._consumed) <= self._pos:
            start = self._spans[1][0] - self._consumed
            del self._buf[:start]
            self._pos -= start
            self._consumed += start
            self._spans.pop(0)

    def voffset(self) -> Tuple[int, int]:
        """(coffset, uoffset) of the next unread byte."""
        if not self._spans:
            if self._load_block():
                return self.voffset()
            return self._f.tell(), 0   # empty/at-EOF stream
        abs_pos = self._consumed + self._pos
        cur = None
        for start, coffset, ulen in self._spans:
            if start <= abs_pos < start + ulen:
                return coffset, abs_pos - start
            if start + ulen == abs_pos:
                cur = (coffset, ulen)
        if cur is not None:
            # cursor sits exactly at a block end: the next byte is the
            # start of the next (not yet loaded) block
            if self._load_block():
                return self.voffset()
            return cur  # EOF: report end-of-last-block
        raise BamError("virtual offset outside loaded spans")


def _hole_key(name: str) -> Tuple[str, str]:
    """(movie, hole) from a subread name movie/hole/qs_qe — the same
    grouping key the ZMW streamer uses (io/zmw.py)."""
    parts = name.split("/")
    return (parts[0], parts[1]) if len(parts) >= 2 else (name, "")


def _records_with_boundaries(r: BgzfBlockReader,
                             max_record_bytes: int = 0):
    """Yield (voffset_before_record, name) for each alignment record.

    Only the name is decoded — the indexing pass does not touch seq or
    qual bytes, so it runs at near-inflate speed."""
    while True:
        voff = r.voffset()
        head = r.read(4)
        if len(head) == 0:
            return
        if len(head) < 4:
            raise BamError("truncated BAM: partial block size")
        (block_size,) = struct.unpack("<i", head)
        # allocation bound, shared classify-split (io/bam.py)
        check_record_length(block_size, max_record_bytes)
        block = r.read(block_size)
        if len(block) < block_size:
            raise BamError("truncated BAM: short alignment block")
        l_read_name = block[8]
        name = block[32:32 + l_read_name - 1].decode(errors="replace")
        yield voff, name


def build_index(path: str, every: int = 64,
                max_record_bytes: int = 0) -> dict:
    """Index a BGZF BAM's hole boundaries; writes ``<path>.ccsx_idx``.

    Entries: [raw_hole_ordinal, coffset, uoffset] for every ``every``-th
    hole boundary (ordinal 0 always present).  Returns the index dict."""
    st = os.stat(path)
    with open(path, "rb") as f:
        r = BgzfBlockReader(f)
        read_bam_header(r)
        entries = []
        n_holes = 0
        n_records = 0
        prev_key = None
        for voff, name in _records_with_boundaries(r, max_record_bytes):
            key = _hole_key(name)
            if key != prev_key:
                if n_holes % every == 0:
                    entries.append([n_holes, voff[0], voff[1]])
                n_holes += 1
                prev_key = key
            n_records += 1
    idx = {
        "version": INDEX_VERSION,
        "every": every,
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "n_holes": n_holes,
        "n_records": n_records,
        "entries": entries,
    }
    with open(path + INDEX_SUFFIX, "w") as f:
        json.dump(idx, f)
    return idx


def load_index(path: str) -> Optional[dict]:
    """The sidecar index, or None when absent/stale/unreadable."""
    try:
        with open(path + INDEX_SUFFIX) as f:
            idx = json.load(f)
        st = os.stat(path)
        if (idx.get("version") != INDEX_VERSION
                or idx.get("size") != st.st_size
                or idx.get("mtime_ns") != st.st_mtime_ns):
            return None
        return idx
    except (OSError, ValueError):
        return None


def hole_range(n_holes: int, rank: int, n: int) -> Tuple[int, int]:
    """Contiguous raw-hole range [lo, hi) owned by ``rank`` of ``n``."""
    return (rank * n_holes) // n, ((rank + 1) * n_holes) // n


def split_ranges(n_holes: int, m: int) -> List[Tuple[int, int]]:
    """The raw-hole ordinal space as M contiguous ranges — the fleet
    scheduler's work-unit table (pipeline/fleet.py).  Same arithmetic
    as hole_range, so a fleet run with M == N degenerates to exactly
    the static shard split; empty ranges (m > n_holes) are kept so the
    table always has m rows and range i's identity never depends on the
    corpus size."""
    return [hole_range(n_holes, i, m) for i in range(max(1, m))]


def read_hole_range(path: str, idx: dict, lo: int, hi: int,
                    counter=None,
                    max_record_bytes: int = 0) -> Iterator[FastxRecord]:
    """Stream the records of raw holes [lo, hi) as FastxRecords.

    Seeks to the nearest indexed boundary <= lo (at most ``every``-1
    holes of lead-in are parsed and dropped), decodes records through
    the end of hole hi-1, and stops — inflating only this range's
    compressed bytes.  ``counter`` (optional callable) receives the
    total compressed bytes inflated, for metrics.ingest_bytes."""
    if lo >= hi:
        if counter is not None:
            counter(0)
        return
    # nearest indexed entry at or before lo
    base_ord, coffset, uoffset = 0, None, None
    for e_ord, e_coff, e_uoff in idx["entries"]:
        if e_ord <= lo:
            base_ord, coffset, uoffset = e_ord, e_coff, e_uoff
        else:
            break
    with open(path, "rb") as f:
        if coffset is None:
            # defensive: no entry (empty file) — parse from the top
            r = BgzfBlockReader(f)
            read_bam_header(r)
            base_ord = 0
        else:
            r = BgzfBlockReader(f, coffset)
            r.skip(uoffset)
        holes_seen = base_ord - 1   # ordinal of prev_key's hole
        prev_key = None
        try:
            yield from _range_records(r, lo, hi, holes_seen, prev_key,
                                      max_record_bytes)
        finally:
            # fires even when the consumer abandons the generator, so
            # metrics.ingest_bytes is counted for partial consumption
            if counter is not None:
                counter(r.compressed_bytes)


def _range_records(r, lo, hi, holes_seen, prev_key,
                   max_record_bytes: int = 0):
    from ccsx_tpu_torch.io.bam import decode_record

    while True:
        head = r.read(4)
        if len(head) == 0:
            return
        if len(head) < 4:
            raise BamError("truncated BAM: partial block size")
        (block_size,) = struct.unpack("<i", head)
        check_record_length(block_size, max_record_bytes)
        block = r.read(block_size)
        if len(block) < block_size:
            raise BamError("truncated BAM: short alignment block")
        l_read_name = block[8]
        name = block[32:32 + l_read_name - 1].decode(errors="replace")
        key = _hole_key(name)
        if key != prev_key:
            holes_seen += 1
            prev_key = key
            if holes_seen >= hi:
                return
        if holes_seen < lo:
            continue   # lead-in hole: name-only parse, no seq decode
        # full decode shared with the sequential reader (bam.py) so the
        # range-sharded stream can never diverge from it
        yield decode_record(block)[0]
