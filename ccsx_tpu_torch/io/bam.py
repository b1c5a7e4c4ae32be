"""Minimal BAM reader over a plain gzip stream (Python fallback path).

Replicates the semantics of the reference's bamlite (bamlite.c:78-165):
BAM-through-gzip — BGZF files are valid multi-member gzip streams, so
sequential reading works without BGZF block handling (bamlite.h:13-19 makes
the same choice; no random access).  Per record we decode the read name,
the 4-bit packed sequence via the =ACMGRSVTWYHKDBN table (seqio.h:92,
bamlite.h:86) and qualities as phred+33 clamped at 126 (seqio.h:113).

Truncated-stream handling mirrors bamlite: a clean EOF at a record boundary
ends the stream; a partial record raises.
"""

from __future__ import annotations

import gzip
import io
import os
import struct
import zlib
from typing import Iterator, Optional

import numpy as np

from ccsx_tpu_torch.io.corruption import (CorruptionError,
                                    DEFAULT_MAX_RECORD_BYTES,
                                    MIN_RECORD_BLOCK, SCAN_LOOKAHEAD,
                                    SalvageSink, record_plausible)
from ccsx_tpu_torch.io.fastx import FastxRecord

SEQ_NT16 = b"=ACMGRSVTWYHKDBN"

# 2x256 lookup: byte -> two ASCII bases (high nibble first, bamlite.h:86)
_NIB = np.empty((256, 2), dtype=np.uint8)
for _b in range(256):
    _NIB[_b, 0] = SEQ_NT16[_b >> 4]
    _NIB[_b, 1] = SEQ_NT16[_b & 0xF]


class BamError(CorruptionError):
    """Classified BAM/BGZF parse failure (io/corruption.py taxonomy).

    Subclasses CorruptionError(ValueError), so every pre-taxonomy
    handler (``except BamError`` / ``except ValueError``) still works;
    ``reason`` is the stable code both reader stacks report."""

    def __init__(self, msg: str, reason: str = "bam_bad_record"):
        super().__init__(reason, msg)


def check_record_length(block_size: int,
                        max_record_bytes: int = 0) -> None:
    """THE allocation-bound check on one alignment record's length
    field, shared by the sequential reader and the byte-range sharded
    reader (io/bamindex.py): reject BEFORE any read() allocates, with
    the oversize-vs-corrupt reason split made in exactly one place."""
    max_rec = max_record_bytes or DEFAULT_MAX_RECORD_BYTES
    if not 32 <= block_size <= max_rec:
        raise BamError(
            f"corrupt BAM record length {block_size}"
            + (f" (exceeds the --max-record-bytes bound {max_rec})"
               if block_size > max_rec else ""),
            "bam_record_oversize" if block_size > max_rec
            else "bam_bad_record")


def _read_exact(f, n: int, what: str,
                reason: str = "bam_bad_record") -> bytes:
    buf = f.read(n)
    if len(buf) != n:
        raise BamError(f"truncated BAM: short read in {what}", reason)
    return buf


def read_bam_header(f) -> dict:
    magic = _read_exact(f, 4, "magic", "bam_bad_header")
    if magic != b"BAM\x01":
        raise BamError("invalid BAM header", "bam_bad_header")  # bamlite.c:84
    (l_text,) = struct.unpack("<i",
                              _read_exact(f, 4, "l_text", "bam_bad_header"))
    # allocation bound: a corrupt length field must be rejected BEFORE
    # the read allocates (a flipped high bit reads as multi-GB)
    if not 0 <= l_text <= DEFAULT_MAX_RECORD_BYTES:
        raise BamError(f"corrupt BAM header: l_text={l_text}",
                       "bam_bad_header")
    text = _read_exact(f, l_text, "text", "bam_bad_header").rstrip(
        b"\x00").decode(errors="replace")
    (n_ref,) = struct.unpack("<i",
                             _read_exact(f, 4, "n_ref", "bam_bad_header"))
    if not 0 <= n_ref <= 1 << 24:
        raise BamError(f"corrupt BAM header: n_ref={n_ref}",
                       "bam_bad_header")
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack(
            "<i", _read_exact(f, 4, "ref name len", "bam_bad_header"))
        if not 1 <= l_name <= 4096:
            raise BamError(f"corrupt BAM header: ref name len={l_name}",
                           "bam_bad_header")
        name = _read_exact(f, l_name, "ref name",
                           "bam_bad_header")[:-1].decode(errors="replace")
        (l_ref,) = struct.unpack(
            "<i", _read_exact(f, 4, "ref len", "bam_bad_header"))
        refs.append((name, l_ref))
    return {"text": text, "refs": refs}


def read_bam_records(path_or_file, with_aux: bool = False,
                     salvage: Optional[SalvageSink] = None,
                     max_record_bytes: int = 0):
    """Stream BAM alignment records as FastxRecords (name/seq/qual).

    With ``with_aux``, yields (FastxRecord, aux_dict) pairs instead,
    where aux_dict is parse_aux of the record's tag region
    (bamlite.c:215-290 equivalent; ccsx's hot path never reads tags).

    ``salvage`` (a SalvageSink) selects salvage mode: classified
    corruption is booked and RESYNCED past — BGZF block resync on
    container damage, plausible-record scan on record damage
    (io/corruption.py spec) — instead of raised.  Without it, the
    historical fail-fast behavior is preserved byte-for-byte (the
    first classified corruption raises BamError).  ``max_record_bytes``
    (0 = DEFAULT_MAX_RECORD_BYTES) is the allocation bound on one
    alignment record, enforced BEFORE allocating either way."""
    max_rec = max_record_bytes or DEFAULT_MAX_RECORD_BYTES
    if salvage is not None:
        yield from _read_bam_salvage(path_or_file, with_aux, salvage,
                                     max_record_bytes
                                     or salvage.max_record_bytes)
        return
    bgzf_path = None
    if hasattr(path_or_file, "read"):
        raw = path_or_file
    else:
        raw = open(path_or_file, "rb")
        bgzf_path = path_or_file
    # transparent gzip/BGZF
    if not hasattr(raw, "peek"):
        raw = io.BufferedReader(raw)
    if raw.peek(2)[:2] == b"\x1f\x8b":
        head = raw.peek(14)
        # BGZF = FEXTRA set (byte 3 bit 2) AND a leading BC subfield; a
        # plain-gzip member whose stored FNAME happens to contain "BC"
        # at offset 12 must NOT be treated as BGZF
        if bgzf_path is not None and not (
                len(head) >= 14 and head[3] & 0x04
                and head[12:14] == b"BC"):
            bgzf_path = None    # plain gzip, no EOF-marker contract
        f = io.BufferedReader(gzip.GzipFile(fileobj=raw))
    else:
        f = raw
        bgzf_path = None

    def check_eof_marker():
        # a BGZF file must end with the 28-byte empty EOF block; a file
        # cut exactly at a member boundary otherwise reads as a clean
        # (shorter) stream.  Same check as the native reader (BgzfMT),
        # so pipeline behavior doesn't depend on which backend loaded.
        if bgzf_path is None:
            return
        with open(bgzf_path, "rb") as fh:
            fh.seek(0, 2)
            size = fh.tell()
            fh.seek(max(0, size - len(BGZF_EOF)))
            if fh.read() != BGZF_EOF:
                raise BamError("BGZF stream missing EOF marker "
                               "(truncated at a block boundary?)",
                               "bgzf_missing_eof")

    read_bam_header(f)
    while True:
        head = f.read(4)
        if len(head) == 0:
            check_eof_marker()
            return  # clean EOF (bamlite.c:141 returns -1)
        if len(head) < 4:
            raise BamError("truncated BAM: partial block size")
        (block_size,) = struct.unpack("<i", head)
        # bound BEFORE the read allocates: a corrupt int32 must not
        # drive a multi-GB buffer (and a negative one would read(-1)
        # the whole rest of the stream)
        check_record_length(block_size, max_rec)
        block = _read_exact(f, block_size, "alignment block")
        rec, aux_buf = decode_record(block)
        if with_aux:
            yield rec, parse_aux(aux_buf)
        else:
            yield rec


def decode_record(block: bytes):
    """One alignment block -> (FastxRecord, aux_region_bytes).

    THE record decode — name, 4-bit packed sequence via the
    =ACMGRSVTWYHKDBN table (seqio.h:92), qualities phred+33 clamped at
    126 (seqio.h:113).  Shared by the sequential reader above and the
    byte-range sharded reader (io/bamindex.py) so the two streams can
    never diverge in decode semantics."""
    if len(block) < 32:
        raise BamError(f"corrupt BAM record: {len(block)}-byte block")
    (refid, pos, l_read_name, mapq, bin_, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack("<iiBBHHHiiii", block[:32])
    # field-consistency audit (the native reader makes the same checks,
    # io_native.cpp BamReader::next): a corrupt length field must
    # classify as bam_bad_record, not surface as a numpy bounds error
    if (l_read_name < 1 or l_seq < 0
            or 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
            > len(block)):
        raise BamError(
            f"corrupt BAM record fields (l_read_name={l_read_name}, "
            f"n_cigar={n_cigar}, l_seq={l_seq}, block={len(block)})")
    off = 32
    name = block[off:off + l_read_name - 1].decode(errors="replace")
    off += l_read_name
    off += 4 * n_cigar
    nseq_bytes = (l_seq + 1) // 2
    packed = np.frombuffer(block, dtype=np.uint8,
                           count=nseq_bytes, offset=off)
    seq = _NIB[packed].reshape(-1)[:l_seq].tobytes()
    off += nseq_bytes
    qual_raw = np.frombuffer(block, dtype=np.uint8, count=l_seq,
                             offset=off)
    # phred+33 clamped at 126 (seqio.h:113)
    qual = np.minimum(qual_raw.astype(np.int16) + 33, 126).astype(
        np.uint8).tobytes()
    return (FastxRecord(name=name, comment="", seq=seq, qual=qual),
            block[off + l_seq:])


# ---- aux-tag walk (bamlite.c:215-290) ------------------------------------
#
# ccsx itself never reads aux tags, but bamlite ships the full walk +
# typed getters; parity keeps them available (real subreads.bam carries
# np/rq/sn/... tags a downstream user may want).

_AUX_SCALAR = {"c": "<b", "C": "<B", "s": "<h", "S": "<H",
               "i": "<i", "I": "<I", "f": "<f", "d": "<d"}


def parse_aux(buf: bytes) -> dict:
    """Walk an alignment record's aux region into {tag: (type, value)}.

    Mirrors bam_aux_get/skip_aux (bamlite.c:192-241): scalar types
    c/C/s/S/i/I/f/d, char A, NUL-terminated Z/H, and B arrays."""
    out = {}
    off, n = 0, len(buf)
    try:
        while off + 3 <= n:
            tag = buf[off:off + 2].decode("ascii", errors="replace")
            typ = chr(buf[off + 2])
            off += 3
            if typ in _AUX_SCALAR:
                fmt = _AUX_SCALAR[typ]
                val = struct.unpack_from(fmt, buf, off)[0]
                off += struct.calcsize(fmt)
            elif typ == "A":
                val = chr(buf[off])
                off += 1
            elif typ in "ZH":
                end = buf.index(b"\x00", off)
                val = buf[off:end].decode(errors="replace")
                off = end + 1
            elif typ == "B":
                sub = chr(buf[off])
                (cnt,) = struct.unpack_from("<i", buf, off + 1)
                if sub not in _AUX_SCALAR:
                    raise BamError(f"bad B-array sub-type {sub!r}")
                fmt = _AUX_SCALAR[sub]
                size = struct.calcsize(fmt)
                off += 5
                # a negative/oversized count is corruption; without the
                # guard `off += cnt * size` could walk backwards and
                # loop forever
                if cnt < 0 or off + cnt * size > n:
                    raise BamError(f"bad B-array count {cnt} for {tag}")
                val = [struct.unpack_from(fmt, buf, off + i * size)[0]
                       for i in range(cnt)]
                off += cnt * size
            else:
                raise BamError(f"unknown aux type {typ!r} for tag {tag}")
            out[tag] = (typ, val)
    except (ValueError, IndexError, struct.error) as e:
        if isinstance(e, BamError):
            raise
        raise BamError(f"corrupt aux data: {e}") from e
    return out


def _aux_tv(aux: dict, tag: str):
    return aux.get(tag, ("", None))


def aux2i(aux: dict, tag: str) -> int:
    """Integer getter: c/C/s/S/i/I else 0 (bam_aux2i, bamlite.c:243-252)."""
    typ, val = _aux_tv(aux, tag)
    return int(val) if typ in tuple("cCsSiI") else 0


def aux2f(aux: dict, tag: str) -> float:
    """Float getter: f else 0.0 (bam_aux2f, bamlite.c:254-260)."""
    typ, val = _aux_tv(aux, tag)
    return float(val) if typ == "f" else 0.0


def aux2d(aux: dict, tag: str) -> float:
    """Double getter: d else 0.0 (bam_aux2d, bamlite.c:262-268)."""
    typ, val = _aux_tv(aux, tag)
    return float(val) if typ == "d" else 0.0


def aux2A(aux: dict, tag: str) -> str:
    """Char getter: A else '\\0' (bam_aux2A, bamlite.c:270-276)."""
    typ, val = _aux_tv(aux, tag)
    return val if typ == "A" else "\x00"


def aux2Z(aux: dict, tag: str):
    """String getter: Z/H else None (bam_aux2Z, bamlite.c:278-285)."""
    typ, val = _aux_tv(aux, tag)
    return val if typ in ("Z", "H") else None


# ---- salvage-mode reading (io/corruption.py taxonomy + resync spec) ------
#
# Salvage mode degrades per-record, not per-file: classified corruption
# books an event into the SalvageSink and the reader RESYNCS —
#   * BGZF container damage: scan the raw file forward for the next
#     valid block header (magic + BC subfield + a BSIZE that chains to
#     another block header or EOF);
#   * record damage (or the gap a skipped block leaves): scan the
#     inflated stream for the next plausible record start
#     (corruption.record_plausible — the contract io_native.cpp
#     mirrors byte-for-byte, pinned by the differential fuzz tests).
# Records that survive flow on unchanged; a hole that lost records
# emits a consensus from its surviving passes (it is damaged either
# way — the salvage invariant only constrains undamaged holes).

_BGZF_MAGIC3 = b"\x1f\x8b\x08"


def _read_bgzf_header(f, pos: int, size: int):
    """(bsize, xlen, ok) for a candidate BGZF block header at file
    offset ``pos``; bsize is the total on-disk block size.  Pure
    structure check — shared by the salvage block walk and its resync
    scan (and mirrored by io_native.cpp's read_raw/try_candidate)."""
    if size - pos < 12:
        return 0, 0, False
    f.seek(pos)
    head = f.read(12)
    if len(head) < 12 or head[:3] != _BGZF_MAGIC3 or not head[3] & 4:
        return 0, 0, False
    (xlen,) = struct.unpack_from("<H", head, 10)
    extra = f.read(xlen)
    if len(extra) < xlen:
        return 0, xlen, False
    i = 0
    while i + 4 <= xlen:
        (slen,) = struct.unpack_from("<H", extra, i + 2)
        if extra[i:i + 2] == b"BC" and slen == 2 and i + 6 <= xlen:
            (bs,) = struct.unpack_from("<H", extra, i + 4)
            bsize = bs + 1
            if bsize >= 12 + xlen + 8:
                return bsize, xlen, True
            return 0, xlen, False
        i += 4 + slen
    return 0, xlen, False


def _bgzf_salvage_chunks(path: str, sink: SalvageSink):
    """Yield (inflated_block_bytes, gap_before) over a possibly-damaged
    BGZF file, STREAMING — O(one block) of memory, never the whole file
    (salvage exists for production-sized inputs).  Container damage
    books one event per resync region: header damage -> bgzf_bad_block
    + forward scan for the next valid chained header; payload damage ->
    bgzf_bad_deflate + skip the block; truncation -> bgzf_torn_tail;
    a missing EOF marker -> bgzf_missing_eof (degrades but is
    budget-exempt: no hole is provably lost)."""
    with open(path, "rb") as f:
        f.seek(0, 2)
        size = f.tell()
        pos = 0
        gap = False
        last_was_eof_marker = False

        def try_candidate(cand: int) -> bool:
            """Valid chained header at cand: its BSIZE lands exactly on
            EOF or on another block magic (the header-integrity check
            BGZF itself lacks)."""
            bsize, _, ok = _read_bgzf_header(f, cand, size)
            if not ok or cand + bsize > size:
                return False
            if cand + bsize == size:
                return True
            f.seek(cand + bsize)
            return f.read(3) == _BGZF_MAGIC3

        def rescan(start: int) -> int:
            """Next offset > start holding a valid chained block
            header, or -1 — a windowed forward scan (2-byte overlap so
            a magic spanning two windows is still seen)."""
            o = start + 1
            while o + 12 <= size:
                f.seek(o)
                win = f.read(1 << 16)
                if len(win) < 3:
                    break
                j = win.find(_BGZF_MAGIC3)
                while j != -1:
                    if try_candidate(o + j):
                        return o + j
                    j = win.find(_BGZF_MAGIC3, j + 1)
                o += max(len(win) - 2, 1)
            return -1

        while pos < size:
            bsize, xlen, ok = _read_bgzf_header(f, pos, size)
            if not ok or pos + bsize > size:
                # header damage (or a block running past EOF = torn tail)
                sink.record("bgzf_torn_tail" if ok or size - pos < 12
                            else "bgzf_bad_block")
                last_was_eof_marker = False
                nxt = rescan(pos)
                if nxt == -1:
                    break
                pos, gap = nxt, True
                continue
            f.seek(pos + 12 + xlen)
            payload = f.read(bsize - 12 - xlen - 8)
            crc, isize = struct.unpack("<II", f.read(8))
            last_was_eof_marker = len(payload) <= 4 and isize == 0
            if isize > 1 << 16:
                # BGZF caps the uncompressed block at 64KB; a larger
                # ISIZE is a payload lie — reject before allocating
                sink.record("bgzf_bad_deflate")
                pos, gap = pos + bsize, True
                continue
            try:
                data = zlib.decompress(payload, -15)
            except zlib.error:
                data = None
            if (data is None or len(data) != isize
                    or zlib.crc32(data) != crc):
                sink.record("bgzf_bad_deflate")
                pos, gap = pos + bsize, True
                continue
            pos += bsize
            if data:
                yield data, gap
                gap = False
        if not last_was_eof_marker:
            sink.record("bgzf_missing_eof")


def _gzip_salvage_chunks(f, sink: SalvageSink, own: bool = False):
    """Yield (chunk, False) from a plain-gzip (or raw) stream; a
    corrupt/truncated deflate stream has no block structure to resync
    on, so it books one gzip_truncated and ends the stream — the
    records already delivered are the salvage.  ``own``: this
    generator opened the handle and closes it at exhaustion."""
    try:
        while True:
            try:
                data = f.read(1 << 16)
            except (OSError, EOFError, zlib.error):
                sink.record("gzip_truncated")
                return
            if not data:
                return
            yield data, False
    finally:
        if own:
            try:
                f.close()
            except OSError:
                pass


class _SalvageFeed:
    """Byte feed over a (chunk, gap_before) iterator with explicit gap
    surfacing: bytes on the two sides of a gap must never be parsed as
    one contiguous record."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self.buf = bytearray()
        self.pos = 0
        self._queued = None   # post-gap chunk awaiting take_gap()
        self.eof = False

    def ensure(self, n: int) -> str:
        """'ok' when n bytes are available at pos; 'gap' when a gap
        interrupts first (call take_gap()); 'eof' at stream end."""
        while len(self.buf) - self.pos < n:
            if self._queued is not None:
                return "gap"
            if self.eof:
                return "eof"
            try:
                data, gap = next(self._it)
            except StopIteration:
                self.eof = True
                return "eof"
            if gap:
                self._queued = data
                return "gap"
            self.buf += data
        return "ok"

    def take_gap(self) -> None:
        """Discard the unconsumed pre-gap tail (bytes of a damaged
        record) and absorb the post-gap chunk."""
        del self.buf[self.pos:]
        if self._queued is not None:
            self.buf += self._queued
            self._queued = None

    def avail(self) -> int:
        return len(self.buf) - self.pos

    def compact(self) -> None:
        if self.pos > 1 << 16:
            del self.buf[:self.pos]
            self.pos = 0


def _salvage_scan(feed: _SalvageFeed, max_rec: int) -> str:
    """Advance feed.pos to the next plausible record start ('ok'), or
    consume the tail and report 'eof'.  One byte per rejection — the
    exact scan io_native.cpp mirrors."""
    while True:
        st = feed.ensure(SCAN_LOOKAHEAD)
        if st == "gap":
            feed.take_gap()
            continue
        if st == "eof" and feed.avail() < 36:
            feed.pos = len(feed.buf)
            return "eof"
        if record_plausible(feed.buf, feed.pos, max_rec):
            return "ok"
        feed.pos += 1
        feed.compact()


def _salvage_header(feed: _SalvageFeed) -> bool:
    """Tolerant BAM-header parse over the feed; False = damaged (the
    caller falls back to the record scan)."""
    if feed.ensure(12) != "ok" or bytes(feed.buf[feed.pos:feed.pos + 4]) \
            != b"BAM\x01":
        return False
    (l_text,) = struct.unpack_from("<i", feed.buf, feed.pos + 4)
    if not 0 <= l_text <= DEFAULT_MAX_RECORD_BYTES:
        return False
    if feed.ensure(12 + l_text) != "ok":
        return False
    (n_ref,) = struct.unpack_from("<i", feed.buf, feed.pos + 8 + l_text)
    if not 0 <= n_ref <= 1 << 24:
        return False
    feed.pos += 12 + l_text
    for _ in range(n_ref):
        if feed.ensure(4) != "ok":
            return False
        (l_name,) = struct.unpack_from("<i", feed.buf, feed.pos)
        if not 1 <= l_name <= 4096:
            return False
        if feed.ensure(8 + l_name) != "ok":
            return False
        feed.pos += 8 + l_name
    return True


def _read_bam_salvage(path_or_file, with_aux: bool, sink: SalvageSink,
                      max_rec: int = 0):
    """The salvage-mode record stream: block-resynced BGZF chunks (real
    paths) or a classified plain-gzip stream, walked with the shared
    plausible-record scan."""
    max_rec = max_rec or sink.max_record_bytes
    if isinstance(path_or_file, (str, os.PathLike)) \
            and os.path.exists(str(path_or_file)):
        with open(path_or_file, "rb") as fh:
            head = fh.read(14)
        if (len(head) >= 14 and head[:3] == _BGZF_MAGIC3
                and head[3] & 4 and head[12:14] == b"BC"):
            chunks = _bgzf_salvage_chunks(str(path_or_file), sink)
        else:
            raw = open(path_or_file, "rb")
            if head[:2] == b"\x1f\x8b":
                raw = io.BufferedReader(gzip.GzipFile(fileobj=raw))
            chunks = _gzip_salvage_chunks(raw, sink, own=True)
    else:
        raw = path_or_file
        if not hasattr(raw, "peek"):
            raw = io.BufferedReader(raw)
        if raw.peek(2)[:2] == b"\x1f\x8b":
            raw = io.BufferedReader(gzip.GzipFile(fileobj=raw))
        chunks = _gzip_salvage_chunks(raw, sink)

    feed = _SalvageFeed(chunks)
    resync = False
    if not _salvage_header(feed):
        sink.record("bam_bad_header")
        resync = True
    while True:
        feed.compact()
        if resync:
            if _salvage_scan(feed, max_rec) == "eof":
                return
            resync = False
        st = feed.ensure(4)
        if st == "gap":
            feed.take_gap()
            resync = True
            continue
        if st == "eof":
            if feed.avail():
                sink.record("bam_bad_record")
                feed.pos = len(feed.buf)
            return
        (block_size,) = struct.unpack_from("<i", feed.buf, feed.pos)
        if not MIN_RECORD_BLOCK <= block_size <= max_rec:
            sink.record("bam_record_oversize"
                        if block_size > max_rec else "bam_bad_record")
            feed.pos += 1
            resync = True
            continue
        st = feed.ensure(4 + block_size)
        if st == "gap":
            feed.take_gap()
            resync = True
            continue
        if st == "eof":
            sink.record("bam_bad_record")
            feed.pos = len(feed.buf)
            return
        block = bytes(feed.buf[feed.pos + 4:feed.pos + 4 + block_size])
        try:
            rec, aux_buf = decode_record(block)
        except (BamError, ValueError):
            sink.record("bam_bad_record")
            feed.pos += 1
            resync = True
            continue
        feed.pos += 4 + block_size
        if with_aux:
            try:
                aux = parse_aux(aux_buf)
            except BamError:
                sink.record("bam_bad_record")
                aux = {}
            yield rec, aux
        else:
            yield rec


# BGZF framing (the real subreads.bam container): gzip members <=64KB
# with a "BC" extra subfield holding the compressed block size, ending in
# a fixed 28-byte empty EOF block.  Valid multi-member gzip, so every
# plain-gzip reader (incl. this module's read path and the reference's
# bamlite, bamlite.h:13-19) still reads it; the native reader additionally
# exploits the block structure for parallel inflate (io_native.cpp).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BGZF_BLOCK_PAYLOAD = 0xFF00      # htslib's default uncompressed chunk


def _bgzf_block(data: bytes) -> bytes:
    import zlib

    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = 18 + len(comp) + 8 - 1          # total block size minus 1
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
              + struct.pack("<H", 6) + b"BC" + struct.pack("<HH", 2, bsize))
    return (header + comp + struct.pack("<II", zlib.crc32(data),
                                        len(data) & 0xFFFFFFFF))


def write_bgzf(path, data: bytes) -> None:
    """Write `data` as a BGZF stream (blocked gzip + EOF marker)."""
    with open(path, "wb") as fh:
        for i in range(0, len(data), BGZF_BLOCK_PAYLOAD):
            fh.write(_bgzf_block(data[i:i + BGZF_BLOCK_PAYLOAD]))
        fh.write(BGZF_EOF)


class BamWriter:
    """Ordered unaligned-BAM output writer (CLI --bam).

    Buffers records and writes the BGZF container at close() — CCS
    output is orders of magnitude smaller than the subread input, so
    buffering is fine at real run sizes, and it keeps the writer a thin
    shim over write_bam.  Each record carries the consensus sequence,
    the vote-margin qualities (phred+33 in, raw phred in BAM), and an
    ``rq`` float aux tag (predicted read accuracy = 1 - mean per-base
    error), the tag HiFi consumers expect.  The reference has no BAM
    output (FASTA only, main.c:714)."""

    def __init__(self, path: str):
        self.path = path
        # fail fast on an unwritable path (the container itself is
        # written at close, after hours of compute on real inputs);
        # the container goes to a temp path and is renamed into place
        # at close so a crash mid-run can't leave a zero-byte,
        # EOF-marker-less file at the final path that downstream tools
        # would read as a complete-but-empty run.  The temp name is
        # unique (mkstemp in the target dir, same filesystem for the
        # rename): a fixed path+'.tmp' would leak forever after a crash
        # and let two writers on the same output silently clobber each
        # other's temp before the atomic rename
        import tempfile

        fd, self._tmp = tempfile.mkstemp(
            prefix=os.path.basename(path) + ".tmp.",
            dir=os.path.dirname(os.path.abspath(path)))
        os.close(fd)
        # mkstemp creates 0600; the final BAM must honor the umask like
        # any normally-open()ed output (os.replace preserves the mode)
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(self._tmp, 0o666 & ~umask)
        self._records = []
        self._closed = False

    def put(self, name: str, seq: bytes, qual: bytes | None = None) -> None:
        if self._closed:
            raise ValueError("writer is closed")
        aux = ()
        if qual is not None:
            import numpy as np

            q = np.frombuffer(qual, np.uint8).astype(np.float64) - 33
            rq = 1.0 - float(np.mean(10.0 ** (-q / 10.0))) if len(q) else 0.0
            aux = (("rq", "f", rq),)
        self._records.append((name, seq, qual, aux))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        write_bam(self._tmp, self._records)
        os.replace(self._tmp, self.path)
        self._records = []


def write_bam(path, records, refs=(), bgzf: bool = True) -> None:
    """Tiny BAM writer for tests/fixtures (unmapped records only).

    BGZF container by default, like real subreads.bam; ``bgzf=False``
    writes one plain gzip member (also valid BAM-through-gzip, and
    exercises the native reader's non-BGZF fallback)."""
    import zlib

    out = io.BytesIO()
    text = b"@HD\tVN:1.6\n"
    out.write(b"BAM\x01")
    out.write(struct.pack("<i", len(text)))
    out.write(text)
    out.write(struct.pack("<i", len(refs)))
    for name, ln in refs:
        nm = name.encode() + b"\x00"
        out.write(struct.pack("<i", len(nm)))
        out.write(nm)
        out.write(struct.pack("<i", ln))
    rev = {v: i for i, v in enumerate(SEQ_NT16)}
    for rec in records:
        name, seq, qual = rec[:3]
        aux = rec[3] if len(rec) > 3 else ()   # (tag, type, value) triples
        nm = name.encode() + b"\x00"
        l_seq = len(seq)
        packed = bytearray((l_seq + 1) // 2)
        for i, b in enumerate(seq):
            code = rev.get(b, 15)
            if i % 2 == 0:
                packed[i // 2] |= code << 4
            else:
                packed[i // 2] |= code
        q = bytes((min(max(x - 33, 0), 93) for x in qual)) if qual \
            else b"\xff" * l_seq
        body = struct.pack("<iiBBHHHiiii", -1, -1, len(nm), 255, 0, 0, 4,
                           l_seq, -1, -1, 0)
        body += nm + bytes(packed) + q
        for tag, typ, val in aux:
            tb = tag.encode("ascii")
            if len(tb) != 2:
                raise BamError(f"aux tag must be 2 ASCII chars: {tag!r}")
            body += tb + typ.encode("ascii")
            if typ in _AUX_SCALAR:
                body += struct.pack(_AUX_SCALAR[typ], val)
            elif typ == "A":
                vb = val.encode("ascii")
                if len(vb) != 1:
                    raise BamError(f"aux A value must be 1 char: {val!r}")
                body += vb
            elif typ in "ZH":
                body += val.encode() + b"\x00"
            else:
                raise BamError(f"unsupported aux write type {typ!r}")
        out.write(struct.pack("<i", len(body)))
        out.write(body)
    data = out.getvalue()
    if bgzf:
        write_bgzf(path, data)
    else:
        with open(path, "wb") as fh:
            fh.write(gzip.compress(data))
