"""Corruption taxonomy + salvage plumbing for the ingest plane.

The readers used to be all-or-nothing: any corrupt byte in a BAM/FASTA/
BGZF stream raised a bare error and the whole run died with every
healthy hole unemitted.  This module pins the failure taxonomy — every
way the Python AND native readers can fail gets a stable reason code,
shared by both stacks (io_native.cpp mirrors REASONS verbatim; the
differential fuzz tests hold the two stacks to the same classification
on the same mutant) — and carries the salvage-mode accounting.

Reason codes (pinned; tests/test_salvage.py::test_reason_codes_pinned):

  bam_bad_header       BAM magic/header region unparseable
  bgzf_bad_block       malformed BGZF block header (magic/BC/BSIZE)
  bgzf_bad_deflate     a BGZF block's payload failed inflate/CRC/ISIZE
  bgzf_torn_tail       BGZF stream truncated mid-block
  bgzf_missing_eof     the 28-byte BGZF EOF marker is absent at stream
                       end.  Booked + degrades the run, but EXEMPT from
                       the --max-failed-holes budget: a healthy file
                       that merely lost its marker emits every hole
                       intact, and spending budget on it would rc-2 a
                       complete output (a truncation exactly at a block
                       boundary is indistinguishable — that risk is
                       inherent to the marker's design)
  gzip_truncated       plain-gzip stream truncated or corrupt (no block
                       structure to resync on: the rest of the stream
                       is lost)
  bam_bad_record       corrupt alignment-record fields (bad length,
                       negative l_seq, fields overflowing the block)
  bam_record_oversize  record length exceeds --max-record-bytes — the
                       allocation bound (a corrupt int32 must not
                       drive a multi-GB allocation)
  fastx_qual_mismatch  FASTQ quality length != sequence length
  fastx_truncated      FASTA/Q stream ended mid-record
  zmw_bad_name         subread name not movie/hole/region
  injected             the ``input_corrupt`` fault point
                       (utils/faultinject.py)

Salvage semantics (``--salvage``): a classified corruption drops the
damaged bytes and the reader RESYNCS — BGZF: scan forward for the next
valid block header (magic + BC subfield + a BSIZE that chains to
another block header or EOF); BAM records: scan the inflated stream
for the next plausible record start (see ``record_plausible``); FASTA/
Q: skip to the next '>'/'@' line anchor.  Surviving records flow on:
a hole that lost records emits a consensus from its surviving passes
(it is damaged either way — the oracle only constrains UNDAMAGED
holes), every event books into Metrics.holes_corrupt with per-reason
buckets, the run is marked degraded, and corrupt events feed the
--max-failed-holes budget.  Salvage OFF (the default) preserves the
historical fail-fast behavior byte-for-byte: first classified
corruption raises and the run exits rc 1.
"""

from __future__ import annotations

import struct

REASONS = (
    "bam_bad_header",
    "bgzf_bad_block",
    "bgzf_bad_deflate",
    "bgzf_torn_tail",
    "bgzf_missing_eof",
    "gzip_truncated",
    "bam_bad_record",
    "bam_record_oversize",
    "fastx_qual_mismatch",
    "fastx_truncated",
    "zmw_bad_name",
    "injected",
)

# reasons that degrade the run but do NOT spend the --max-failed-holes
# budget (no hole is provably lost; see the taxonomy notes above)
NON_BUDGET_REASONS = ("bgzf_missing_eof",)

# allocation bound on a single BAM alignment record (--max-record-bytes):
# checked BEFORE allocating, so a corrupt int32 length cannot drive a
# multi-GB allocation.  256 MiB is far above any real subread record
# (a 500 kb subread is ~0.75 MB of block) but far below damage.
DEFAULT_MAX_RECORD_BYTES = 256 * 1024 * 1024


class CorruptionError(ValueError):
    """A classified ingest corruption.  ``reason`` is one of REASONS —
    the stable code both reader stacks report for this failure mode."""

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


class SalvageSink:
    """Salvage-mode accounting shared by the Python readers: every
    classified corruption books one event here.  ``metrics`` (optional,
    a utils.metrics.Metrics) receives holes_corrupt / corrupt_reasons
    live plus the degraded mark — the native reader books the same
    counters from its in-library counts (native/io.py)."""

    def __init__(self, metrics=None, max_record_bytes: int = 0):
        self.metrics = metrics
        self.max_record_bytes = max_record_bytes or DEFAULT_MAX_RECORD_BYTES
        self.events = 0
        self.reasons: dict = {}

    def record(self, reason: str, detail: str = "") -> None:
        self.events += 1
        self.reasons[reason] = self.reasons.get(reason, 0) + 1
        m = self.metrics
        if m is not None:
            m.bump(holes_corrupt=1)
            with m._count_lock:
                m.corrupt_reasons[reason] = (
                    m.corrupt_reasons.get(reason, 0) + 1)
            if not m.degraded:
                m.degraded = "input corruption (salvaged)"


# ---- BAM record plausibility (the record-resync scan contract) ----------
#
# After a BGZF gap or a corrupt record, salvage scans the inflated
# stream byte-by-byte for the next plausible alignment-record start.
# The predicate below IS the contract — io_native.cpp implements the
# same checks with the same constants, and the differential fuzz test
# holds both stacks to the same salvaged record set.  A candidate at
# offset p (p points at the record's 4-byte block_size) passes iff:
#
#   * 34 <= block_size <= max_record_bytes   (32 fixed + 2-byte name)
#   * refid == -1 or 0 <= refid < 100000
#   * pos >= -1
#   * l_read_name >= 2                        (1+ chars + NUL)
#   * l_seq >= 0
#   * 32 + l_read_name + 4*n_cigar + (l_seq+1)//2 + l_seq <= block_size
#   * name bytes are printable ASCII (0x21..0x7E) ending in NUL
#
# SCAN_LOOKAHEAD bytes suffice to evaluate any candidate (4 + 32 fixed
# + 255-byte max name).

SCAN_LOOKAHEAD = 4 + 32 + 255
MIN_RECORD_BLOCK = 34


def record_plausible(buf, p: int, max_record_bytes: int) -> bool:
    """True when ``buf[p:]`` plausibly starts a BAM alignment record
    (the salvage resync predicate; see the contract above).  ``buf``
    must hold at least SCAN_LOOKAHEAD bytes past p, or reach the true
    end of the stream."""
    if len(buf) - p < 36:
        return False
    (block_size,) = struct.unpack_from("<i", buf, p)
    if not MIN_RECORD_BLOCK <= block_size <= max_record_bytes:
        return False
    refid, pos = struct.unpack_from("<ii", buf, p + 4)
    if not (refid == -1 or 0 <= refid < 100000) or pos < -1:
        return False
    lrn = buf[p + 12]
    if lrn < 2:
        return False
    (n_cigar,) = struct.unpack_from("<H", buf, p + 16)
    (l_seq,) = struct.unpack_from("<i", buf, p + 20)
    if l_seq < 0:
        return False
    if 32 + lrn + 4 * n_cigar + (l_seq + 1) // 2 + l_seq > block_size:
        return False
    name = buf[p + 36:p + 36 + lrn]
    if len(name) < lrn:
        return False
    if name[-1] != 0:
        return False
    for b in name[:-1]:
        if not 0x21 <= b <= 0x7E:
            return False
    return True
