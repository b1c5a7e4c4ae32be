"""FASTA/FASTQ parser (plain or gzip), kseq-equivalent semantics.

Replicates the behavior of the reference's kseq.h state machine
(kseq.h:177-218): records start at '>' or '@'; sequence may span multiple
lines; FASTQ quality runs until it reaches sequence length; name is the first
whitespace-delimited token, the rest is the comment.  This is the Python
fallback path; the hot path is the native C++ reader (ccsx_tpu/native).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import zlib
from typing import Iterator, Optional, Union

from ccsx_tpu_torch.io.corruption import CorruptionError


class FastxError(CorruptionError):
    """Classified FASTA/FASTQ parse failure (io/corruption.py
    taxonomy); subclasses CorruptionError(ValueError), so pre-taxonomy
    ``except ValueError`` handlers still work."""


@dataclasses.dataclass
class FastxRecord:
    name: str
    comment: str
    seq: bytes
    qual: Optional[bytes]  # None for FASTA


def format_record(name: str, seq: bytes,
                  qual: Optional[bytes] = None) -> "tuple[str, int]":
    """(text, nbytes) of ONE output record — FASTA (2-line) without
    ``qual``, FASTQ (4-line) with it.  THE single formatter both output
    writers share (pipeline/run._PyWriter, parallel ShardWriter):
    nbytes is the UTF-8-encoded length, which feeds journal v2's
    torn-tail truncation offsets, so format and accounting must never
    diverge between drivers."""
    if qual is None:
        rec = f">{name}\n{seq.decode()}\n"
    else:
        rec = f"@{name}\n{seq.decode()}\n+\n{qual.decode()}\n"
    return rec, len(rec.encode("utf-8"))


def _open(path_or_file) -> io.BufferedReader:
    if hasattr(path_or_file, "read"):
        f = path_or_file
        if not hasattr(f, "peek"):  # e.g. raw BytesIO: make it peekable
            f = io.BufferedReader(f)
        # transparently un-gzip file objects too
        if f.peek(2)[:2] == b"\x1f\x8b":
            return io.BufferedReader(gzip.GzipFile(fileobj=f))
        return f
    path = str(path_or_file)
    f = open(path, "rb")
    if f.peek(2)[:2] == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


class _SalvageLines:
    """readline() wrapper that classifies a corrupt/truncated gzip
    stream into the salvage sink (the rest of a broken deflate stream
    is unrecoverable — no block structure to resync on) instead of
    raising mid-parse."""

    def __init__(self, f, sink):
        self._f = f
        self._sink = sink

    def readline(self) -> bytes:
        try:
            return self._f.readline()
        except (OSError, EOFError, zlib.error):
            self._sink.record("gzip_truncated")
            return b""


def read_fastx(path_or_file, salvage=None) -> Iterator[FastxRecord]:
    """Stream records from a FASTA/FASTQ file (gzip transparent).

    ``salvage`` (a corruption.SalvageSink) selects salvage mode: a
    classified corruption — FASTQ quality/sequence length mismatch,
    stream truncation — books an event and the parser RESYNCS to the
    next line starting with '>'/'@' (the same line-anchored resync the
    native reader implements) instead of raising.  Without it, the
    historical fail-fast raise is preserved."""
    f = _open(path_or_file)
    if salvage is not None:
        f = _SalvageLines(f, salvage)
    line = f.readline()
    # skip leading junk until a record marker (kseq skips to '>'/'@')
    while line and line[:1] not in (b">", b"@"):
        line = f.readline()
    while line:
        marker = line[:1]
        header = line[1:].rstrip(b"\r\n")
        parts = header.split(None, 1)
        name = parts[0].decode() if parts else ""
        comment = parts[1].decode() if len(parts) > 1 else ""
        seq_parts = []
        line = f.readline()
        while line and line[:1] not in (b">", b"@", b"+"):
            seq_parts.append(line.strip())
            line = f.readline()
        seq = b"".join(seq_parts)
        qual = None
        # kseq parity: a '+' line starts a quality section after ANY record,
        # even a '>' one (kseq.h:196 checks only for '+'); quality is
        # reported only for FASTQ records.
        if line[:1] == b"+":
            # quality: read until length matches seq (kseq.h:203-211)
            qual_parts = []
            got = 0
            line = f.readline()
            while line and got < len(seq):
                chunk = line.strip()
                qual_parts.append(chunk)
                got += len(chunk)
                line = f.readline()
            qual = b"".join(qual_parts)
            if len(qual) != len(seq):
                if salvage is not None:
                    # shorter = the stream ended under the record
                    # (truncation); longer = a damaged quality section.
                    # Book it, drop the record, resync to the next
                    # '>'/'@' line anchor (fastx.py:61 primitive)
                    salvage.record("fastx_truncated"
                                   if len(qual) < len(seq)
                                   else "fastx_qual_mismatch")
                    while line and line[:1] not in (b">", b"@"):
                        line = f.readline()
                    continue
                raise FastxError(
                    "fastx_qual_mismatch",
                    f"FASTQ record {name}: quality length {len(qual)} != "
                    f"sequence length {len(seq)}"
                )
            if marker != b"@":
                qual = None
        yield FastxRecord(name=name, comment=comment, seq=seq, qual=qual)
