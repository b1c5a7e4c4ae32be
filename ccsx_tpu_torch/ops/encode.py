"""Base encoding/decoding and reverse-complement.

Code space (used across the whole framework, incl. MSA matrices):
  0..3  = A C G T
  4     = gap (in MSA columns) / N (in raw sequence encode)
  5     = PAD: row/column padding, never a real observation

The reference encodes with bsalign's ``base_bit_table`` (A=0 C=1 G=2 T=3,
other=4; main.c:231,237) and its MSA uses the same 0-3 base / >=4 gap codes
(main.c:583-598,635-636).  ASCII reverse-complement mirrors ``seq_comp_table``
/ ``seq_reverse_comp`` (seqio.h:120-148).
"""

from __future__ import annotations

import numpy as np

A, C, G, T = 0, 1, 2, 3
GAP = 4
PAD = 5

BASES = "ACGTN-"

# ASCII -> 2-bit (A/a=0, C/c=1, G/g=2, T/t=3, everything else=4=N)
_ENC = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate("ACGT"):
    _ENC[ord(_b)] = _i
    _ENC[ord(_b.lower())] = _i

# ASCII complement table (A<->T, C<->G, case preserved, others unchanged),
# matching seq_comp_table's behavior for the DNA alphabet (seqio.h:120-137).
_COMP = np.arange(256, dtype=np.uint8)
for _x, _y in [("A", "T"), ("C", "G"), ("G", "C"), ("T", "A"),
               ("a", "t"), ("c", "g"), ("g", "c"), ("t", "a"),
               ("U", "A"), ("u", "a"), ("N", "N"), ("n", "n")]:
    _COMP[ord(_x)] = ord(_y)

# 2-bit decode
_DEC = np.frombuffer(BASES.encode(), dtype=np.uint8)


def encode(seq: bytes | str) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0-3 bases, 4 for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _ENC[np.frombuffer(seq, dtype=np.uint8)]


def decode(codes: np.ndarray) -> str:
    """uint8 codes -> ASCII string (4 -> 'N', 5 -> '-')."""
    return _DEC[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def to_record(result):
    """Normalize a consensus-generator result into a writable record.

    codes -> (seq_bytes, None); (codes, phred_quals) -> (seq_bytes,
    phred+33 ASCII bytes); None -> None.  The quality tuple form is
    produced under CcsConfig.emit_quality (--fastq)."""
    if result is None:
        return None
    if isinstance(result, tuple):
        codes, quals = result
        qual = (np.asarray(quals, dtype=np.uint8) + 33).tobytes()
        return decode(codes).encode(), qual
    return decode(result).encode(), None


def revcomp_ascii(seq: bytes) -> bytes:
    """Reverse-complement of an ASCII sequence (seq_reverse_comp, seqio.h:138-148)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _COMP[arr[::-1]].tobytes()


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse-complement of 2-bit codes; N (4) maps to itself.

    The reference computes ``3 - base_bit_table[b]`` (main.c:231); we guard N.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    out = np.where(codes < 4, 3 - codes, codes)
    return out[::-1].copy()
