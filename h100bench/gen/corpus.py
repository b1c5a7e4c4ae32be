"""A cell's corpus: its holes as a BGZF ``subreads.bam``, made from the seed.

The corpus of (cell, seed) is ``pool_holes`` holes of the hole model
(gen/holes.py) written as unaligned PacBio subread records
(``movie/hole/start_end``, no qualities, as a subread BAM has), with a
manifest of each hole's pass lengths and kinds.  It lives in one fixed
directory a cell inside the checkout, so a second run of the same cell and
seed reuses it, and a new seed replaces it (one corpus a cell on disk).

Worker processes (spawned, joined before this returns) make the holes and
compress the BGZF blocks; the header is a block of its own, so the
workers' block runs concatenate into one valid file.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
import struct
import time
import zlib
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from h100bench.gen import holes as holes_mod

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_PAYLOAD = 0xFF00
CHUNK_HOLES = 32
# 2-bit code -> BAM 4-bit nucleotide (A=1 C=2 G=4 T=8)
_NT16 = np.array([1, 2, 4, 8], np.uint8)


def bgzf_blocks(data: bytes, level: int = 1) -> bytes:
    out = []
    for i in range(0, len(data), _PAYLOAD):
        chunk = data[i:i + _PAYLOAD]
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = 18 + len(comp) + 8 - 1
        out.append(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
                   + struct.pack("<H", 6) + b"BC"
                   + struct.pack("<HH", 2, bsize) + comp
                   + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    return b"".join(out)


def bam_header() -> bytes:
    text = b"@HD\tVN:1.6\tSO:unknown\n"
    return (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 0))


def bam_record(name: str, codes: np.ndarray) -> bytes:
    """One unmapped BAM record: the name, the 4-bit bases, no qualities."""
    nm = name.encode() + b"\x00"
    n = len(codes)
    nib = _NT16[codes]
    if n % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8).tobytes()
    body = (struct.pack("<iiBBHHHiiii", -1, -1, len(nm), 255, 4680, 0, 4,
                        n, -1, -1, 0)
            + nm + packed + b"\xff" * n)
    return struct.pack("<i", len(body)) + body


def hole_records(movie: str, hole: holes_mod.Hole) -> bytes:
    out = []
    off = 0
    for p in hole.passes:
        out.append(bam_record(f"{movie}/{hole.index}/{off}_{off + len(p)}",
                              p))
        off += len(p)
    return b"".join(out)


def _make_chunk(seed, lo, hi, mix, errors, movie):
    """Holes [lo, hi): their BGZF blocks and manifest rows."""
    recs = []
    plens, kinds, tlens = [], [], []
    for i in range(lo, hi):
        h = holes_mod.make_hole(seed, i, mix, errors)
        recs.append(hole_records(movie, h))
        plens.append(np.array([len(p) for p in h.passes], np.int32))
        kinds.append(np.array(h.kinds, np.int8))
        tlens.append(len(h.template))
    return (bgzf_blocks(b"".join(recs)), plens, kinds,
            np.array(tlens, np.int32))


class Manifest:
    """Each hole's pass lengths and kinds and template length."""

    def __init__(self, pass_lens, pass_kinds, offsets, tlens):
        self.pass_lens = pass_lens
        self.pass_kinds = pass_kinds
        self.offsets = offsets
        self.tlens = tlens
        self.hole_bases = np.add.reduceat(
            pass_lens.astype(np.int64), offsets[:-1]) if len(tlens) \
            else np.zeros(0, np.int64)

    @property
    def n_holes(self) -> int:
        return len(self.tlens)

    def passes(self, i: int):
        s = slice(int(self.offsets[i]), int(self.offsets[i + 1]))
        return self.pass_lens[s], self.pass_kinds[s]

    def save(self, path: str) -> None:
        np.savez(path, pass_lens=self.pass_lens, pass_kinds=self.pass_kinds,
                 offsets=self.offsets, tlens=self.tlens)

    @classmethod
    def load(cls, path: str) -> "Manifest":
        z = np.load(path)
        return cls(z["pass_lens"], z["pass_kinds"], z["offsets"], z["tlens"])


def corpus_key(seed: int, n_holes: int, mix: dict, errors: dict,
               movie: str) -> str:
    """What the corpus is made from: the arguments and the generator's own
    source, so that a changed generator never reuses an old corpus."""
    h = hashlib.sha256(json.dumps([int(seed), n_holes, mix, errors, movie],
                                  sort_keys=True).encode())
    for mod in (holes_mod.__file__, __file__):
        with open(mod, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:24]


def build(directory: str, seed: int, n_holes: int, mix: dict, errors: dict,
          movie: str, workers: int = 0):
    """Make (or reuse) the corpus in ``directory``: returns (bam path,
    Manifest, seconds spent making it, whether it was reused)."""
    t0 = time.perf_counter()
    key = corpus_key(seed, n_holes, mix, errors, movie)
    bam = os.path.join(directory, "subreads.bam")
    man = os.path.join(directory, "manifest.npz")
    stamp = os.path.join(directory, "key")
    try:
        with open(stamp) as f:
            if f.read().strip() == key and os.path.exists(bam):
                return bam, Manifest.load(man), time.perf_counter() - t0, True
    except OSError:
        pass
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    workers = workers or min(8, os.cpu_count() or 1)
    # chunks of a fixed size, so the bytes do not depend on the workers
    bounds = [(lo, min(lo + CHUNK_HOLES, n_holes))
              for lo in range(0, n_holes, CHUNK_HOLES)]
    plens, kinds, tlens = [], [], []
    tmp = bam + ".part"
    with open(tmp, "wb") as f:
        f.write(bgzf_blocks(bam_header()))
        if workers > 1 and len(bounds) > 1:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(workers, mp_context=ctx) as ex:
                futs = [ex.submit(_make_chunk, seed, lo, hi, mix, errors,
                                  movie) for lo, hi in bounds]
                parts = (fu.result() for fu in futs)
                for blocks, pl, kd, tl in parts:
                    f.write(blocks)
                    plens += pl
                    kinds += kd
                    tlens.append(tl)
        else:
            for lo, hi in bounds:
                blocks, pl, kd, tl = _make_chunk(seed, lo, hi, mix, errors,
                                                 movie)
                f.write(blocks)
                plens += pl
                kinds += kd
                tlens.append(tl)
        f.write(BGZF_EOF)
        # on disk before the window opens, so that no write-back of it
        # runs inside the window
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, bam)
    offsets = np.zeros(n_holes + 1, np.int64)
    np.cumsum([len(p) for p in plens], out=offsets[1:])
    manifest = Manifest(np.concatenate(plens), np.concatenate(kinds),
                        offsets, np.concatenate(tlens))
    manifest.save(man)
    with open(stamp, "w") as f:
        f.write(key + "\n")
    return bam, manifest, time.perf_counter() - t0, False
