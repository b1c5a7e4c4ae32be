"""The strand walk (NumPy): which passes a hole's consensus uses, on which
strand and clipped where.

Subread lengths are clustered into groups within 10% of a group's mean
(joined transitively, largest first); a larger-length group of at least 4/5
the largest one's size replaces it as the template group unless the
reverse complement of a 1,000-base border of its median member aligns to
the rest of that read at 70% identity (a palindrome or an adapter).  The
template is the template group's median member.  Walking outward from it
in both directions, the expected strand alternates; passes of the template
group are trusted by parity until an event makes the walk doubtful (a pass
outside the group, or a failed check); then each pass is checked against
the template, forward then reverse complemented, at 75% identity, clipped
to the aligned query span and kept if the clipped length is still in the
template group.  Out-of-group passes shorter than the template are skipped.

The walk is a generator: it yields ``PairRequest``s and receives
``(ok, Match)`` for each.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

GROUP_TOLERANCE_PCT = 10
STRAND_IDENTITY_PCT = 75
BORDER_IDENTITY_PCT = 70
BORDER_LEN = 1000
BORDER_MIN_TEMPLATE = 2000


def revcomp(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.uint8)
    return np.where(codes < 4, 3 - codes, codes)[::-1].copy()


@dataclasses.dataclass
class Group:
    ids: List[int]
    sum_len: int

    @property
    def size(self) -> int:
        return len(self.ids)


def len_in_group(g: Group, length: int, tol: int) -> bool:
    return abs(length * g.size - g.sum_len) * 100 < tol * g.sum_len


def group_in_group(a: Group, b: Group, tol: int) -> bool:
    ma = a.sum_len * b.size
    mb = b.sum_len * a.size
    return abs(ma - mb) * 100 < ma * tol


def group_lens(lens, tol: int = GROUP_TOLERANCE_PCT) -> List[Group]:
    n = len(lens)
    groups = [Group([], 0) for _ in range(n)]
    for i in range(n):
        placed = False
        create_at = None
        for j in range(n):
            if groups[j].size == 0:
                create_at = j
                break
            if groups[j].sum_len == 0:
                continue
            if len_in_group(groups[j], int(lens[i]), tol):
                groups[j].ids.append(i)
                groups[j].sum_len += int(lens[i])
                placed = True
                break
        if not placed:
            groups[create_at].ids.append(i)
            groups[create_at].sum_len = int(lens[i])
    changed = True
    while changed:
        changed = False
        for j in range(n):
            if groups[j].size == 0:
                continue
            for k in range(j):
                if groups[k].size and group_in_group(groups[k], groups[j],
                                                     tol):
                    groups[k].ids.extend(groups[j].ids)
                    groups[k].sum_len += groups[j].sum_len
                    groups[j] = Group([], 0)
                    changed = True
                    break
    out = [g for g in groups if g.size > 0]
    out.sort(key=lambda g: -g.size)
    return out


@dataclasses.dataclass
class Segment:
    offs: int
    length: int
    reverse: bool


@dataclasses.dataclass
class PairRequest:
    q: np.ndarray
    t: np.ndarray
    pct: int


def template_group(codes, lens, offs, groups: List[Group]):
    tg = 0
    if groups[0].size < 2:
        return 0
    bl = BORDER_LEN
    for cg in range(1, len(groups)):
        g = groups[cg]
        if g.size < 2 or g.size * 5 < 4 * groups[0].size:
            continue
        ci = g.ids[g.size // 2]
        clen = int(lens[ci])
        cur = groups[tg]
        cur_med = int(lens[cur.ids[cur.size // 2]])
        if clen <= cur_med or clen <= BORDER_MIN_TEMPLATE:
            continue
        start = int(offs[ci])
        read = codes[start:start + clen]
        ok, _ = yield PairRequest(revcomp(read[:bl]), read[bl:],
                                  BORDER_IDENTITY_PCT)
        if ok:
            continue
        ok, _ = yield PairRequest(revcomp(read[clen - bl:]),
                                  read[:clen - bl], BORDER_IDENTITY_PCT)
        if ok:
            continue
        tg = cg
    return tg


def walk(codes, lens, offs):
    """The segments of the consensus's passes, the template first."""
    tol = GROUP_TOLERANCE_PCT
    groups = group_lens(lens, tol)
    map_group = {}
    for gi, g in enumerate(groups):
        for i in g.ids:
            map_group[i] = gi
    tgi = yield from template_group(codes, lens, offs, groups)
    tg = groups[tgi]
    template_i = tg.ids[tg.size // 2]
    t_offs = int(offs[template_i])
    t_len = int(lens[template_i])
    tseq = codes[t_offs:t_offs + t_len]
    t2seq = revcomp(tseq)
    segments = [Segment(t_offs, t_len, False)]

    def side(indices):
        reverse = False
        adjust = False
        for k in indices:
            reverse = not reverse
            seg = Segment(int(offs[k]), int(lens[k]), reverse)
            if map_group[k] != tgi:
                adjust = True
                if seg.length < t_len:
                    continue
            elif not adjust:
                segments.append(seg)
                continue
            qseq = codes[seg.offs:seg.offs + seg.length]
            ok_r, rs_r = False, None
            ok_f, rs = yield PairRequest(qseq, tseq, STRAND_IDENTITY_PCT)
            if not ok_f:
                ok_r, rs_r = yield PairRequest(qseq, t2seq,
                                               STRAND_IDENTITY_PCT)
            if ok_f:
                reverse = False
            elif ok_r:
                reverse, rs = True, rs_r
            else:
                adjust = True
                continue
            clipped = Segment(seg.offs + rs.qb, rs.qe - rs.qb, reverse)
            if len_in_group(groups[tgi], clipped.length, tol):
                segments.append(clipped)
            adjust = map_group[k] != tgi

    yield from side(range(template_i - 1, -1, -1))
    yield from side(range(template_i + 1, len(lens)))
    return segments


def oriented(codes, seg: Segment) -> np.ndarray:
    s = codes[seg.offs:seg.offs + seg.length]
    return revcomp(s) if seg.reverse else s
