"""What decides ``correct``: the records the window emitted, held to the
plain reference (h100bench/reference) and to the guarantee of one record
per admitted hole that passes the filters, in admission order.

* ``order_faults``: records of no admitted hole, second records of a hole,
  and records behind a later hole's (every record of the window);
* ``mismatched_records``: of the holes checked, those whose record (or its
  absence) is not the reference's, byte for byte.  The holes checked are
  ``sample_holes`` admitted holes drawn from the seed, the admitted hole
  with the most subread bases, and up to ``sample_holes`` admitted holes
  the program wrote no record for.  The reference makes each one again
  from the seed and its corpus index, as the corpus did.

Both limits are 0: the comparison is exact.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from h100bench.gen import holes as holes_mod
from h100bench.harness.window import order_faults
from h100bench.reference import driver

LIMITS = {"mismatched_records": 0, "order_faults": 0}
# the CLI's flags that state what the algorithm computes, each the
# reference's own setting; a configuration may set no other flag
_FLAGS = {"-m": "min_len", "-M": "max_len", "-c": "min_count",
          "--refine-iters": "refine_iters", "--max-passes": "max_passes"}


def params(config: dict, device: str = "cuda", **over) -> driver.Params:
    """The reference's settings from a configuration's CLI flags."""
    kw = {}
    flags = list(config.get("flags", []))
    for f, v in zip(flags[0::2], flags[1::2]):
        if f not in _FLAGS:
            raise ValueError(f"flag {f!r} has no reference setting")
        kw[_FLAGS[f]] = int(v)
    if len(flags) % 2:
        raise ValueError(f"flag {flags[-1]!r} has no value")
    kw.update(over)
    return driver.Params(device=device, **kw)


def decode(codes) -> Optional[str]:
    if codes is None or not len(codes):
        return None
    return np.frombuffer(b"ACGTN-", np.uint8)[np.asarray(codes)].tobytes(
    ).decode()


def chosen(seed: int, admitted: List[Tuple[str, int]], emitted: Dict,
           manifest, k: int) -> List[int]:
    """Positions (in admission order) of the holes checked."""
    n = len(admitted)
    if not n:
        return []
    rng = np.random.default_rng([int(seed) & (2 ** 63 - 1), 1])
    pos = [int(x) for x in rng.choice(n, size=min(k, n), replace=False)]
    bases = manifest.hole_bases[[i for _, i in admitted]]
    pos.append(int(np.argmax(bases)))
    missing = [p for p, (h, _) in enumerate(admitted) if h not in emitted]
    pos += missing[:k]
    return sorted(set(pos))


def check(records: List[Tuple[str, str]], admitted: List[Tuple[str, int]],
          manifest, seed: int, mix: dict, config: dict,
          device: str = "cuda") -> dict:
    """The numbers compared, each with its limit, and what was checked."""
    emitted = {}
    names = []
    for name, seq in records:
        parts = name.split("/")
        hole = parts[1] if len(parts) == 3 else name
        names.append(hole)
        emitted.setdefault(hole, seq)
    faults = order_faults([h for h, _ in admitted], names)
    pos = chosen(seed, admitted, emitted, manifest, int(mix["sample_holes"]))
    errors = config["errors"]
    inputs = {}
    for p in pos:
        idx = admitted[p][1]
        if idx not in inputs:
            inputs[idx] = holes_mod.make_hole(seed, idx, mix, errors).passes
    t0 = time.perf_counter()
    ref = driver.consensus(inputs, params(config, device))
    ref_s = time.perf_counter() - t0
    bad = sum(decode(ref[admitted[p][1]]) != emitted.get(admitted[p][0])
              for p in pos)
    return {"numbers": {"mismatched_records": bad, "order_faults": faults},
            "checked": len(pos), "reference_s": ref_s}


def verdict(numbers: Dict[str, int]) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
