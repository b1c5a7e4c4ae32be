"""Device resolution: the card unless the caller asks for the CPU.

There is no fallback: asking for ``cuda`` on a host without a usable card
raises, so a run never silently computes on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(requested: str = "cuda") -> torch.device:
    """'cuda' (also what 'auto' means) or 'cpu' -> torch.device."""
    if requested in ("cuda", "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run the plain CPU path")
        return torch.device("cuda")
    if requested == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device {requested!r}: expected 'cuda' or 'cpu'")
