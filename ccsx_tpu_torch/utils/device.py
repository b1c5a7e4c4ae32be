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


def local_devices(device) -> list:
    """The devices a run on ``device`` may spread over: every card of this
    host (``cuda:0`` .. ``cuda:n-1``) for a CUDA device, ``[cpu]`` for the
    CPU — the counterpart of ``jax.local_devices()`` and the one place that
    counts them.  A sharded rank's devices are its own host's: the ranks
    share nothing."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]
