"""Minimal-fix sibling for the port's span-force.  MUST produce no
findings through the port's lint."""

import torch

from ccsx_tpu_torch.utils import trace


def dispatch(step, big, small, group):
    with trace.device_span("dispatch", group=group) as sp:
        return sp.force(step(big, small))


def warmup(step, args, group):
    with trace.device_span("warmup", group=group, warmup=True):
        out = step(*args)
        torch.cuda.synchronize()
    return out


def on_stream(step, args, group, device):
    with trace.device_span("dispatch", group=group):
        out = step(*args)
        torch.cuda.current_stream(device).synchronize()
    return out
