"""Known-bad twin for the port's int32-overflow: the interpolation on int32
tensors, as the JAX package's pre-fix code wrote it."""

import torch


def nominal_line(i, li0, lj0, li1, lj1):
    i = i.to(torch.int32)
    return lj0 + (i - li0) * (lj1 - lj0) // torch.clamp(li1 - li0, min=1)


def pack_key(hole_id, bits):
    return hole_id.to(torch.int32) << bits
