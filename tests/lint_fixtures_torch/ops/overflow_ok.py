"""Minimal-fix sibling for the port's int32-overflow: the wrapping
expressions through torch's int64 promotions.  MUST produce no findings
through the port's lint."""

import torch


def interp_long(ip, span, denom):
    return (ip.long() * span.long()) // denom


def interp_to_int64(ip, span, denom):
    wide = ip.to(torch.int64) * span.to(torch.int64) // denom
    return wide.to(torch.int32)


def pack_key(hole_id, bits):
    return hole_id.long() << bits
