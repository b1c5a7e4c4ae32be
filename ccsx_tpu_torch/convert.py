"""Carry-over of state from the JAX package.

This system has no weights: its state is the scoring and pipeline
configuration.  ``config_from_reference`` takes
``dataclasses.asdict(jax_cfg)`` of a ``ccsx_tpu.config.CcsConfig`` (plain
numbers, tuples and strings) and returns this package's ``CcsConfig``.
The device names map as: 'auto'/'tpu' -> 'cuda', 'cpu' -> 'cpu'.
"""

from __future__ import annotations

import dataclasses

from ccsx_tpu_torch.config import AlignParams, CcsConfig

_DEVICE = {"auto": "cuda", "tpu": "cuda", "cuda": "cuda", "cpu": "cpu"}


def config_from_reference(d: dict) -> CcsConfig:
    names = {f.name for f in dataclasses.fields(CcsConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown CcsConfig fields: {unknown}")
    kw = dict(d)
    if "align" in kw:
        align = kw["align"]
        kw["align"] = (align if isinstance(align, AlignParams)
                       else AlignParams(**align))
    if "device" in kw:
        try:
            kw["device"] = _DEVICE[kw["device"]]
        except KeyError:
            raise ValueError(f"device {kw['device']!r}: expected one of "
                             f"{sorted(_DEVICE)}") from None
    if kw.get("exclude_holes") is not None:
        kw["exclude_holes"] = frozenset(kw["exclude_holes"])
    for name in ("pass_buckets", "mesh_shape"):
        if isinstance(kw.get(name), list):
            kw[name] = tuple(kw[name])
    return CcsConfig(**kw)
