"""The carry-over of state: config_from_reference builds the port's
CcsConfig from dataclasses.asdict of the JAX package's config."""

import dataclasses

import pytest

from ccsx_tpu.config import AlignParams as JaxParams
from ccsx_tpu.config import CcsConfig as JaxConfig

from ccsx_tpu_torch.config import AlignParams, CcsConfig
from ccsx_tpu_torch.convert import config_from_reference


def _without_device(d):
    return {k: v for k, v in d.items() if k != "device"}


def test_defaults_round_trip():
    ref = dataclasses.asdict(JaxConfig())
    cfg = config_from_reference(ref)
    assert isinstance(cfg.align, AlignParams)
    assert cfg.device == "cuda"
    assert _without_device(dataclasses.asdict(cfg)) == _without_device(ref)
    assert _without_device(dataclasses.asdict(CcsConfig())) == \
        _without_device(ref)
    assert cfg.qv_coeffs == JaxConfig().qv_coeffs
    assert cfg.min_pass_count == JaxConfig().min_pass_count


def test_non_default_round_trip():
    jcfg = JaxConfig(min_subread_len=1000, max_subread_len=90000,
                     min_fulllen_count=4, split_subread=False, is_bam=False,
                     exclude_holes=frozenset({"3", "7"}), threads=3,
                     refine_iters=1, max_passes=16, emit_quality=True,
                     qv_per_hp=5.0, pass_buckets=(8, 16),
                     align=JaxParams(match=3, mismatch=-5, gap_open=-4,
                                     gap_extend=-1), device="cpu")
    ref = dataclasses.asdict(jcfg)
    cfg = config_from_reference(ref)
    assert cfg.device == "cpu"
    assert dataclasses.asdict(cfg) == ref
    assert cfg.align == AlignParams(3, -5, -4, -1, 128)
    assert cfg.exclude_holes == frozenset({"3", "7"})


def test_rejects_unknown_fields_and_devices():
    ref = dataclasses.asdict(JaxConfig())
    with pytest.raises(ValueError):
        config_from_reference(dict(ref, not_a_field=1))
    with pytest.raises(ValueError):
        config_from_reference(dict(ref, device="gpu0"))
