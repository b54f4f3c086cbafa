"""The port's --aug-cfg (``multimodal_tpu_torch.data.augment``) against the JAX package's:
``parse_aug_cfg`` (its warnings too) and ``apply_pixel_augment`` from the same generator
state, bit for bit, with the generators left in the same state."""

import logging

import numpy as np
import pytest

from multimodal_tpu.data import augment as jax_aug
from multimodal_tpu_torch.data import augment

CFGS = [
    {"scale": (0.5, 1.0)},
    {"scale": 0.8, "ratio": (0.5, 2.0)},
    {"color_jitter": 0.4},
    {"color_jitter": (0.2, 0.0, 0.3), "color_jitter_prob": 0.5},
    {"color_jitter": 0.0},
    {"hflip": 0.5, "gray_scale_prob": 0.3},
    {"grayscale_prob": 0.4, "re_prob": 0.25},
    {"color_jitter": 0.4, "re_prob": 0.25, "re_count": 2, "use_timm": True},
    {"interpolation": "bilinear", "auto_augment": "rand-m9", "re_prob": 0.5},
]


def _fields(cfg):
    return None if cfg is None else {k: getattr(cfg, k) for k in vars(cfg)}


@pytest.mark.parametrize("cfg", CFGS + [{}, None])
def test_parse_aug_cfg_matches_jax(cfg):
    got, want = augment.parse_aug_cfg(cfg), jax_aug.parse_aug_cfg(cfg)
    assert _fields(got) == _fields(want)
    if got is not None:
        assert got.has_pixel_aug == want.has_pixel_aug


def test_parse_aug_cfg_warns_like_jax(caplog):
    cfg = {"interpolation": "bilinear", "auto_augment": "rand-m9", "mixup": 0.2}
    with caplog.at_level(logging.WARNING):
        augment.parse_aug_cfg(cfg)
    got = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jax_aug.parse_aug_cfg(cfg)
    want = [r.getMessage() for r in caplog.records]
    assert got == want and len(got) == 2
    assert "IGNORED" in got[1] and "'auto_augment'" in got[1]


def test_parsed_config_passes_through():
    cfg = augment.parse_aug_cfg({"re_prob": 0.5})
    assert augment.parse_aug_cfg(cfg) is cfg


@pytest.mark.parametrize("cfg", CFGS[2:])
def test_apply_pixel_augment_matches_jax_bit_for_bit(cfg):
    batch = np.random.default_rng(0).integers(0, 256, (6, 24, 20, 3), dtype=np.uint8)
    got_rng, want_rng = np.random.default_rng(5), np.random.default_rng(5)
    got = augment.apply_pixel_augment(batch.copy(), got_rng, augment.parse_aug_cfg(cfg))
    want = jax_aug.apply_pixel_augment(batch.copy(), want_rng, jax_aug.parse_aug_cfg(cfg))
    np.testing.assert_array_equal(got, want)
    assert got_rng.integers(2**62) == want_rng.integers(2**62)  # same draws consumed
