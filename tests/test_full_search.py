"""Decision parity of the device full search (ops/me.full_search) vs the
golden per-block search (golden/me.full_search): identical MVs (tie-breaks
included), SADs and motion-compensated predictions."""

import types

import numpy as np
import pytest

import jax.numpy as jnp

from basic_video_codec_tpu.golden import me as gme
from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
from basic_video_codec_tpu.ops.me import full_search
from basic_video_codec_tpu.tools import ygen


def _golden_frame(curr, refs, hps, bs, r, frac):
    ec = types.SimpleNamespace(block_size=bs, search_range=r,
                               fracMeEnabled=frac)
    h, w = curr.shape
    mvs = np.zeros((h // bs, w // bs, 3), np.int32)
    sads = np.zeros((h // bs, w // bs), np.int32)
    preds = np.zeros((h // bs, w // bs, bs, bs), np.int32)
    for y in range(0, h, bs):
        for x in range(0, w, bs):
            blk = curr[y:y + bs, x:x + bs].astype(np.int16)
            mv, mae, _ = gme.full_search(blk, (x, y), list(refs), list(hps), ec)
            mvs[y // bs, x // bs] = mv
            sads[y // bs, x // bs] = round(mae * bs * bs)
            preds[y // bs, x // bs] = gme.get_ref_block_at_mv(
                refs[mv[2]], hps[mv[2]], (x, y), mv[0], mv[1], ec)
    return mvs, sads, preds


def _parity_case(curr, refs, bs, r, frac):
    hps = np.stack([build_pre_interpolated_buffer(x) for x in refs])
    got = full_search(jnp.asarray(curr), jnp.asarray(refs), jnp.asarray(hps),
                      bs, r, frac)
    want = _golden_frame(curr, refs, hps, bs, r, frac)
    for g, e, name in zip(got, want, ("mvs", "sads", "preds")):
        assert np.array_equal(np.asarray(g), e), name


def _shifted(W, H, n_ref, seed):
    base = ygen.textured_frame(W, H, seed=seed)
    refs = np.stack([np.roll(base, (k, -k), (0, 1)) for k in range(n_ref)])
    return np.roll(base, (2, 1), (0, 1)), refs


@pytest.mark.parametrize("frac", [False, True], ids=["int", "frac"])
def test_full_search_matches_golden_single_ref(frac):
    curr, refs = _shifted(48, 32, 1, seed=5)
    _parity_case(curr, refs, 8, 2, frac)


def test_full_search_matches_golden_multi_ref():
    curr, refs = _shifted(48, 32, 3, seed=6)
    _parity_case(curr, refs, 8, 1, False)


def test_full_search_matches_golden_tie_breaks():
    """Flat content ties every SAD: the winner must follow the reference
    tie-break (lower |mvx|+|mvy|, then enumeration order)."""
    flat = np.full((32, 32), 77, np.uint8)
    _parity_case(flat, flat[None], 8, 2, False)


def test_full_search_matches_golden_range4():
    curr, refs = _shifted(64, 48, 1, seed=7)
    _parity_case(curr, refs, 8, 4, False)
