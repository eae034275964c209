"""Decision parity of the Pallas fastME walk (Triton route, interpret mode on
the CPU) vs the XLA scan x while walk and the golden per-block search.

The walk's exactness contract (ops/fastme.py docstring): candidate order,
the origin-substring termination quirk, the |mv| >= 16 bound, geometric
validity, the late-binding multiref comparison count, and n_valid warm-up
masking must all match — mvs, sads AND comps, bit for bit.  The compiled
kernel is held to the same contract at CIF by chip_smoke.py."""

import types

import numpy as np
import pytest

import jax.numpy as jnp

from basic_video_codec_tpu.golden import me as gme
from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
from basic_video_codec_tpu.ops.fastme import fast_search_frame_xla
from basic_video_codec_tpu.ops.fastme_pallas import fast_search_frame_pallas
from basic_video_codec_tpu.tools import ygen


def golden_fast_frame(curr, refs, hps, bs, frac, n_valid=None):
    """golden/me.fast_search over every block in raster order, MVP-chained
    like golden/frames.py; the first ``n_valid`` references are live."""
    n = refs.shape[0] if n_valid is None else n_valid
    ec = types.SimpleNamespace(block_size=bs, fracMeEnabled=frac)
    h, w = curr.shape
    mvs = np.zeros((h // bs, w // bs, 3), np.int32)
    sads = np.zeros((h // bs, w // bs), np.int32)
    comps = np.zeros((h // bs, w // bs), np.int32)
    mvp = (0, 0)
    for y in range(0, h, bs):
        for x in range(0, w, bs):
            blk = curr[y:y + bs, x:x + bs].astype(np.int16)
            mv, mae, c = gme.fast_search(blk, (x, y), mvp, list(refs[:n]),
                                         list(hps[:n]), ec, 0)
            mvs[y // bs, x // bs] = mv
            sads[y // bs, x // bs] = round(mae * bs * bs)
            comps[y // bs, x // bs] = c
            mvp = mv
    return mvs, sads, comps


def _planes(rng, h, w, n_ref, frac, motion):
    if motion == "shift":
        base = ygen.moving_sequence(w, h, n_ref + 1, seed=3)
        refs = np.stack([base[i] for i in range(n_ref)])
        curr = base[n_ref]
    else:  # noise: exercises tie-breaks and early termination
        refs = rng.integers(0, 256, (n_ref, h, w)).astype(np.uint8)
        curr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    hps = (np.stack([build_pre_interpolated_buffer(r) for r in refs])
           if frac else np.zeros((n_ref, 2 * h, 2 * w), np.uint8))
    return curr, refs, hps


def _assert_same(got, want):
    for g, e, name in zip(got, want, ("mvs", "sads", "comps")):
        assert np.array_equal(np.asarray(g), np.asarray(e)), name


@pytest.mark.parametrize("frac", [False, True], ids=["int", "frac"])
@pytest.mark.parametrize("n_ref,n_valid", [(1, None), (3, None), (3, 2)],
                         ids=["ref1", "ref3", "ref3_warmup2"])
@pytest.mark.parametrize("motion", ["shift", "noise"])
def test_pallas_fastme_matches_xla(frac, n_ref, n_valid, motion):
    rng = np.random.default_rng(5)
    h, w, bs = 48, 64, 8
    curr, refs, hps = _planes(rng, h, w, n_ref, frac, motion)
    nv = None if n_valid is None else jnp.int32(n_valid)
    args = (jnp.asarray(curr), jnp.asarray(refs), jnp.asarray(hps), bs, frac)
    got = fast_search_frame_pallas(*args, n_valid=nv, interpret=True)
    _assert_same(got, fast_search_frame_xla(*args, n_valid=nv))
    _assert_same(got, golden_fast_frame(curr, refs, hps, bs, frac, n_valid))


def test_pallas_fastme_large_motion_bound():
    """Content whose best match sits far away: the walk must stop at the
    |mv| >= 16 bound exactly like the XLA walk and the golden search."""
    h, w, bs = 64, 96, 16
    base = ygen.moving_sequence(w, h, 2, seed=9)
    # amplify motion: roll the reference far
    ref = np.roll(base[0], (18, -21), axis=(0, 1))
    curr = base[0]
    hps = np.zeros((1, 2 * h, 2 * w), np.uint8)
    args = (jnp.asarray(curr), jnp.asarray(ref)[None], jnp.asarray(hps), bs, False)
    got = fast_search_frame_pallas(*args, interpret=True)
    _assert_same(got, fast_search_frame_xla(*args))
    _assert_same(got, golden_fast_frame(curr, ref[None], hps, bs, False))


@pytest.mark.gpu
def test_pallas_fastme_compiled_matches_xla(gpu):
    """The kernel as compiled for the card, at CIF, against the XLA walk."""
    h, w = 288, 352
    curr, refs, hps = _planes(np.random.default_rng(5), h, w, 4, True, "shift")
    for bs in (8, 16):
        args = (jnp.asarray(curr), jnp.asarray(refs), jnp.asarray(hps), bs, True)
        _assert_same(fast_search_frame_pallas(*args),
                     fast_search_frame_xla(*args))


@pytest.mark.parametrize("backend,kernel", [("cpu", False), ("gpu", True)])
def test_fastme_kernel_choice_by_backend(monkeypatch, backend, kernel):
    """The compiled walk runs on the GPU only; other backends take the XLA
    walk (a Triton-route kernel compiles for nothing else)."""
    import jax

    from basic_video_codec_tpu.ops import fastme_pallas

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert fastme_pallas.use_pallas_fastme() is kernel


@pytest.mark.parametrize("frac", [False, True], ids=["int", "frac"])
def test_pallas_fastme_vmapped_lanes(frac):
    """Under vmap (the batch lane's fastME groups) each lane becomes one
    program of the grid and must equal the golden walk of its own frames."""
    import jax

    h, w, bs, n_ref, lanes = 48, 64, 8, 2, 3
    seq = ygen.moving_sequence(w, h, n_ref + lanes, seed=3)
    refs = np.stack([seq[k:k + n_ref] for k in range(lanes)])
    curr = np.stack([seq[k + n_ref] for k in range(lanes)])
    hps = (np.stack([[build_pre_interpolated_buffer(r) for r in rr]
                     for rr in refs]) if frac
           else np.zeros((lanes, n_ref, 2 * h, 2 * w), np.uint8))
    got = jax.vmap(lambda c, r, p: fast_search_frame_pallas(
        c, r, p, bs, frac, interpret=True))(
            jnp.asarray(curr), jnp.asarray(refs), jnp.asarray(hps))
    for k in range(lanes):
        _assert_same([g[k] for g in got],
                     golden_fast_frame(curr[k], refs[k], hps[k], bs, frac))
