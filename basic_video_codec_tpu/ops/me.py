"""Device motion estimation.

**Full search** (replaces reference block_predictor.py:61-91): instead of the
reference's Python triple loop calling ``mae()`` per candidate, every
candidate displacement is scored for *all* blocks of the frame at once — one
``lax.scan`` step per candidate computes ``|curr - shift(ref)|`` over the
whole frame and box-reduces it to per-block SADs (pure VPU work with
perfectly coalesced access).  Out-of-range candidates are masked to +inf
(keys) instead of the reference's raise/except control flow, and the winner
is selected with the reference's exact tie-break — a lexicographic argmin
over ``(SAD, |mvx|+|mvy|, enumeration index)``, realized as
``argmin(SAD * 256 + L1)`` (first minimal index wins, matching the
reference's strict-less update rule).  MAE comparisons equal SAD comparisons
exactly: block sizes are powers of two, so ``SAD / bs^2`` is an exact float.

**Fast ME** (replaces block_predictor.py:11-58): inherently serial across
blocks (each block's search is seeded at the previous block's MV), so it runs
as a ``lax.scan`` over blocks in raster order whose step is a bounded
``lax.while_loop`` of cross-pattern refinements.  The reference's
late-binding-lambda behaviour for nRefFrames > 1 (winner = first
(frame, offset) pair at the global minimum, reported ref index always 0,
comparison count ``sum_i (i+1) * n_valid``) is reproduced — see
golden/me.py for the derivation.

**Fractional (half-pel) ME** (block_predictor.py:65-66, 104-111): candidates
address a 2x interpolated buffer with stride 2; the search range doubles.
"""

from functools import partial

import jax
import jax.numpy as jnp

INVALID_KEY = jnp.int32(2 ** 30)


def candidate_offsets(n_ref: int, search_range: int):
    """Candidate table in the reference's enumeration order
    (ref-major, mv_y ascending, mv_x ascending — block_predictor.py:76-79).
    Returns int32 ``[n_cand, 3]`` rows ``(ref_idx, mv_y, mv_x)``."""
    span = 2 * search_range + 1
    import numpy as np

    k = np.repeat(np.arange(n_ref), span * span)
    dy = np.tile(np.repeat(np.arange(-search_range, search_range + 1), span), n_ref)
    dx = np.tile(np.arange(-search_range, search_range + 1), span * n_ref)
    return np.stack([k, dy, dx], axis=1).astype(np.int32)


def _block_sums(diff: jnp.ndarray, bs: int) -> jnp.ndarray:
    h, w = diff.shape
    return diff.reshape(h // bs, bs, w // bs, bs).sum(axis=(1, 3))


@partial(jax.jit, static_argnames=("bs", "search_range", "frac"))
def full_search(curr: jnp.ndarray, refs: jnp.ndarray, interp_refs: jnp.ndarray,
                bs: int, search_range: int, frac: bool,
                n_valid: jnp.ndarray | None = None):
    """Batched exhaustive search + motion-compensated prediction.

    Parameters
    ----------
    curr : uint8 ``[H, W]`` current frame
    refs : uint8 ``[n_ref, H, W]`` reference frames (deque order: 0 = oldest)
    interp_refs : uint8 ``[n_ref, 2H, 2W]`` half-pel buffers (used iff frac)
    search_range : the *config* search range; doubled internally when frac
    n_valid : optional int32 scalar — number of leading reference slots that
        hold real frames (the rolling-stack warm-up in models/chunk.py keeps
        a fixed-shape stack whose tail is not yet populated); candidates of
        slots >= n_valid are masked out, which reproduces the reference's
        enumeration over the deque's actual length exactly (invalid slots
        can never win, and valid ones keep their enumeration order).

    Returns ``(mvs int32 [nbr, nbc, 3] as (mv_x, mv_y, ref),
    sad int32 [nbr, nbc], pred int32 [nbr, nbc, bs, bs])``.

    ONE scan over the candidate set: each step scores the candidate for
    every block (the packed-key running strict-minimum implements the
    reference's first-minimum tie-break exactly) and select-accumulates its
    pixels into the winners' prediction plane — whole-frame selects
    instead of a 4-D gather, with no per-candidate key buffer.
    """
    sr = search_range * 2 if frac else search_range
    assert sr <= 127, "search range too large for the (SAD, L1) packed key"
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    n_ref = refs.shape[0]
    cands = jnp.asarray(candidate_offsets(n_ref, sr))  # [n_cand, 3]

    curr_i = curr.astype(jnp.int32)
    bx = jnp.arange(nbc, dtype=jnp.int32) * bs  # block x origins
    by = jnp.arange(nbr, dtype=jnp.int32) * bs

    def aligned_frame(cand):
        k, dy, dx = cand[0], cand[1], cand[2]
        if frac:
            irf = jax.lax.dynamic_index_in_dim(interp_refs, k, axis=0, keepdims=False)
            return jnp.roll(irf, (-dy, -dx), axis=(0, 1))[0::2, 0::2].astype(jnp.int32)
        rf = jax.lax.dynamic_index_in_dim(refs, k, axis=0, keepdims=False)
        return jnp.roll(rf, (-dy, -dx), axis=(0, 1)).astype(jnp.int32)

    if frac:
        lim_w, lim_h, bspan = 2 * w, 2 * h, 2 * bs
        ox, oy = bx * 2, by * 2
    else:
        lim_w, lim_h, bspan = w, h, bs
        ox, oy = bx, by

    def score(state, cand):
        best_key, best_sad, best_cand, pred = state
        k, dy, dx = cand[0], cand[1], cand[2]
        aligned = aligned_frame(cand)
        sad = _block_sums(jnp.abs(curr_i - aligned), bs)  # [nbr, nbc]
        valid = (
            ((ox + dx) >= 0)[None, :]
            & ((ox + dx + bspan) <= lim_w)[None, :]
            & ((oy + dy) >= 0)[:, None]
            & ((oy + dy + bspan) <= lim_h)[:, None]
        )
        if n_valid is not None:
            valid = valid & (k < n_valid)  # unpopulated rolling-stack slot
        l1 = jnp.abs(dx) + jnp.abs(dy)
        key = jnp.where(valid, sad * 256 + l1, INVALID_KEY)
        take = key < best_key  # strict <: the FIRST minimum wins
        take_px = (
            jnp.broadcast_to(take[:, None, :, None], (nbr, bs, nbc, bs))
            .reshape(h, w)
        )
        return (
            jnp.where(take, key, best_key),
            jnp.where(take, sad, best_sad),
            jnp.where(take[..., None], cand[None, None], best_cand),
            jnp.where(take_px, aligned, pred),
        ), None

    init = (
        jnp.full((nbr, nbc), INVALID_KEY, jnp.int32),
        jnp.zeros((nbr, nbc), jnp.int32),
        jnp.zeros((nbr, nbc, 3), jnp.int32),
        jnp.zeros((h, w), jnp.int32),
    )
    (_, best_sad, best_cand, pred_frame), _ = jax.lax.scan(score, init, cands)
    mvs = jnp.stack([best_cand[..., 2], best_cand[..., 1], best_cand[..., 0]], axis=-1)
    preds = pred_frame.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    return mvs, best_sad, preds


@partial(jax.jit, static_argnames=("bs", "frac"))
def gather_pred_blocks(refs: jnp.ndarray, interp_refs: jnp.ndarray, mvs: jnp.ndarray,
                       bs: int, frac: bool):
    """Motion-compensated prediction for every block: one vectorized gather.

    ``pred[i, j, a, b] = ref[k, i*bs + mv_y + a, j*bs + mv_x + b]`` (integer)
    or the stride-2 read of the half-pel buffer (fractional) — reference
    block_predictor.py:93-114.
    """
    nbr, nbc = mvs.shape[:2]
    a = jnp.arange(bs, dtype=jnp.int32)
    if frac:
        oy = (jnp.arange(nbr, dtype=jnp.int32) * bs * 2)[:, None, None, None]
        ox = (jnp.arange(nbc, dtype=jnp.int32) * bs * 2)[None, :, None, None]
        rows = oy + mvs[..., 1][..., None, None] + 2 * a[None, None, :, None]
        cols = ox + mvs[..., 0][..., None, None] + 2 * a[None, None, None, :]
        return interp_refs[mvs[..., 2][..., None, None], rows, cols]
    oy = (jnp.arange(nbr, dtype=jnp.int32) * bs)[:, None, None, None]
    ox = (jnp.arange(nbc, dtype=jnp.int32) * bs)[None, :, None, None]
    rows = oy + mvs[..., 1][..., None, None] + a[None, None, :, None]
    cols = ox + mvs[..., 0][..., None, None] + a[None, None, None, :]
    return refs[mvs[..., 2][..., None, None], rows, cols]
