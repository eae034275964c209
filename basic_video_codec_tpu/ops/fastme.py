"""Device fast motion estimation (reference block_predictor.py:11-58).

FastME is the one search the reference makes *inherently serial across
blocks*: each block's search is seeded at the previous raster block's chosen
MV (PFrame.py:99-110).  The plain XLA walk (:func:`fast_search_frame_xla`)
compiles that chain into a single ``lax.scan`` over blocks whose step is a
bounded ``lax.while_loop`` of cross-pattern refinements — the reference's
unbounded recursion with exception-driven candidate rejection becomes
masked fixed-shape iterations.  On the GPU the same walk runs as one Pallas
kernel per frame (ops/fastme_pallas.py); the XLA walk is its reference and
the path of every other backend.

Exact-decision notes:

* candidate order per iteration is (origin, MVP, top, right, bottom, left)
  per reference frame, frame-major — first strict minimum wins, realized as
  ``argmin`` over the flat [n_ref * 6] SAD vector (MAE comparisons equal SAD
  comparisons: power-of-two block sizes).
* termination: winner is the (0,0) candidate *or* the MVP itself (the
  reference's ``"origin" in key`` substring check matches both, :50), or
  ``|mv| >= 16`` (:55).
* nRefFrames > 1 late-binding quirk (see golden/me.py): every offset is
  scored against every frame, the reported ref index is always 0, and the
  comparison count is ``n_valid_offsets * n_ref*(n_ref+1)/2`` per iteration.
* the loop terminates because a non-terminating iteration strictly decreases
  the minimum SAD; ``MAX_ITERS`` is a compile-time safety bound far above
  anything reachable (each strict decrease needs a fresh SAD value).
"""

from functools import partial

import jax
import jax.numpy as jnp

MAX_ITERS = 1024
BIG = jnp.int32(2 ** 30)


@partial(jax.jit, static_argnames=("bs", "frac"))
def fast_search_frame(curr: jnp.ndarray, refs: jnp.ndarray, interp_refs: jnp.ndarray,
                      bs: int, frac: bool, n_valid: jnp.ndarray | None = None):
    """FastME for every block of a frame, raster order, MVP chained.

    ``n_valid`` (optional int32 scalar) masks unpopulated tail slots of a
    fixed-shape rolling reference stack (models/chunk.py warm-up): their
    candidates can never win and the comparison count uses the true deque
    length, so decisions match the reference's variable-length deque exactly.

    Returns ``(mvs int32 [nbr, nbc, 3], sads int32 [nbr, nbc],
    comps int32 [nbr, nbc])``.
    """
    from .fastme_pallas import fast_search_frame_pallas, use_pallas_fastme

    if use_pallas_fastme():
        return fast_search_frame_pallas(curr, refs, interp_refs, bs, frac,
                                        n_valid=n_valid)
    return fast_search_frame_xla(curr, refs, interp_refs, bs, frac, n_valid)


@partial(jax.jit, static_argnames=("bs", "frac"))
def fast_search_frame_xla(curr: jnp.ndarray, refs: jnp.ndarray,
                          interp_refs: jnp.ndarray, bs: int, frac: bool,
                          n_valid: jnp.ndarray | None = None):
    """The plain XLA walk: :func:`fast_search_frame` on every backend but
    the GPU, and the reference the Pallas kernel is tested against."""
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    n_ref = refs.shape[0]
    curr_i = curr.astype(jnp.int32)
    if n_valid is None:
        ref_weight = n_ref * (n_ref + 1) // 2  # late-binding re-evaluation count
        ref_mask = None
    else:
        ref_weight = n_valid * (n_valid + 1) // 2
        ref_mask = jnp.arange(n_ref) < n_valid  # [n_ref]

    if frac:
        lim_h, lim_w, bspan, scale = 2 * h, 2 * w, 2 * bs, 2
        planes = interp_refs.astype(jnp.int32)
    else:
        lim_h, lim_w, bspan, scale = h, w, bs, 1
        planes = refs.astype(jnp.int32)

    a = jnp.arange(bs, dtype=jnp.int32) * scale

    def candidate_sads(cblk, ox, oy, offs):
        """SAD of each (ref, offset) candidate; invalid -> BIG.
        offs: int32 [6, 2] as (dx, dy)."""
        def one_offset(off):
            px = ox + off[0]
            py = oy + off[1]
            valid = (px >= 0) & (py >= 0) & (px + bspan <= lim_w) & (py + bspan <= lim_h)
            pxc = jnp.clip(px, 0, lim_w - bspan)
            pyc = jnp.clip(py, 0, lim_h - bspan)
            # gather [n_ref, bs, bs] at stride `scale`
            rows = pyc + a[:, None]
            cols = pxc + a[None, :]
            blocks = planes[:, rows, cols]
            sads = jnp.abs(cblk[None] - blocks).sum(axis=(1, 2))  # [n_ref]
            if ref_mask is not None:
                sads = jnp.where(ref_mask, sads, BIG)
            return jnp.where(valid, sads, BIG), valid

        sads, valid = jax.vmap(one_offset)(offs)  # [6, n_ref], [6]
        return sads.T.reshape(-1), valid  # frame-major flat [n_ref*6]

    def block_step(carry, idx):
        mvp = carry  # int32 [2]
        i = idx // nbc
        j = idx % nbc
        ox = j * bs * scale
        oy = i * bs * scale
        cblk = jax.lax.dynamic_slice(curr_i, (i * bs, j * bs), (bs, bs))

        def offsets_of(mvp):
            return jnp.stack([
                jnp.array([0, 0], jnp.int32),
                mvp,
                mvp + jnp.array([0, -1], jnp.int32),
                mvp + jnp.array([1, 0], jnp.int32),
                mvp + jnp.array([0, 1], jnp.int32),
                mvp + jnp.array([-1, 0], jnp.int32),
            ])

        def cond(state):
            _, _, _, done, it, _ = state
            return (~done) & (it < MAX_ITERS)

        def body(state):
            mvp, best_mv, best_sad, _, it, comps = state
            offs = offsets_of(mvp)
            sads, valid = candidate_sads(cblk, ox, oy, offs)
            comps = comps + valid.sum().astype(jnp.int32) * ref_weight
            flat = jnp.argmin(sads)  # first minimum (frame-major, offset-minor)
            k = flat % 6
            min_sad = sads[flat]
            win_mv = offs[k]
            is_origin_class = k <= 1  # (0,0) or MVP ("origin" substring quirk)
            hit_bound = (jnp.abs(win_mv[0]) >= 16) | (jnp.abs(win_mv[1]) >= 16)
            done = is_origin_class | hit_bound
            return (win_mv, win_mv, min_sad, done, it + 1, comps)

        init = (mvp, mvp, BIG, jnp.array(False), jnp.int32(0), jnp.int32(0))
        _, best_mv, best_sad, _, _, comps = jax.lax.while_loop(cond, body, init)
        mv3 = jnp.array([best_mv[0], best_mv[1], 0], jnp.int32)  # ref idx 0 (quirk)
        return best_mv, (mv3, best_sad, comps)

    mvp0 = jnp.zeros(2, dtype=jnp.int32)  # mv_field {(0,0): [0,0]} seed (PFrame.py:34)
    _, (mvs, sads, comps) = jax.lax.scan(
        block_step, mvp0, jnp.arange(nbr * nbc, dtype=jnp.int32)
    )
    return (
        mvs.reshape(nbr, nbc, 3),
        sads.reshape(nbr, nbc),
        comps.reshape(nbr, nbc),
    )
