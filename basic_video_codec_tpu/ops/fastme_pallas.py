"""Pallas fastME: the serial MVP-chained refinement walk as one GPU kernel.

The reference's fastME (block_predictor.py:11-58, PFrame.py:99-110) chains
every block's search on the previous raster block's MV, so the walk is
inherently serial.  The plain XLA version (ops/fastme.py, ``lax.scan`` x
``while_loop``) runs each refinement iteration as several small device
programs, with the loop predicate read back on every iteration.

This kernel runs the whole walk of one frame in one Triton program: the
block loop and the refinement loop are device loops, the MVP carry lives in
registers, and each candidate window is loaded straight from the reference
plane with a dynamic-offset (stride 2 for half-pel) load and reduced to its
SAD in registers.  The planes are read from global memory; a CIF frame's
reference planes (even four half-pel ones, ~1.6 MB) stay L2-resident.
Under ``vmap`` (batched configs) each lane becomes one program of the grid.

Candidate offsets are clamped into the plane before the load, so no load is
out of bounds; clamped windows only feed candidates that are geometrically
invalid, and those are masked to BIG exactly like ops/fastme.py.

Decision-exactness mirrors ops/fastme.py: candidate order (ref-major,
offset-minor first-strict-minimum), the origin-substring termination quirk
(winner index <= 1), the |mv| >= 16 bound, geometric validity masking, the
nRefFrames late-binding comparison count, and the n_valid warm-up masking.
Parity with the XLA walk and golden/me.py is asserted by interpret-mode
tests (tests/test_pallas_fastme.py) and, compiled, by chip_smoke.py.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BIG = np.int32(2 ** 30)
MAX_ITERS = 1024            # safety bound (each iteration strictly improves)
# one warp: SAD reductions stay in shuffles (on an H100, 1 warp beat 2 and 4
# in every configuration measured, PERF.md)
NUM_WARPS = 1


def use_pallas_fastme() -> bool:
    """The kernel runs where it is compiled for: the GPU backend."""
    return jax.default_backend() == "gpu"


def _walk_kernel(nv_ref, curr_ref, planes_ref, out_ref, *, nbr, nbc, bs,
                 scale, n_ref, lim_h, lim_w):
    span = scale * bs
    nv = nv_ref[0]

    def window(r, px, py):
        # planes arrive stacked along rows: reference r starts at r * lim_h
        px = jnp.clip(px, 0, lim_w - span)
        py = jnp.clip(py, 0, lim_h - span) + r * lim_h
        idx = (pl.ds(py, bs, stride=scale), pl.ds(px, bs, stride=scale))
        return planes_ref[idx].astype(jnp.int32)

    def block_loop(b, mvp):
        mvp_x, mvp_y = mvp
        i = jax.lax.div(b, nbc)  # b >= 0: truncating division is floor
        j = jax.lax.rem(b, nbc)
        ox = j * span
        oy = i * span
        cblk = curr_ref[pl.ds(i * bs, bs), pl.ds(j * bs, bs)].astype(jnp.int32)

        def sad(r, px, py):
            return jnp.sum(jnp.abs(cblk - window(r, px, py)))

        # the (0, 0) candidate is block-aligned and constant across iterations
        osads = [sad(r, ox, oy) for r in range(n_ref)]

        def cond(state):
            return (~state[3]) & (state[4] < MAX_ITERS)

        def body(state):
            mx, my, _, _, it, cnt = state
            # XLA candidate order: origin, mvp, top, right, bottom, left
            cand_dx = (jnp.int32(0), mx, mx, mx + 1, mx, mx - 1)
            cand_dy = (jnp.int32(0), my, my - 1, my, my + 1, my)
            best = BIG
            bk = jnp.int32(0)
            bdx = jnp.int32(0)
            bdy = jnp.int32(0)
            vcnt = jnp.int32(0)
            for r in range(n_ref):
                for k in range(6):
                    px, py = ox + cand_dx[k], oy + cand_dy[k]
                    valid = ((px >= 0) & (py >= 0)
                             & (px + span <= lim_w) & (py + span <= lim_h))
                    if r == 0:
                        # comparison counting uses per-OFFSET validity
                        vcnt = vcnt + valid.astype(jnp.int32)
                    s = osads[r] if k == 0 else sad(r, px, py)
                    s = jnp.where(valid & (r < nv), s, BIG)
                    # first strict minimum in (ref-major, offset-minor) order
                    take = s < best
                    best = jnp.where(take, s, best)
                    bk = jnp.where(take, jnp.int32(k), bk)
                    bdx = jnp.where(take, cand_dx[k], bdx)
                    bdy = jnp.where(take, cand_dy[k], bdy)
            hit_bound = (jnp.abs(bdx) >= 16) | (jnp.abs(bdy) >= 16)
            done = (bk <= 1) | hit_bound  # "origin" substring quirk
            return (bdx, bdy, best, done, it + 1, cnt + vcnt)

        init = (mvp_x, mvp_y, BIG, jnp.bool_(False), jnp.int32(0),
                jnp.int32(0))
        bdx, bdy, best, _, _, cnt = jax.lax.while_loop(cond, body, init)
        out_ref[0, b] = bdx
        out_ref[1, b] = bdy
        out_ref[2, b] = best
        out_ref[3, b] = cnt
        return (bdx, bdy)

    jax.lax.fori_loop(0, nbr * nbc, block_loop, (jnp.int32(0), jnp.int32(0)))


@partial(jax.jit, static_argnames=("bs", "frac", "interpret"))
def fast_search_frame_pallas(curr: jnp.ndarray, refs: jnp.ndarray,
                             interp_refs: jnp.ndarray, bs: int, frac: bool,
                             n_valid: jnp.ndarray | None = None,
                             interpret: bool = False):
    """Drop-in twin of ops/fastme.fast_search_frame as one Pallas kernel
    (Triton route).

    Returns ``(mvs int32 [nbr, nbc, 3], sads int32 [nbr, nbc],
    comps int32 [nbr, nbc])`` with identical decisions."""
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    n_ref = refs.shape[0]
    scale = 2 if frac else 1
    planes = (interp_refs if frac else refs).reshape(n_ref * scale * h,
                                                     scale * w)
    if n_valid is None:
        nv = jnp.full((1,), n_ref, jnp.int32)
        ref_weight = jnp.int32(n_ref * (n_ref + 1) // 2)
    else:
        nv = jnp.full((1,), 1, jnp.int32) * n_valid
        ref_weight = (n_valid * (n_valid + 1) // 2).astype(jnp.int32)

    kernel = partial(_walk_kernel, nbr=nbr, nbc=nbc, bs=bs, scale=scale,
                     n_ref=n_ref, lim_h=scale * h, lim_w=scale * w)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((4, nb), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="fastme_walk",
    )(nv, curr, planes)

    mvs = jnp.stack([out[0], out[1], jnp.zeros((nb,), jnp.int32)],  # ref 0 quirk
                    axis=1).reshape(nbr, nbc, 3)
    sads = out[2].reshape(nbr, nbc)
    comps = (out[3] * ref_weight).reshape(nbr, nbc)
    return mvs, sads, comps
