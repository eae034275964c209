"""Spatially-sharded P-frame encode step (shard_map + halo exchange).

One frame is split into bands of block rows across the ``space`` mesh axis;
independent sequences ride the ``data`` axis.  Motion search at a band edge
needs ``search_range`` rows of the reference frame owned by the neighbouring
device — those halos are exchanged with two ``lax.ppermute`` shifts
before the purely-local batched search runs (the same shift-and-box-reduce
kernel as ops/me.py, restricted to the band).  Fractional ME interpolates
the halo-extended band locally: every half-pel value a *valid* candidate can
touch is a function of rows the band + r-row halo already holds (valid
candidates never read the global zero edge row/col of the reference's
interpolation quirk, block_predictor.py:145-177, because ``iy + 2*bs <= 2H``
bounds the last touched row to ``2H-2``).  Per-frame totals (bits) are
reduced with ``psum`` over ``space``.

Preconditions are asserted at build time: the halo is a single ``ppermute``
hop, so ``search_range`` must not exceed the band height.

This is the multi-chip "training step" analog: ME + MC + DCT + quantize +
exact bit pricing + reconstruction for a full frame batch, compiled as one
sharded XLA program.  It targets fixed-QP throughput encoding (the RC row
chain is inherently frame-serial and stays on the single-chip path).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..entropy.zigzag import zigzag_indices
from ..ops import bitlen
from ..ops import transform as T
from ..ops.interp import build_half_pel

INVALID_KEY = jnp.int32(2 ** 30)


def _local_pframe(curr, ref_ext, band0, h_total, bs, r, qp, frac, d, Q, zz):
    """Encode one frame's band given the halo-extended reference band.

    curr: uint8 [H_local, W]; ref_ext: uint8 [H_local + 2r, W];
    band0: global row index of this band's first row.
    """
    hl, w = curr.shape
    nbr, nbc = hl // bs, w // bs
    curr_i = curr.astype(jnp.int32)
    bx = jnp.arange(nbc, dtype=jnp.int32) * bs
    by_g = band0 + jnp.arange(nbr, dtype=jnp.int32) * bs  # global block-row origins

    import numpy as np

    if frac:
        # half-pel plane of the extended band; ext row 2r maps to the band's
        # first row, candidate units are half-pels, range doubles
        plane = build_half_pel(ref_ext).astype(jnp.int32)
        sr, scale = 2 * r, 2
        base_row = 2 * r
        lim_w, lim_h, bspan = 2 * w, 2 * h_total, 2 * bs
    else:
        plane = ref_ext.astype(jnp.int32)
        sr, scale = r, 1
        base_row = r
        lim_w, lim_h, bspan = w, h_total, bs
    span = 2 * sr + 1
    offs = np.stack(
        [np.repeat(np.arange(-sr, sr + 1), span), np.tile(np.arange(-sr, sr + 1), span)],
        axis=1,
    ).astype(np.int32)  # (dy, dx) in reference enumeration order

    def score(_, off):
        dy, dx = off[0], off[1]
        # rows via dynamic_slice off the halo, columns via roll: wrapped
        # column values only reach candidates the validity mask rejects
        aligned = jax.lax.dynamic_slice(
            plane, (base_row + dy, 0), (scale * hl, scale * w))
        aligned = jnp.roll(aligned, -dx, axis=1)
        if frac:
            aligned = aligned[0::2, 0::2]
        sad = jnp.abs(curr_i - aligned).reshape(nbr, bs, nbc, bs).sum(axis=(1, 3))
        valid = (
            ((scale * bx + dx) >= 0)[None, :]
            & ((scale * bx + dx + bspan) <= lim_w)[None, :]
            & ((scale * by_g + dy) >= 0)[:, None]
            & ((scale * by_g + dy + bspan) <= lim_h)[:, None]
        )
        key = jnp.where(valid, sad * 256 + (jnp.abs(dx) + jnp.abs(dy)), INVALID_KEY)
        return None, (key, sad)

    _, (keys, sads) = jax.lax.scan(score, None, jnp.asarray(offs))
    best = jnp.argmin(keys, axis=0)
    best_off = jnp.asarray(offs)[best]  # [nbr, nbc, 2] (dy, dx)
    best_sad = jnp.take_along_axis(sads, best[None], axis=0)[0]

    # motion-compensated prediction from the extended plane.  Winners are
    # always valid candidates (invalid ones carry INVALID_KEY), so the
    # column clamp below can never alter a selected value — it only keeps
    # the gather indices of masked-out losers in bounds.
    a = jnp.arange(bs, dtype=jnp.int32) * scale
    oy = (jnp.arange(nbr, dtype=jnp.int32) * bs * scale + base_row)[:, None, None, None]
    ox = (jnp.arange(nbc, dtype=jnp.int32) * bs * scale)[None, :, None, None]
    rows = oy + best_off[..., 0][..., None, None] + a[None, None, :, None]
    cols = jnp.clip(
        ox + best_off[..., 1][..., None, None] + a[None, None, None, :],
        0, scale * w - 1)
    preds = plane[rows, cols]

    curr_blocks = curr_i.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    residuals = (curr_blocks - preds).astype(jnp.float32)
    q = T.quantize(T.dct2(residuals, d), Q)
    qi = q.astype(jnp.int32)
    bits = bitlen.rle_block_bits(bitlen.zigzag_rows(qi.reshape(nbr * nbc, bs * bs), bs)).sum()
    recon_blocks, _ = T.reconstruct(q, Q, preds, d)
    recon = recon_blocks.transpose(0, 2, 1, 3).reshape(hl, w)
    qdct = qi.astype(jnp.int16).transpose(0, 2, 1, 3).reshape(hl, w)
    mvs = jnp.stack([best_off[..., 1], best_off[..., 0]], axis=-1)  # (mv_x, mv_y)
    return recon, qdct, mvs, best_sad, bits


def sharded_pframe_step(mesh, bs: int, search_range: int, qp: int, h_total: int,
                        frac: bool = False):
    """Build the sharded step: ``f(curr [B,H,W] u8, ref [B,H,W] u8) ->
    (recon, qdct, mvs, sads, frame_bits)`` laid out over (data, space).
    ``mvs`` are (mv_x, mv_y) in half-pel units when ``frac``."""
    r = search_range
    n_space = mesh.shape["space"]
    band_h = h_total // n_space
    if h_total % n_space:
        raise ValueError(f"frame height {h_total} must split evenly over "
                         f"{n_space} space shards")
    if band_h % bs:
        raise ValueError(f"band height {band_h} must be a block multiple")
    if r > band_h:
        raise ValueError(
            f"search_range {r} exceeds the band height {band_h}: the halo "
            f"exchange is a single ppermute hop and would silently miss "
            f"reference rows — use fewer space shards")
    d_mat = T.dct_matrix(bs)
    Q = T.quant_matrices(bs)[qp]
    zz = zigzag_indices(bs)

    def local_fn(curr, ref):
        # halo exchange: my top r reference rows go down, bottom r go up
        idx = jax.lax.axis_index("space")
        down = [(i, i + 1) for i in range(n_space - 1)]
        up = [(i + 1, i) for i in range(n_space - 1)]
        top_halo = jax.lax.ppermute(ref[:, -r:, :], "space", down)  # from band above
        bot_halo = jax.lax.ppermute(ref[:, :r, :], "space", up)     # from band below
        ref_ext = jnp.concatenate([top_halo, ref, bot_halo], axis=1)

        hl = curr.shape[1]
        band0 = idx * hl

        f = partial(
            _local_pframe,
            h_total=h_total, bs=bs, r=r, qp=qp, frac=frac,
            d=jnp.asarray(d_mat), Q=jnp.asarray(Q), zz=jnp.asarray(zz),
        )
        recon, qdct, mvs, sads, bits = jax.vmap(
            lambda c, rf: f(c, rf, band0)
        )(curr, ref_ext)
        frame_bits = jax.lax.psum(bits, "space")  # [B_local]
        return recon, qdct, mvs, sads, frame_bits

    return jax.jit(
        jax.shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(P("data", "space", None), P("data", "space", None)),
            out_specs=(
                P("data", "space", None),
                P("data", "space", None),
                P("data", "space", None, None),
                P("data", "space", None),
                P("data"),
            ),
        )
    )
