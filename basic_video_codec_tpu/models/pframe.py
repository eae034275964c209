"""Device P-frame codec: one jitted program per frame.

Pipeline (replaces reference PFrame.py:29-131's per-block Python loop):

1. motion estimation — batched full search with fused MC prediction
   (ops/me.py) or compiled MVP-chain fast search (ops/fastme.py),
2. residuals -> batched matmul DCT,
3. quantization + exact entropy pricing (closed-form RLE/exp-Golomb lengths,
   reference PFrame.py:136-163 semantics for the differential-MV rows):
   fully batched when per-row QPs are known up front (fixed QP, RC 2/3),
   or an ``nbr``-step budget scan for RC1 (QP of row i depends on the exact
   bits of rows < i, reference Frame.py:168-188),
4. batched rescale/IDCT/reconstruct with each row's Q.

The MVP chain (PFrame.py:105) only affects fastME and the differential MV
*encoding* — full search never reads it, so step 1 is embarrassingly parallel.

Outputs are packed into few transfers (recon, one artifact plane, int16
qdct, one int32 vector) to keep device->host round trips few.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import bitlen
from ..ops import transform as T
from ..ops.fastme import fast_search_frame
from ..ops.me import full_search, gather_pred_blocks
from ..ops.intra import _select_qp_rc1


def _wrap_int8_bits(x: jnp.ndarray) -> jnp.ndarray:
    """NumPy's modular float -> int8 cast, delivered as the uint8 bit pattern
    (artifact planes only; reference PFrame.py:39-40 stores residuals int8)."""
    t = jnp.trunc(x).astype(jnp.int32)
    return (t % 256).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("bs", "search_range", "rc1", "fast", "frac",
                                   "multi_ref", "emit_halfpel", "exact",
                                   "emit_pred"))
def pframe_encode(
    curr: jnp.ndarray,          # uint8 [H, W]
    refs_in,                    # tuple of uint8 [H, W] (deque order, 0 = oldest)
                                # or a pre-stacked [R, H, W] rolling stack
    interps_in,                 # tuple of uint8 [2H, 2W] (may be () when not frac)
    row_qps_in: jnp.ndarray,    # int32 [nbr] (used when rc1=False)
    budget0: jnp.ndarray,       # float32 scalar (used when rc1=True)
    tbl_qps: jnp.ndarray,       # int32 [n_tbl]
    tbl_bits: jnp.ndarray,      # float32 [n_tbl]
    initial_qp: jnp.ndarray,    # int32 scalar
    bs: int,
    search_range: int,
    rc1: bool,
    fast: bool,
    frac: bool,
    multi_ref: bool,            # nRefFrames > 1: MV ref index is entropy-coded
    emit_halfpel: bool = False,
    exact: bool = False,        # integer-exact transform (cross-backend bit-exact)
    n_valid: jnp.ndarray | None = None,  # populated slots of a rolling stack
    emit_pred: bool = False,    # append the MC prediction plane (uint8 [H, W])
):
    """Returns ``(recon_u8 [H, W], halfpel_u8 [2H, 2W] | None,
    art_u8 [H, W] (res_w_mc bit plane), qdct_i16 [H, W],
    smalls_i32 [...][, pred_u8 [H, W] when emit_pred])`` — smalls pack
    (mvs, sads, comps, row_qps, row_bits).  ``emit_pred`` feeds the compact
    transfer packers (ops/pack.py), which need the prediction plane for the
    res/recon correction codes, so it travels out of the step instead of
    being re-gathered post hoc from the stacked half-pel buffers.
    The res_wo_mc artifact plane is integer math over host-resident data
    (curr minus the oldest reference) and is recomputed by the host writer
    instead of being transferred.

    References arrive as a *tuple* of frames and are stacked inside the jit:
    stacking (or any eager array op) between frames would add a dispatched
    program to the inter-frame dependency chain.
    """
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    d = jnp.asarray(T.dct_matrix(bs))
    qmats = jnp.asarray(T.quant_matrices(bs))
    refs = refs_in if isinstance(refs_in, jnp.ndarray) else jnp.stack(refs_in)
    if frac:
        interp_refs = (interps_in if isinstance(interps_in, jnp.ndarray)
                       else jnp.stack(interps_in))
    else:
        interp_refs = jnp.zeros((refs.shape[0], 2 * h, 2 * w), jnp.uint8)

    # 1. motion estimation (+ fused MC prediction on the full-search path)
    if fast:
        mvs, sads, comps = fast_search_frame(curr, refs, interp_refs, bs, frac,
                                             n_valid=n_valid)
        preds = gather_pred_blocks(refs, interp_refs, mvs, bs, frac).astype(jnp.int32)
    else:
        mvs, sads, preds = full_search(curr, refs, interp_refs, bs,
                                       search_range, frac, n_valid=n_valid)
        sr = search_range * 2 if frac else search_range
        n_window = (refs.shape[0] if n_valid is None else n_valid) * (2 * sr + 1) ** 2
        comps = jnp.full((nbr, nbc), 1, dtype=jnp.int32) * n_window

    # 2. residual -> batched DCT (QP-independent float coefficients)
    curr_blocks = (
        curr.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3).astype(jnp.int32)
    )
    residuals = curr_blocks - preds
    coeffs = T.forward_coeffs(residuals, bs, exact)  # [nbr, nbc, bs, bs] f32

    # differential-MV prediction bits per row (PFrame.py:136-163): the chain
    # runs raster across the whole frame, qp_diff excluded (added below).
    flat_mvs = mvs.reshape(-1, 3)
    prev = jnp.concatenate([jnp.zeros((1, 3), jnp.int32), flat_mvs[:-1]], axis=0)
    diffs = flat_mvs - prev
    mv_bits = bitlen.golomb_len(diffs[:, 0]) + bitlen.golomb_len(diffs[:, 1])
    if multi_ref:
        mv_bits = mv_bits + bitlen.golomb_len(diffs[:, 2])
    mv_row_bits = mv_bits.reshape(nbr, nbc).sum(axis=1)

    # 3. quantize + price
    if rc1:
        # QP of row i depends on exact bits of rows < i -> budget scan
        def row_step(budget, i):
            qp = _select_qp_rc1(budget, nbr - i, tbl_qps, tbl_bits)
            q = T.quantize(coeffs[i], qmats[qp])
            zz_rows = bitlen.zigzag_rows(q.reshape(nbc, bs * bs), bs)
            dct_bits = bitlen.rle_block_bits(zz_rows).sum()
            row_bits = dct_bits + bitlen.golomb_len(qp - initial_qp) + mv_row_bits[i]
            return budget - row_bits.astype(jnp.float32), (q.astype(jnp.int16), qp, row_bits)

        _, (qrows, row_qps, row_bits) = jax.lax.scan(
            row_step, budget0, jnp.arange(nbr, dtype=jnp.int32)
        )
    else:
        # per-row QPs known up front: everything batches
        row_qps = row_qps_in
        Qr = qmats[row_qps][:, None]  # [nbr, 1, bs, bs]
        q = T.quantize(coeffs, Qr)
        qrows = q.astype(jnp.int16)
        zz_rows = bitlen.zigzag_rows(q.reshape(nbr, nbc, bs * bs), bs)
        dct_bits = bitlen.rle_block_bits(zz_rows).sum(axis=1)
        row_bits = dct_bits + bitlen.golomb_len(row_qps - initial_qp) + mv_row_bits

    # 4. reconstruct with each row's Q
    Qrows = qmats[row_qps][:, None]
    recon_blocks, idct_res = T.reconstruct_mode(qrows, Qrows, preds, bs, exact)
    recon = recon_blocks.transpose(0, 2, 1, 3).reshape(h, w)
    qdct = qrows.transpose(0, 2, 1, 3).reshape(h, w)

    # artifact plane (dtype-wrap parity with the reference)
    art = _wrap_int8_bits(idct_res).transpose(0, 2, 1, 3).reshape(h, w)
    smalls = jnp.concatenate([
        mvs.reshape(-1), sads.reshape(-1), comps.reshape(-1),
        row_qps.astype(jnp.int32), row_bits.astype(jnp.int32),
    ])
    recon_u8 = recon.astype(jnp.uint8)
    if emit_halfpel:
        from ..ops.interp import build_half_pel

        out = (recon_u8, build_half_pel(recon_u8), art, qdct, smalls)
    else:
        out = (recon_u8, None, art, qdct, smalls)
    if emit_pred:
        pred_plane = preds.transpose(0, 2, 1, 3).reshape(h, w).astype(jnp.uint8)
        out = out + (pred_plane,)
    return out


@partial(jax.jit, static_argnames=("bs", "frac", "emit_halfpel", "exact",
                                   "emit_pred"))
def pframe_decode(
    qdct: jnp.ndarray,         # int16/int32 [H, W]
    mvs: jnp.ndarray,          # int32 [nbr, nbc, 3]
    row_qps: jnp.ndarray,      # int32 [nbr]
    refs_in,                   # tuple of uint8 [H, W]
    interps_in,                # tuple of uint8 [2H, 2W] (() when not frac)
    bs: int,
    frac: bool,
    emit_halfpel: bool = False,
    exact: bool = False,
    emit_pred: bool = False,   # append the MC prediction plane (uint8 [H, W])
):
    """Reference construct_frame_from_dct_and_mv (PFrame.py:252-317), batched.
    ``emit_pred`` feeds the decode pipeline's compact-transfer packer."""
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    d = jnp.asarray(T.dct_matrix(bs))
    qmats = jnp.asarray(T.quant_matrices(bs))
    refs = refs_in if isinstance(refs_in, jnp.ndarray) else jnp.stack(refs_in)
    if frac:
        interp_refs = (interps_in if isinstance(interps_in, jnp.ndarray)
                       else jnp.stack(interps_in))
    else:
        interp_refs = jnp.zeros((refs.shape[0], 2 * h, 2 * w), jnp.uint8)
    # NOTE: the reference forces ref idx 0 when only one reference frame is
    # held (PFrame.py:232-235); encoder-produced streams always satisfy
    # mv[2] < n_ref so a plain gather is equivalent.
    preds = gather_pred_blocks(refs, interp_refs, mvs, bs, frac).astype(jnp.int32)
    qblocks = qdct.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    Qrows = qmats[row_qps][:, None]
    recon_blocks, _ = T.reconstruct_mode(qblocks, Qrows, preds, bs, exact)
    decoded = recon_blocks.transpose(0, 2, 1, 3).reshape(h, w)
    if emit_halfpel:
        from ..ops.interp import build_half_pel

        out = (decoded, build_half_pel(decoded))
    else:
        out = (decoded, None)
    if emit_pred:
        out = out + (preds.transpose(0, 2, 1, 3).reshape(h, w)
                     .astype(jnp.uint8),)
    return out
