"""Device I-frame encoder: a compiled wavefront over block anti-diagonals.

Intra prediction has a hard dependency chain — block (r, c) predicts from the
*reconstructed* left column of (r, c-1) and top row of (r-1, c)
(reference IFrame.py:198-213) — so exact reproduction cannot batch blocks of a
frame freely.  But both parents of (r, c) lie on anti-diagonal r+c-1, so the
chain IS a wavefront: one ``lax.scan`` over the nbr+nbc-1 diagonals, each
step encoding up to nbr blocks batched (lane = block row).  A CIF block-8
frame is 79 batched steps instead of 1,584 serial ones (measured 9.4 ->
~1.5 ms/frame on the target chip).  The lane layout makes the carries
gather-free: lane l's left predictor is its OWN previous right column, and
its top predictor is lane l-1's previous bottom row — a static roll.
Diagonal-major input/output marshalling ("skew") is pure pad+reshape.

Rate control mode 1 cannot wavefront — the QP of row i depends on the exact
coded bits of ALL rows < i (reference Frame.py:168-188 / RateControl.py:34-43),
which serializes rows — so RC1 keeps the row x block scan with the budget in
the carry.  Fixed QP and RC 2/3 (QPs known up front) take the wavefront.

Quirks preserved: transposed predictors, uint8-wraparound mode decision at
non-border blocks (implemented as ``(curr - pred) & 255``), int-promoted
decision at borders, and the always-'I' lookup row.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import bitlen
from . import transform as T


def _skew(a: jnp.ndarray, nbr: int, nbc: int) -> jnp.ndarray:
    """Diagonal-major marshalling: blocks ``[nbr, nbc, ...]`` -> diagonals
    ``[nbr+nbc-1, nbr, ...]`` with ``out[l+c, l] = a[l, c]`` — pure
    pad+reshape, no frame-sized gather.  Positions outside a diagonal are
    zeros."""
    ndiag = nbr + nbc - 1
    f = a.shape[2:]
    pad = jnp.zeros((nbr, nbr) + f, a.dtype)
    flat = jnp.concatenate([a, pad], axis=1).reshape((nbr * (nbc + nbr),) + f)
    s = flat[: nbr * ndiag].reshape((nbr, ndiag) + f)
    return jnp.moveaxis(s, 0, 1)


def _unskew(s: jnp.ndarray, nbr: int, nbc: int) -> jnp.ndarray:
    """Inverse of :func:`_skew`: ``[ndiag, nbr, ...]`` -> ``[nbr, nbc, ...]``
    with ``out[l, c] = s[l+c, l]``."""
    f = s.shape[2:]
    flat = jnp.moveaxis(s, 0, 1).reshape((nbr * (nbr + nbc - 1),) + f)
    pad = jnp.zeros((nbr,) + f, s.dtype)
    ap = jnp.concatenate([flat, pad]).reshape((nbr, nbc + nbr) + f)
    return ap[:, :nbc]


def _select_qp_rc1(budget, rows_left, tbl_qps, tbl_bits):
    """First table QP whose expected row bits fit the constant row budget,
    else the max table QP (reference RateControl.py:34-43; table iterated in
    ascending QP order)."""
    row_budget = budget / rows_left.astype(jnp.float32)
    fits = tbl_bits <= row_budget
    first_fit = jnp.argmax(fits)  # first True (argmax returns first maximal)
    return jnp.where(fits.any(), tbl_qps[first_fit], tbl_qps[-1])


@partial(jax.jit, static_argnames=("bs", "rc1", "emit_halfpel", "exact"))
def intra_encode_frame(
    curr: jnp.ndarray,            # uint8 [H, W]
    row_qps_in: jnp.ndarray,      # int32 [nbr] (used when rc1=False)
    budget0: jnp.ndarray,         # float32 scalar (used when rc1=True)
    tbl_qps: jnp.ndarray,         # int32 [n_tbl] ascending
    tbl_bits: jnp.ndarray,        # float32 [n_tbl] expected 'I' bits/row
    initial_qp: jnp.ndarray,      # int32 scalar (qp_diff base, Frame.py:42-43)
    bs: int,
    rc1: bool,
    emit_halfpel: bool = False,
    exact: bool = False,
):
    """Returns ``(recon_u8 [H, W], halfpel_u8 [2H, 2W] | None,
    art_u8 [H, W] residual-wrap plane, qdct_i16 [H, W], smalls_i32 [...])``
    — smalls pack (modes, mae_sums, row_qps, row_bits); see unpack in
    pipeline.  recon is a standalone output so the next frame's program can
    consume it without an eager host-side slice (every eager op between
    frames adds a dispatched program to the dependency chain)."""
    h, w = curr.shape
    nbr, nbc = h // bs, w // bs
    d = jnp.asarray(T.dct_matrix(bs))
    qmats = jnp.asarray(T.quant_matrices(bs))  # [nqp, bs, bs]
    curr_i = curr.astype(jnp.int32)

    def block_step(carry, j):
        recon, y, qp = carry
        x = j * bs
        cblk = jax.lax.dynamic_slice(curr_i, (y, x), (bs, bs))

        # --- predictor candidates (transposed quirk) ---
        left_col = jax.lax.dynamic_slice(recon, (y, jnp.maximum(x - 1, 0)), (bs, 1))
        pred_h_in = jnp.broadcast_to(left_col[:, 0][None, :], (bs, bs))  # H[a,b]=left[b]
        top_row = jax.lax.dynamic_slice(recon, (jnp.maximum(y - 1, 0), x), (1, bs))
        pred_v_in = jnp.broadcast_to(top_row[0][:, None], (bs, bs))      # V[a,b]=top[a]
        border = jnp.full((bs, bs), 128, dtype=jnp.int32)
        pred_h = jnp.where(x > 0, pred_h_in, border)
        pred_v = jnp.where(y > 0, pred_v_in, border)

        # --- mode decision: uint8 wraparound at interior, plain abs at border ---
        sad_h_wrap = ((cblk - pred_h) & 255).sum()
        sad_h_border = jnp.abs(cblk - border).sum()
        sad_h = jnp.where(x > 0, sad_h_wrap, sad_h_border)
        sad_v_wrap = ((cblk - pred_v) & 255).sum()
        sad_v_border = jnp.abs(cblk - border).sum()
        sad_v = jnp.where(y > 0, sad_v_wrap, sad_v_border)
        mode = jnp.where(sad_h < sad_v, 0, 1).astype(jnp.int32)
        pred = jnp.where(mode == 0, pred_h, pred_v)
        mae_sum = jnp.where(mode == 0, sad_h, sad_v)

        # --- transform / quantize / reconstruct at the row QP ---
        Q = qmats[qp]
        coeffs = T.forward_coeffs(cblk - pred, bs, exact)
        q = T.quantize(coeffs, Q)
        # reconstruct in the decoder's lane layout (intra_decode_frame: one
        # [nbr, bs, bs] IDCT per diagonal, lane = block row).  A float IDCT
        # of one [bs, bs] block can round a pixel apart from the same block
        # inside the batched dot, so decode != recon; the same dot shape and
        # lane keep the two bit-identical.
        lane = y // bs

        def in_lane(a):
            return jax.lax.dynamic_update_slice(
                jnp.zeros((nbr, bs, bs), a.dtype), a[None], (lane, 0, 0))

        recon_lanes, _ = T.reconstruct_mode(
            in_lane(q), jnp.broadcast_to(Q, (nbr, bs, bs)), in_lane(pred),
            bs, exact)
        recon_blk = recon_lanes[lane]
        recon = jax.lax.dynamic_update_slice(recon, recon_blk.astype(jnp.int32), (y, x))
        # artifact plane: int16 residual stored into a uint8 frame wraps
        # mod 256 (reference IFrame.py:30,57)
        res_u8 = ((cblk - pred) & 255).astype(jnp.uint8)
        return (recon, y, qp), (q.astype(jnp.int16), mode, mae_sum, res_u8)

    def row_step(carry, i):
        recon, budget = carry
        if rc1:
            qp = _select_qp_rc1(budget, nbr - i, tbl_qps, tbl_bits)
        else:
            qp = row_qps_in[i]
        y = i * bs
        (recon, _, _), (qrow, modes, maes, res_row) = jax.lax.scan(
            block_step, (recon, y, qp), jnp.arange(nbc, dtype=jnp.int32)
        )
        # exact row cost: qp_diff + per-block modes + DCT coefficients
        zz_rows = bitlen.zigzag_rows(qrow.reshape(nbc, bs * bs), bs)
        dct_bits = bitlen.rle_block_bits(zz_rows).sum()
        pred_bits = bitlen.golomb_len(qp - initial_qp) + bitlen.intra_mode_bits(modes).sum()
        row_bits = dct_bits + pred_bits
        budget = budget - row_bits.astype(jnp.float32)
        return (recon, budget), (qrow, modes, maes, qp, row_bits, res_row)

    if rc1:
        recon0 = jnp.zeros((h, w), dtype=jnp.int32)
        (recon, _), (qrows, modes, maes, row_qps, row_bits, res_rows) = jax.lax.scan(
            row_step, (recon0, budget0), jnp.arange(nbr, dtype=jnp.int32)
        )
    else:
        # wavefront: scan anti-diagonals, lanes = block rows (module docstring)
        row_qps = row_qps_in
        Qr = qmats[row_qps]                                  # [nbr, bs, bs]
        blocks = curr_i.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
        cdiag = _skew(blocks, nbr, nbc)                      # [ndiag, nbr, bs, bs]
        lanes = jnp.arange(nbr, dtype=jnp.int32)
        border = jnp.full((nbr, bs, bs), 128, dtype=jnp.int32)

        def diag_step(carry, xd):
            right_cols, bottom_rows = carry                  # [nbr, bs] i32
            d, cblk = xd
            c = d - lanes                                    # [nbr]
            active = (c >= 0) & (c < nbc)
            # transposed predictor quirk: H[a,b]=left[b], V[a,b]=top[a]
            pred_h_in = jnp.broadcast_to(right_cols[:, None, :], (nbr, bs, bs))
            top = jnp.roll(bottom_rows, 1, axis=0)           # lane l-1's block
            pred_v_in = jnp.broadcast_to(top[:, :, None], (nbr, bs, bs))
            pred_h = jnp.where((c > 0)[:, None, None], pred_h_in, border)
            pred_v = jnp.where((lanes > 0)[:, None, None], pred_v_in, border)
            sad_border = jnp.abs(cblk - border).sum((1, 2))
            sad_h = jnp.where(c > 0, ((cblk - pred_h) & 255).sum((1, 2)),
                              sad_border)
            sad_v = jnp.where(lanes > 0, ((cblk - pred_v) & 255).sum((1, 2)),
                              sad_border)
            mode = jnp.where(sad_h < sad_v, 0, 1).astype(jnp.int32)
            pred = jnp.where((mode == 0)[:, None, None], pred_h, pred_v)
            mae = jnp.where(mode == 0, sad_h, sad_v)
            coeffs = T.forward_coeffs(cblk - pred, bs, exact)
            q = T.quantize(coeffs, Qr)
            recon_blk, _ = T.reconstruct_mode(q, Qr, pred, bs, exact)
            recon_b = recon_blk.astype(jnp.int32)
            am = active[:, None]
            right_cols = jnp.where(am, recon_b[:, :, bs - 1], right_cols)
            bottom_rows = jnp.where(am, recon_b[:, bs - 1, :], bottom_rows)
            res_u8 = ((cblk - pred) & 255).astype(jnp.uint8)
            return (right_cols, bottom_rows), (q.astype(jnp.int16), mode,
                                               mae, res_u8, recon_b)

        ndiag = nbr + nbc - 1
        carry0 = (jnp.zeros((nbr, bs), jnp.int32),
                  jnp.zeros((nbr, bs), jnp.int32))
        _, (qd, modes_d, maes_d, res_d, recon_d) = jax.lax.scan(
            diag_step, carry0,
            (jnp.arange(ndiag, dtype=jnp.int32), cdiag))
        qrows = _unskew(qd, nbr, nbc)
        modes = _unskew(modes_d, nbr, nbc)
        maes = _unskew(maes_d, nbr, nbc)
        res_rows = _unskew(res_d, nbr, nbc)
        recon = _unskew(recon_d, nbr, nbc).transpose(0, 2, 1, 3).reshape(h, w)
        # exact row cost, batched over rows (identical math to row_step's)
        zz_rows = bitlen.zigzag_rows(qrows.reshape(nbr, nbc, bs * bs), bs)
        dct_bits = bitlen.rle_block_bits(zz_rows).sum(axis=1)
        row_bits = (dct_bits + bitlen.golomb_len(row_qps - initial_qp)
                    + bitlen.intra_mode_bits(modes).sum(axis=1))
    # qrows: [nbr, nbc, bs, bs] -> [H, W]
    qdct = qrows.transpose(0, 2, 1, 3).reshape(h, w)
    residual_u8 = res_rows.transpose(0, 2, 1, 3).reshape(h, w)
    smalls = jnp.concatenate([
        modes.reshape(-1), maes.reshape(-1),
        row_qps.astype(jnp.int32), row_bits.astype(jnp.int32),
    ])
    recon_u8 = recon.astype(jnp.uint8)
    if emit_halfpel:
        from .interp import build_half_pel

        return recon_u8, build_half_pel(recon_u8), residual_u8, qdct, smalls
    return recon_u8, None, residual_u8, qdct, smalls


@partial(jax.jit, static_argnames=("bs", "emit_halfpel", "exact"))
def intra_decode_frame(qdct: jnp.ndarray, modes: jnp.ndarray, row_qps: jnp.ndarray,
                       bs: int, emit_halfpel: bool = False, exact: bool = False):
    """Decoder-side intra reconstruction (reference IFrame.py:85-114): the
    same anti-diagonal wavefront as the encoder (module docstring), with the
    predictor chosen by the decoded mode."""
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    qmats = jnp.asarray(T.quant_matrices(bs))
    qdct_i = qdct.astype(jnp.int32)

    Qr = qmats[row_qps]                                      # [nbr, bs, bs]
    qblocks = qdct_i.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3)
    qdiag = _skew(qblocks, nbr, nbc)                         # [ndiag, nbr, bs, bs]
    mdiag = _skew(modes.astype(jnp.int32), nbr, nbc)         # [ndiag, nbr]
    lanes = jnp.arange(nbr, dtype=jnp.int32)
    border = jnp.full((nbr, bs, bs), 128, dtype=jnp.int32)

    def diag_step(carry, xd):
        right_cols, bottom_rows = carry                      # [nbr, bs] i32
        d, coffs, mode = xd
        c = d - lanes
        active = (c >= 0) & (c < nbc)
        pred_h_in = jnp.broadcast_to(right_cols[:, None, :], (nbr, bs, bs))
        top = jnp.roll(bottom_rows, 1, axis=0)
        pred_v_in = jnp.broadcast_to(top[:, :, None], (nbr, bs, bs))
        pred_h = jnp.where((c > 0)[:, None, None], pred_h_in, border)
        pred_v = jnp.where((lanes > 0)[:, None, None], pred_v_in, border)
        pred = jnp.where((mode == 0)[:, None, None], pred_h, pred_v)
        blk, _ = T.reconstruct_mode(coffs, Qr, pred, bs, exact)
        recon_b = blk.astype(jnp.int32)
        am = active[:, None]
        right_cols = jnp.where(am, recon_b[:, :, bs - 1], right_cols)
        bottom_rows = jnp.where(am, recon_b[:, bs - 1, :], bottom_rows)
        return (right_cols, bottom_rows), recon_b

    ndiag = nbr + nbc - 1
    carry0 = (jnp.zeros((nbr, bs), jnp.int32),
              jnp.zeros((nbr, bs), jnp.int32))
    _, recon_d = jax.lax.scan(
        diag_step, carry0,
        (jnp.arange(ndiag, dtype=jnp.int32), qdiag, mdiag))
    recon = _unskew(recon_d, nbr, nbc).transpose(0, 2, 1, 3).reshape(h, w)
    decoded = recon.astype(jnp.uint8)
    if emit_halfpel:
        from .interp import build_half_pel

        return decoded, build_half_pel(decoded)
    return decoded, None
