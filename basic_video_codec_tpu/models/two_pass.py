"""Fused two-pass rate control (RC modes 2/3) as one device program per GOP.

The reference encodes every frame twice under RC>1 (encoder.py:85-98):
pass 1 at a constant QP (the previous frame's average row QP), then pass 2
with per-row QPs proportional to pass-1's per-row bit shares, re-encoding as
an I-frame on GOP starts and on scene changes (pass-1 P bits > 1.3x the
lookup expectation).  Doing the inter-pass decision on host costs two
synchronizations per frame; this module keeps the whole loop on device:

* pass 1 for a P-frame collapses to *pricing only*: motion search and DCT
  coefficients are QP-independent and pass-1's reconstruction is never used
  (the reference discards it, encoder.py:97-98's second encode always runs),
  so pass 1 = quantize at qp1 + closed-form row bits,
* the scene-change test, the proportional row budgets, the per-row QP table
  lookups (always the 'I' column, reference Frame.py:169) and the previous
  frame's average-QP carry (``int(mean(rows) - 0.1) + 1``, IFrame.py:35) are
  all scalar math on device,
* the second pass selects between the P path and the full intra scan with a
  ``lax.cond``; the reconstruction chain carries across the GOP scan.

RC2 and RC3 behave identically in the current reference (the RC3-only
prev-pass MV seeding is commented out, PFrame.py:106-107).

The reference deque is a fixed-shape rolling stack carried through the GOP
scan (nRefFrames > 1 included; R == 1 reproduces the single-reference
search exactly) — see :func:`encode_chunk_two_pass`.
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import bitlen
from ..ops import pack as P
from ..ops import transform as T
from ..ops.fastme import fast_search_frame
from ..ops.intra import intra_encode_frame
from ..ops.me import full_search, gather_pred_blocks
from .chunk import _pack_runtime_mode_rows, _push_ref
from .pframe import _wrap_int8_bits

SCENE_CHANGE_THRESHOLD = 1.3  # reference encoder.py:30


def _avg_qp(row_qps, nbr):
    """``int(mean(rows) - 0.1) + 1`` (reference IFrame.py:35) on device.
    The sum is exact in float32 (<= 18 small ints); the 0.1 offset keeps the
    truncation away from representable boundaries (see PARITY.md)."""
    mean = row_qps.astype(jnp.float32).sum() / jnp.float32(nbr)
    return (jnp.floor(mean - jnp.float32(0.1)) + 1).astype(jnp.int32)


def _row_qps_proportional(row_bits_1, budget_frame, tbl_qps, tbl_bits):
    """Second-pass per-row QPs: budget_i = B * share_i, QP = first table entry
    whose expected bits fit (reference RateControl.py:23-43), vectorized."""
    shares = row_bits_1.astype(jnp.float32) / row_bits_1.astype(jnp.float32).sum()
    budgets = budget_frame * shares  # [nbr]
    fits = tbl_bits[None, :] <= budgets[:, None]  # [nbr, n_tbl]
    first = jnp.argmax(fits, axis=1)
    return jnp.where(fits.any(axis=1), tbl_qps[first], tbl_qps[-1]).astype(jnp.int32)


@partial(jax.jit, static_argnames=("bs", "search_range", "fast", "frac",
                                   "first_is_intra", "exact", "compact",
                                   "int8q", "mv8", "q4", "tail",
                                   "packed_shape", "qfrac", "devb"))
def encode_chunk_two_pass(
    frames: jnp.ndarray,       # uint8 [K, H, W] (or packed upload buffer)
    refs0: jnp.ndarray,        # uint8 [R, H, W] rolling reference stack
    hps0: jnp.ndarray,         # uint8 [R, 2H, 2W] (used iff frac)
    n_valid0: jnp.ndarray,     # int32 scalar: populated slots of refs0
    prev_avg_qp0: jnp.ndarray, # int32 scalar (seeded by the host)
    budget_frame: jnp.ndarray, # float32 scalar: targetBR / frame_rate
    tbl_qps: jnp.ndarray,      # int32 [n_tbl]
    tbl_bits: jnp.ndarray,     # float32 [n_tbl] 'I' column
    exp_p_frame: jnp.ndarray,  # float32 scalar: tableP[config_qp] * nbr
    initial_qp: jnp.ndarray,   # int32 scalar (qp_diff base)
    bs: int,
    search_range: int,
    fast: bool,
    frac: bool,
    first_is_intra: bool,
    exact: bool = False,
    compact: bool = False,
    int8q: bool = False,
    mv8: bool = False,
    q4: bool = False,
    tail: bool = False,
    packed_shape: tuple | None = None,
    qfrac: tuple | None = None,
    devb: bool = False,
):
    """Returns ``(out, refs_out, hps_out, n_valid_out, prev_avg_out)`` with
    ``out = (recons [K,H,W] u8, arts [K,H,W] u8, qdcts [K,H,W] i16,
    smalls [K, 1+5nb+2nbr] i32)``; smalls lead with the frame's final mode
    (0=P, 1=I), then mvs/sads/comps (P) or modes/maes/pad (I), row_qps,
    row_bits.  A fifth element ``packed`` holds one uint8 buffer per chunk:
    with ``compact``, per-frame rows in the SAME ops/pack.py FrameLayout as
    models/chunk.py (recon/res correction codes + zigzag-prefix qdct —
    ~119 KB instead of ~413 KB per CIF block-16 frame), so the host pipeline
    reuses its compact fetch path; otherwise the full planes bitcast+concat
    (one transfer per chunk either way).

    The reference deque is a fixed-shape rolling stack carried through the
    scan (R = refs0.shape[0]; models/chunk.py _push_ref semantics), so
    nRefFrames > 1 runs the same fused program; scene-change intra frames
    clear it like GOP starts (reference encoder.py:89-98).  R == 1
    reproduces the single-reference search exactly (n_valid masking off)."""
    if packed_shape is not None:
        frames = P.unpack_input_chunk(frames, *packed_shape)
    k, h, w = frames.shape
    R = refs0.shape[0]
    multiref = R > 1
    zeros_hps = jnp.zeros((R, 2 * h, 2 * w), jnp.uint8)
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    qmats = jnp.asarray(T.quant_matrices(bs))
    zeros_tbl = jnp.zeros_like(tbl_qps), jnp.zeros_like(tbl_bits)

    def intra_pass(curr, row_qps):
        """Full intra encode at given per-row QPs; smalls in unified layout."""
        recon, hp2, art, qdct, smalls = intra_encode_frame(
            curr, row_qps, jnp.float32(0), zeros_tbl[0], zeros_tbl[1],
            initial_qp, bs, False, emit_halfpel=frac, exact=exact,
        )
        modes = smalls[:nb]
        maes = smalls[nb : 2 * nb]
        rq = smalls[2 * nb : 2 * nb + nbr]
        rb = smalls[2 * nb + nbr :]
        payload = jnp.concatenate([modes, maes, jnp.zeros(3 * nb, jnp.int32)])
        out_smalls = jnp.concatenate([jnp.ones(1, jnp.int32), payload, rq, rb])
        return recon, hp2, art, qdct, out_smalls, rb

    def intra_two_pass(curr, prev_avg):
        # pass 1: constant QP = prev frame's average (Frame.py:176-177)
        qp1_rows = jnp.full(nbr, prev_avg, jnp.int32)
        _, _, _, _, _, rb1 = intra_pass(curr, qp1_rows)
        # pass 2: proportional row budgets from pass 1
        qp2_rows = _row_qps_proportional(rb1, budget_frame, tbl_qps, tbl_bits)
        return intra_pass(curr, qp2_rows)

    def p_two_pass(curr, refs, hps, nv, prev_avg):
        n_valid = nv if multiref else None
        if fast:
            mvs, sads, comps = fast_search_frame(curr, refs, hps, bs, frac,
                                                 n_valid=n_valid)
            preds = gather_pred_blocks(refs, hps, mvs, bs, frac).astype(jnp.int32)
        else:
            mvs, sads, preds = full_search(curr, refs, hps, bs, search_range,
                                           frac, n_valid=n_valid)
            sr2 = search_range * 2 if frac else search_range
            n_window = (nv if multiref else 1) * (2 * sr2 + 1) ** 2
            comps = jnp.full((nbr, nbc), 1, jnp.int32) * n_window
        cblocks = curr.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3).astype(jnp.int32)
        coeffs = T.forward_coeffs(cblocks - preds, bs, exact)

        flat = mvs.reshape(-1, 3)
        prev = jnp.concatenate([jnp.zeros((1, 3), jnp.int32), flat[:-1]])
        dmv = flat - prev
        mv_bits = bitlen.golomb_len(dmv[:, 0]) + bitlen.golomb_len(dmv[:, 1])
        if multiref:
            # nRefFrames > 1 streams code the reference index too
            mv_bits = mv_bits + bitlen.golomb_len(dmv[:, 2])
        mv_row_bits = mv_bits.reshape(nbr, nbc).sum(axis=1)

        def price(row_qps):
            Qr = qmats[row_qps][:, None]
            q = T.quantize(coeffs, Qr)
            zz_rows = bitlen.zigzag_rows(q.reshape(nbr, nbc, bs * bs), bs)
            dct_bits = bitlen.rle_block_bits(zz_rows).sum(axis=1)
            rb = dct_bits + bitlen.golomb_len(row_qps - initial_qp) + mv_row_bits
            return q, rb

        # pass 1: pricing only (reconstruction is discarded by the reference)
        _, rb1 = price(jnp.full(nbr, prev_avg, jnp.int32))
        frame_bits_1 = rb1.sum().astype(jnp.float32) + 48.0  # + 8*6 (Frame.py:158)
        scene = frame_bits_1 / exp_p_frame > SCENE_CHANGE_THRESHOLD
        # NOTE: on a scene change the reference's second pass derives its
        # proportional row budgets from THIS P first pass (prev_pass_frame,
        # encoder.py:97/RateControl.py:23-30) — rb1 is returned for that.

        # pass 2 as P
        qp2_rows = _row_qps_proportional(rb1, budget_frame, tbl_qps, tbl_bits)
        q2, rb2 = price(qp2_rows)
        recon_blocks, idct_res = T.reconstruct_mode(
            q2, qmats[qp2_rows][:, None], preds, bs, exact)
        recon = recon_blocks.transpose(0, 2, 1, 3).reshape(h, w)
        qdct = q2.astype(jnp.int16).transpose(0, 2, 1, 3).reshape(h, w)
        art = _wrap_int8_bits(idct_res).transpose(0, 2, 1, 3).reshape(h, w)
        payload = jnp.concatenate([flat.reshape(-1), sads.reshape(-1), comps.reshape(-1)])
        smalls = jnp.concatenate([jnp.zeros(1, jnp.int32), payload,
                                  qp2_rows, rb2.astype(jnp.int32)])
        if frac:
            from ..ops.interp import build_half_pel

            hp2 = build_half_pel(recon)
        else:
            hp2 = jnp.zeros((2 * h, 2 * w), jnp.uint8)
        return (recon, hp2, art, qdct, smalls), scene, rb1, preds

    def _fresh_stack(recon, hp2):
        """Cleared-deque stack holding only this frame (intra semantics)."""
        refs = jnp.zeros((R, h, w), jnp.uint8).at[0].set(recon)
        hps = zeros_hps.at[0].set(hp2) if frac else zeros_hps
        return refs, hps, jnp.int32(1)

    def step(carry, curr):
        refs, hps, nv, prev_avg = carry
        (p_recon, p_hp, p_art, p_qdct, p_smalls), scene, rb1, p_pred = p_two_pass(
            curr, refs, hps, nv, prev_avg)

        def as_intra(_):
            # scene change: re-encode as intra with row budgets proportional
            # to the P first pass's bit shares (encoder.py:97)
            qp2_rows = _row_qps_proportional(rb1, budget_frame, tbl_qps, tbl_bits)
            r, h2, a, qd, sm, _rb = intra_pass(curr, qp2_rows)
            out = (r, h2 if frac else p_hp, a, qd, sm)
            if compact:
                # prediction plane for the correction-code packers: the intra
                # predictor derived from the final recon (only traced here, so
                # P frames never pay for it)
                pred = P.intra_pred_plane(r, sm[1 : 1 + nb].reshape(nbr, nbc), bs)
                out = out + (pred.astype(jnp.uint8),)
            return out

        def as_p(_):
            out = (p_recon, p_hp, p_art, p_qdct, p_smalls)
            if compact:
                # MC prediction, already computed by the search
                out = out + (p_pred.transpose(0, 2, 1, 3).reshape(h, w)
                             .astype(jnp.uint8),)
            return out

        res = jax.lax.cond(scene, as_intra, as_p, None)
        recon, hp2, art, qdct, smalls = res[:5]
        new_avg = _avg_qp(smalls[1 + 5 * nb : 1 + 5 * nb + nbr], nbr)
        # intra (scene change) clears the reference deque before pushing;
        # P pushes onto the rolling stack
        f_refs, f_hps, f_nv = _fresh_stack(recon, hp2)
        p_refs, p_hps, p_nv = _push_ref(refs, hps, nv, recon, hp2, frac)
        refs2 = jnp.where(scene, f_refs, p_refs)
        hps2 = jnp.where(scene, f_hps, p_hps) if frac else hps
        nv2 = jnp.where(scene, f_nv, p_nv)
        outs = (recon, art, qdct, smalls) + res[5:]
        return (refs2, hps2, nv2, new_avg), outs

    if first_is_intra:
        recon_i, hp_i, art_i, qdct_i, smalls_i, _ = intra_two_pass(frames[0], prev_avg_qp0)
        avg_i = _avg_qp(smalls_i[1 + 5 * nb : 1 + 5 * nb + nbr], nbr)
        refs_c, hps_c, nv_c = _fresh_stack(
            recon_i, hp_i if frac else jnp.zeros((2 * h, 2 * w), jnp.uint8))
        carry = (refs_c, hps_c, nv_c, avg_i)
        p_frames = frames[1:]
        head = (recon_i[None], art_i[None], qdct_i[None], smalls_i[None])
        if compact:
            pred_head = P.intra_pred_plane(
                recon_i, smalls_i[1 : 1 + nb].reshape(nbr, nbc), bs
            ).astype(jnp.uint8)[None]
            head = head + (pred_head,)
    else:
        carry = (refs0, hps0, n_valid0, prev_avg_qp0)
        p_frames = frames
        head = None

    if p_frames.shape[0] > 0:
        (refs_out, hps_out, nv_out, avg_out), scanned = jax.lax.scan(
            step, carry, p_frames)
    else:
        refs_out, hps_out, nv_out, avg_out = carry
        scanned = (jnp.zeros((0, h, w), jnp.uint8), jnp.zeros((0, h, w), jnp.uint8),
                   jnp.zeros((0, h, w), jnp.int16),
                   jnp.zeros((0, 1 + 5 * nb + 2 * nbr), jnp.int32),
                   ) + ((jnp.zeros((0, h, w), jnp.uint8),) if compact else ())

    if head is not None:
        out = tuple(jnp.concatenate([hd, tl]) for hd, tl in zip(head, scanned))
    else:
        out = scanned
    if compact:
        recons, arts, qdcts, smalls_all, preds_all = out
        mvn = P.mv_nibble_static(fast, frac, search_range, R)
        packed = _pack_runtime_mode_rows(recons, arts, qdcts, smalls_all,
                                         preds_all, bs, int8q, mv8, q4, h, w,
                                         tail=tail, qfrac=qfrac,
                                         mvk=2 if R == 1 else 3,
                                         mvn=mvn, devb=devb,
                                         initial_qp=initial_qp)
        out = out[:4]
    else:
        # bundle the FULL planes into one buffer per chunk: pure
        # bitcast+concat, so a chunk is one transfer instead of four
        recons, arts, qdcts, smalls_all = out
        packed = jax.vmap(
            lambda r, a, q, sm: P.concat_bytes(r, a, q, sm)
        )(recons, arts, qdcts, smalls_all)
    return out + (packed,), refs_out, hps_out, nv_out, avg_out


