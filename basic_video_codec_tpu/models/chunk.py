"""Chunked (multi-frame) encode programs.

One jitted program encodes a whole GOP — the intra frame plus a ``lax.scan``
over its P-frames, the reconstruction chain carried on device — so the host
dispatches (and later fetches) once per GOP instead of once per frame:
every dispatched program on the inter-frame dependency chain costs
dispatch and transfer latency, and chunking divides that cost by the GOP
length.

RC modes 0/1 run here; RC 2/3 use the fused two-pass chunk in
models/two_pass.py.  nRefFrames > 1 carries a fixed-shape rolling reference
stack through the scan (:func:`encode_chunk_multiref` / the two-pass
chunk's built-in stack).
"""

from functools import partial

import jax
import jax.numpy as jnp

from ..ops import pack as P
from ..ops.intra import intra_decode_frame, intra_encode_frame
from .pframe import pframe_decode, pframe_encode


def _pack_qdct_stack(qdcts, bs, vdtype, q4, cap):
    """vmap pack_qdct over stacked frames [K, H, W]."""
    return jax.vmap(lambda q: P.pack_qdct(q, bs, cap, vdtype, q4))(qdcts)


def _devbits_dct(qdct, bs, layout):
    """One frame's FINAL dct bitstream packed on device (ops/bitpack.py):
    ``(db u8 [capdb], dbits, dn)``."""
    from ..ops import bitlen as BL
    from ..ops import bitpack as BP

    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    blocks = (qdct.reshape(nbr, bs, nbc, bs).swapaxes(1, 2)
              .reshape(nbr * nbc, bs * bs))
    z = BL.zigzag_rows(blocks.astype(jnp.int32), bs)
    return BP.pack_dct_bits(z, layout.capsym, bs)


def _devbits_pred_i(row_qps, qp0, modes, layout):
    """Intra pred bitstream: ``(pb u8 [capp], pbits)``."""
    from ..ops import bitpack as BP

    return BP.pack_pred_bits(BP.pred_syms_intra(row_qps, qp0, modes),
                             cap_words=layout.capp // 4)


def _devbits_pred_p(row_qps, qp0, mv_flat, layout, nbr):
    """Inter pred bitstream from the flat [3*nb] MV field."""
    from ..ops import bitpack as BP

    return BP.pack_pred_bits(
        BP.pred_syms_inter(row_qps, qp0, mv_flat, nbr, layout.mvk),
        cap_words=layout.capp // 4)


def _devbits_pred_rt(row_qps, qp0, is_i, modes, mv_flat, layout, nbr, nbc):
    """Runtime-mode pred bitstream: the intra symbol rows are padded to the
    inter shape with zero-length (masked) slots, so one static shape covers
    both modes and the packed bytes equal the unpadded stream
    (tests/test_bitpack.py::test_pred_stream_masked_rows)."""
    from ..ops import bitpack as BP

    k = layout.mvk
    si = BP.pred_syms_intra(row_qps, qp0, modes)            # [nbr, 1+nbc]
    sp = BP.pred_syms_inter(row_qps, qp0, mv_flat, nbr, k)  # [nbr, 1+nbc*k]
    si_pad = jnp.concatenate(
        [si, jnp.zeros((nbr, nbc * (k - 1)), jnp.int32)], axis=1)
    syms = jnp.where(is_i, si_pad, sp)
    col = jnp.arange(1 + nbc * k, dtype=jnp.int32)
    mask = jnp.broadcast_to(jnp.where(is_i, col < 1 + nbc, True), syms.shape)
    return BP.pack_pred_bits(syms, mask, cap_words=layout.capp // 4)


def _pack_chunk_rows(intra_parts, p_parts, preds, bs, int8q, h, w, mv8, q4,
                     jt, tail=False, mvk=3, mvn=False, qfrac=None,
                     devb=False, initial_qp=None):
    """Shared compact-transfer epilogue: ONE packed uint8 row per frame in
    ops/pack.py FrameLayout order.  ``intra_parts`` is the chunk head's
    (recon, qdct, smalls) or None; ``p_parts`` the stacked P-frame
    (recons, arts, qdcts, smalls); ``preds`` each P-frame's MC prediction
    plane [K, H, W] u8, emitted by the scan step (pframe_encode emit_pred)
    rather than regathered here from the stacked half-pel buffers.

    With ``tail``, the cap-padded fields (bitmap bytes, jk, re, ae, qv, qe)
    leave the rows and travel in a chunk-wide compacted pool at their used
    sizes (ops/pack.pack_tail_pool); returns ``(heads [K, NBh], pool)``."""
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    vdtype = jnp.int8 if int8q else jnp.int16
    layout = P.FrameLayout(h, w, bs, 1 if int8q else 2, True, True, mv8, q4,
                           jt, tail=tail, mvk=mvk, mvn=mvn, qfrac=qfrac,
                           devbits=devb)
    cap = layout.cape
    mvd = layout.mvd
    rows = []
    # per-segment pool-field stacks, frame order: (jk, qv, qe, jn, qt, qn,
    # jbz, jbn, j1z, j1n, re, rn, ae, an, qe4, qn4, mvz, mn,
    # db, dbits, pb, pbits)
    tails = []
    zi = jnp.zeros(1, jnp.int32)
    if intra_parts is not None:
        recon_i, qdct_i, smalls_i = intra_parts
        if devb:
            db_i, dbits_i, dn_i = _devbits_dct(qdct_i, bs, layout)
            pb_i, pbits_i = _devbits_pred_i(
                smalls_i[2 * nb : 2 * nb + nbr], initial_qp,
                smalls_i[:nb], layout)
        else:
            qp_i = P.pack_qdct(qdct_i, bs, layout.capq, vdtype, q4)
            qv_i, ql_i, qt_i = qp_i[:3]
        meta_i, mv_z, modes_i = _meta_i(smalls_i, nb, nbr)
        if mvk == 2:
            mv_z = jnp.zeros(2 * nb, jnp.int32)
        if mvd:
            bm_i, mn_i, mvz_i = P.pack_mv_delta(mv_z)
            mv_z = (bm_i, mn_i)
        else:
            mn_i, mvz_i = jnp.int32(0), jnp.zeros(0, jnp.uint8)
        jb_i, jk_i, jn_i, re_i, rn_i, ae_i, an_i = _pack_intra_recon(
            recon_i, qdct_i, smalls_i, bs, nb, nbr, nbc, cap, joint=True,
            tight=jt, capk=layout.capk)
        if tail:
            j2_i, j1z_i, j1n_i, jbz_i, jbn_i = P.split_bitmap(jb_i)
            codes_i = (j2_i, j1n_i, jbn_i, jn_i)
        else:
            j1z_i = j1n_i = jbz_i = jbn_i = None
            codes_i = (jb_i, jk_i, jn_i)
        if devb:
            rows.append(P.pack_row(
                codes_i, re_i, rn_i, meta_i, mv_z, modes_i,
                None, None, None, ae_i, an_i, bs=bs, mv8=mv8, mvn=mvn,
                tail=tail, dev=(dn_i, dbits_i, pbits_i))[None])
            tails.append((jk_i[None], None, None, jn_i[None], None, zi,
                          jbz_i[None] if tail else None,
                          jbn_i[None] if tail else None,
                          j1z_i[None] if tail else None,
                          j1n_i[None] if tail else None,
                          re_i[None], rn_i[None], ae_i[None], an_i[None],
                          None, zi, mvz_i[None], mn_i[None],
                          db_i[None], dbits_i[None], pb_i[None],
                          pbits_i[None]))
        else:
            rows.append(P.pack_row(
                codes_i, re_i, rn_i, meta_i, mv_z, modes_i,
                qv_i, ql_i, qt_i, ae_i, an_i, bs=bs, mv8=mv8, mvn=mvn,
                qe4=qp_i[3] if q4 else None, qn4=qp_i[4] if q4 else None,
                qe=qp_i[5] if q4 else None, qn=qp_i[6] if q4 else None,
                tail=tail)[None])
            tails.append((jk_i[None], qv_i[None],
                          qp_i[5][None] if q4 else None,
                          jn_i[None], qt_i[None],
                          qp_i[6][None] if q4 else zi,
                          jbz_i[None] if tail else None,
                          jbn_i[None] if tail else None,
                          j1z_i[None] if tail else None,
                          j1n_i[None] if tail else None,
                          re_i[None], rn_i[None], ae_i[None], an_i[None],
                          qp_i[3][None] if q4 else None,
                          qp_i[4][None] if q4 else zi,
                          mvz_i[None], mn_i[None],
                          None, zi, None, zi))
    recons, arts, qdcts, smalls = p_parts
    if recons.shape[0] > 0:
        if devb:
            dbs, dbitss, dns = jax.vmap(
                lambda q: _devbits_dct(q, bs, layout))(qdcts)
        else:
            qp = _pack_qdct_stack(qdcts, bs, vdtype, q4, layout.capq)
            qv, ql, qt = qp[:3]

        def pack_one(art, recon, pred_u8, qdct, sm):
            pred = pred_u8.astype(jnp.int32)
            row_qps = sm[5 * nb : 5 * nb + nbr]
            x = P.exact_x_blocks(qdct, row_qps, bs)
            guess = P.recon_guess_from_x(x, pred, bs)
            return P.pack_joint(recon, guess, art, P.art_guess_from_x(x),
                                cap, tight=jt, capk=layout.capk)

        jb, jk, jn, re, rn, ae, an = jax.vmap(pack_one)(
            arts, recons, preds, qdcts, smalls)
        if tail:
            j2, j1z, j1n, jbz, jbn = jax.vmap(P.split_bitmap)(jb)
            cparts = (j2, j1n, jbn, jn)
        else:
            j1z = j1n = jbz = jbn = None
            cparts = (jb, jk, jn)

        def _mv_head(mv):
            if mvk == 2:
                mv = mv.reshape(-1, 3)[:, :2].reshape(-1)
            if mvd:
                bm, mn_, mvz = P.pack_mv_delta(mv)
                return (bm, mn_), mn_, mvz
            return mv, jnp.int32(0), jnp.zeros(0, jnp.uint8)

        if devb:

            def row_db(bparts, r2, r3, sm, dn_, dbits_, e, n):
                meta, mv, modes = _meta_p(sm, nb, nbr)
                pb_, pbits_ = _devbits_pred_p(
                    sm[5 * nb : 5 * nb + nbr], initial_qp, sm[: 3 * nb],
                    layout, nbr)
                mv, mn_, mvz = _mv_head(mv)
                head = P.pack_row(bparts, r2, r3, meta, mv, modes,
                                  None, None, None, e, n, bs=bs, mv8=mv8,
                                  mvn=mvn, tail=tail,
                                  dev=(dn_, dbits_, pbits_))
                return head, mvz, mn_, pb_, pbits_

            heads_p, mvzs_p, mns_p, pbs, pbitss = jax.vmap(row_db)(
                cparts, re, rn, smalls, dns, dbitss, ae, an)
            rows.append(heads_p)
            zk = jnp.zeros(rn.shape[0], jnp.int32)
            tails.append((jk, None, None, jn, None, zk,
                          jbz, jbn, j1z, j1n, re, rn, ae, an,
                          None, zk, mvzs_p, mns_p,
                          dbs, dbitss, pbs, pbitss))
        else:

            def row(bparts, r2, r3, sm, v, l, t, e, n, qen=None):
                meta, mv, modes = _meta_p(sm, nb, nbr)
                mv, mn_, mvz = _mv_head(mv)
                head = P.pack_row(bparts, r2, r3, meta, mv, modes, v, l, t,
                                  e, n, bs=bs, mv8=mv8, mvn=mvn,
                                  qe4=qen[0] if qen else None,
                                  qn4=qen[1] if qen else None,
                                  qe=qen[2] if qen else None,
                                  qn=qen[3] if qen else None, tail=tail)
                return head, mvz, mn_

            args = (cparts, re, rn, smalls, qv, ql, qt, ae, an)
            if q4:
                args = args + ((qp[3], qp[4], qp[5], qp[6]),)
            heads_p, mvzs_p, mns_p = jax.vmap(row)(*args)
            rows.append(heads_p)
            zk = jnp.zeros(qt.shape[0], jnp.int32)
            tails.append((jk, qv, qp[5] if q4 else None, jn, qt,
                          qp[6] if q4 else zk,
                          jbz, jbn, j1z, j1n, re, rn, ae, an,
                          qp[3] if q4 else None, qp[4] if q4 else zk,
                          mvzs_p, mns_p, None, zk, None, zk))
    heads = (jnp.concatenate(rows) if rows
             else jnp.zeros((0, layout.total), jnp.uint8))
    if not tail:
        return heads
    if not tails:
        return jnp.concatenate([heads.reshape(-1), jnp.zeros(0, jnp.uint8)])

    def cat(i, at1=False):
        return jnp.concatenate([jnp.atleast_1d(t[i]) if at1 else t[i]
                                for t in tails])

    if devb:
        pool = P.pack_tail_pool(
            layout, cat(0), None, None, cat(3, True), None, None,
            cat(6), cat(7, True), cat(8), cat(9, True),
            res=cat(10), rns=cat(11, True), aes=cat(12),
            ans=cat(13, True), mvzs=cat(16) if mvd else None,
            mns=cat(17, True) if mvd else None,
            dbs=cat(18), dbitss=cat(19, True), pbs=cat(20),
            pbitss=cat(21, True))
    else:
        pool = P.pack_tail_pool(
            layout, cat(0), cat(1), cat(2) if q4 else None, cat(3, True),
            cat(4, True), cat(5, True), cat(6), cat(7, True), cat(8),
            cat(9, True), res=cat(10), rns=cat(11, True), aes=cat(12),
            ans=cat(13, True), qe4s=cat(14) if q4 else None,
            qn4s=cat(15, True), mvzs=cat(16) if mvd else None,
            mns=cat(17, True) if mvd else None)
    # ONE fused buffer [K*headB + pool]: the host fetches a single
    # predictively-sized prefix per chunk (heads + used tail bytes) — one
    # d2h wait instead of two (models/pipeline.tail_prefetch)
    return jnp.concatenate([heads.reshape(-1), pool])


def _pack_intra_recon(recon, qdct, smalls, bs, nb, nbr, nbc, cap,
                      joint=False, tight=False, capk=None):
    """Correction codes for an I-frame's reconstruction: the prediction
    plane comes from the FINAL recon + modes (each block's predictor pixels
    are final by scan order), the guess from the shared integer IDCT.
    With ``joint`` (with_art layouts), the recon half of the joint state
    stream with an empty art half (intra res planes are host-derived)."""
    modes = smalls[:nb].reshape(nbr, nbc)
    row_qps = smalls[2 * nb : 2 * nb + nbr]
    pred = P.intra_pred_plane(recon, modes, bs)
    guess = P.recon_guess_plane(qdct, row_qps, pred, bs)
    if joint:
        return P.pack_joint(recon, guess, guess, guess, cap, tight=tight,
                            capk=capk)
    return P.pack_vs_base(recon, guess, cap)


def _meta_p(smalls, nb, nbr):
    """P-frame smalls [5nb+2nbr] -> (meta i32 [3+2nbr], mv i16, modes u8).
    meta = (mode=0, sad_sum, comparison_sum, row_qps, row_bits)."""
    mv = smalls[: 3 * nb]
    meta = jnp.concatenate([
        jnp.stack([jnp.int32(0), smalls[3 * nb : 4 * nb].sum(),
                   smalls[4 * nb : 5 * nb].sum()]),
        smalls[5 * nb :],
    ])
    return meta, mv, jnp.zeros(nb, jnp.uint8)


def _meta_i(smalls, nb, nbr):
    """Intra smalls [2nb+2nbr] -> (meta, mv=zeros, modes).
    meta = (mode=1, mae_sum, 2*nb, row_qps, row_bits)."""
    modes = smalls[:nb].astype(jnp.uint8)
    meta = jnp.concatenate([
        jnp.stack([jnp.int32(1), smalls[nb : 2 * nb].sum(),
                   jnp.int32(2 * nb)]),
        smalls[2 * nb :],
    ])
    return meta, jnp.zeros(3 * nb, jnp.int32), modes


@partial(jax.jit, static_argnames=("bs", "rc1", "exact", "compact", "int8q",
                                   "q4", "tail", "packed_shape", "qfrac",
                                   "devb"))
def encode_chunk_intra_only(
    frames: jnp.ndarray,        # uint8 [K, H, W] (or packed upload buffer)
    row_qps: jnp.ndarray,       # int32 [nbr]
    budget0: jnp.ndarray,
    tbl_qps: jnp.ndarray,
    tbl_bits: jnp.ndarray,
    initial_qp: jnp.ndarray,
    bs: int,
    rc1: bool,
    exact: bool = False,
    compact: bool = False,
    int8q: bool = False,
    q4: bool = False,
    tail: bool = False,
    packed_shape: tuple | None = None,
    qfrac: tuple | None = None,
    devb: bool = False,
):
    """All-intra chunk (I_Period == 1): every frame clears the reference
    deques, so frames are fully independent — one ``vmap`` instead of a scan.
    Returns stacked ``(recons, arts, qdcts, smalls)``; with ``compact``,
    appends ``(qvals, qlens, qtotals)`` (I-frame res planes are host-derived,
    ops/pack.py).  ``packed_shape=(K, H, W)`` marks ``frames`` as a packed
    nibble-delta upload buffer (ops/pack.unpack_input_chunk)."""
    if packed_shape is not None:
        frames = P.unpack_input_chunk(frames, *packed_shape)

    def one(frame):
        recon, _, art, qdct, smalls = intra_encode_frame(
            frame, row_qps, budget0, tbl_qps, tbl_bits, initial_qp, bs, rc1,
            emit_halfpel=False, exact=exact,
        )
        return recon, art, qdct, smalls

    recons, arts, qdcts, smalls = jax.vmap(one)(frames)
    if not compact:
        return recons, arts, qdcts, smalls
    h, w = frames.shape[1:]
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    layout = P.FrameLayout(h, w, bs, 1 if int8q else 2, False, False,
                           q4=q4, tail=tail, qfrac=qfrac, devbits=devb)
    cap = layout.cape
    if devb:
        dbs, dbitss, dns = jax.vmap(
            lambda q: _devbits_dct(q, bs, layout))(qdcts)

        def row_db(r, q, sm, dn_, dbits_):
            meta, _, modes = _meta_i(sm, nb, nbr)
            pb_, pbits_ = _devbits_pred_i(
                sm[2 * nb : 2 * nb + nbr], initial_qp, sm[:nb], layout)
            rc, re, rn = _pack_intra_recon(r, q, sm, bs, nb, nbr, nbc, cap)
            head = P.pack_row(rc, re, rn, meta, None, modes,
                              None, None, None, bs=bs, tail=tail,
                              dev=(dn_, dbits_, pbits_))
            return head, re, rn, pb_, pbits_

        packed, res, rns, pbs, pbitss = jax.vmap(row_db)(
            recons, qdcts, smalls, dns, dbitss)
        if tail:
            zk = jnp.zeros(dns.shape[0], jnp.int32)
            pool = P.pack_tail_pool(layout, None, None, None, zk, None,
                                    None, res=res, rns=rns, dbs=dbs,
                                    dbitss=dbitss, pbs=pbs, pbitss=pbitss)
            packed = jnp.concatenate([packed.reshape(-1), pool])
        return recons, arts, qdcts, smalls, packed

    qp = _pack_qdct_stack(qdcts, bs, jnp.int8 if int8q else jnp.int16, q4,
                          layout.capq)
    qv, ql, qt = qp[:3]

    def row(r, q, sm, v, l, t, qen=None):
        meta, _, modes = _meta_i(sm, nb, nbr)
        rc, re, rn = _pack_intra_recon(r, q, sm, bs, nb, nbr, nbc, cap)
        head = P.pack_row(rc, re, rn, meta, None, modes, v, l, t, bs=bs,
                          qe4=qen[0] if qen else None,
                          qn4=qen[1] if qen else None,
                          qe=qen[2] if qen else None,
                          qn=qen[3] if qen else None, tail=tail)
        return head, re, rn

    args = (recons, qdcts, smalls, qv, ql, qt)
    if q4:
        args = args + ((qp[3], qp[4], qp[5], qp[6]),)
    packed, res, rns = jax.vmap(row)(*args)
    if tail:
        zk = jnp.zeros(qt.shape[0], jnp.int32)
        pool = P.pack_tail_pool(layout, None, qv, qp[5] if q4 else None,
                                zk, qt, qp[6] if q4 else zk,
                                res=res, rns=rns,
                                qe4s=qp[3] if q4 else None,
                                qn4s=qp[4] if q4 else zk)
        packed = jnp.concatenate([packed.reshape(-1), pool])
    return recons, arts, qdcts, smalls, packed


@partial(jax.jit, static_argnames=("bs", "search_range", "rc1", "fast", "frac",
                                   "first_is_intra", "exact", "compact",
                                   "int8q", "mv8", "q4", "tail",
                                   "packed_shape", "qfrac", "devb"))
def encode_chunk(
    frames: jnp.ndarray,        # uint8 [K, H, W] (or packed upload buffer)
    ref0: jnp.ndarray,          # uint8 [H, W] incoming reference (used iff not first_is_intra)
    hp0: jnp.ndarray,           # uint8 [2H, 2W] its half-pel plane (used iff frac)
    row_qps: jnp.ndarray,       # int32 [nbr]
    budget0: jnp.ndarray,       # float32 scalar (RC1)
    tbl_qps: jnp.ndarray,
    tbl_bits: jnp.ndarray,
    initial_qp: jnp.ndarray,
    bs: int,
    search_range: int,
    rc1: bool,
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
    """Returns ``(intra_out | None, p_out, ref_out, hp_out)`` where
    ``intra_out = (recon, art, qdct, smalls)`` for frames[0] and
    ``p_out = (recons, arts, qdcts, smalls)`` stacked over the chunk's
    P-frames; ``ref_out``/``hp_out`` carry the reference into the next chunk.

    With ``compact``, returns a fifth element ``packed`` — ONE uint8
    buffer [K_frames, NB] holding every per-frame field the host needs
    (ops/pack.py FrameLayout; the intra frame is row 0 with its smalls
    zero-padded to the P length), so a chunk costs a single device->host
    transfer.  The full art/qdct planes remain device-resident for the
    per-frame overflow fallback.
    """
    if packed_shape is not None:
        frames = P.unpack_input_chunk(frames, *packed_shape)
    h, w = frames.shape[1:]
    zeros_hp = jnp.zeros((2 * h, 2 * w), jnp.uint8)

    if first_is_intra:
        recon_i, hp_i, art_i, qdct_i, smalls_i = intra_encode_frame(
            frames[0], row_qps, budget0, tbl_qps, tbl_bits, initial_qp,
            bs, rc1, emit_halfpel=frac, exact=exact,
        )
        intra_out = (recon_i, art_i, qdct_i, smalls_i)
        carry = (recon_i, hp_i if frac else zeros_hp)
        p_frames = frames[1:]
    else:
        intra_out = None
        carry = (ref0, hp0 if frac else zeros_hp)
        p_frames = frames

    def step(carry, curr):
        ref, hp = carry
        out = pframe_encode(
            curr, (ref,), (hp,) if frac else (), row_qps, budget0,
            tbl_qps, tbl_bits, initial_qp, bs, search_range, rc1, fast, frac,
            False, emit_halfpel=frac, exact=exact, emit_pred=compact,
        )
        recon, hp2, art, qdct, smalls = out[:5]
        if not frac:
            hp2 = hp
        outs = (recon, art, qdct, smalls) + ((out[5],) if compact else ())
        return (recon, hp2), outs

    if p_frames.shape[0] > 0:
        (ref_out, hp_out), p_out = jax.lax.scan(step, carry, p_frames)
    else:
        ref_out, hp_out = carry
        nbr, nbc = h // bs, w // bs
        nb = nbr * nbc
        p_out = (
            jnp.zeros((0, h, w), jnp.uint8),
            jnp.zeros((0, h, w), jnp.uint8),
            jnp.zeros((0, h, w), jnp.int16),
            jnp.zeros((0, 5 * nb + 2 * nbr), jnp.int32),
        ) + ((jnp.zeros((0, h, w), jnp.uint8),) if compact else ())

    if not compact:
        return intra_out, p_out, ref_out, hp_out

    mvn = P.mv_nibble_static(fast, frac, search_range, 1)
    packed = _pack_chunk_rows(
        (recon_i, qdct_i, smalls_i) if intra_out is not None else None,
        p_out[:4], p_out[4], bs, int8q, h, w, mv8, q4, q4 and not rc1,
        tail=tail, mvk=2, mvn=mvn, qfrac=qfrac, devb=devb,
        initial_qp=initial_qp)
    return intra_out, p_out[:4], ref_out, hp_out, packed


def _pack_runtime_mode_rows(recons, arts, qdcts, smalls, preds, bs, int8q,
                            mv8, q4, h, w, tail=False, mvk=3, mvn=False,
                            qfrac=None, devb=False, initial_qp=None):
    """Compact-transfer rows for chunks whose per-frame mode is a RUNTIME
    value (the fused two-pass chunk's scene changes, the mixed multi-GOP
    chunk's position-scheduled intra frames), in the same ops/pack.py
    FrameLayout as :func:`_pack_chunk_rows` — the meta/mv/modes fields are
    selected per frame with ``where``.  With ``tail``, returns the fused
    [K*headB + pool] buffer like the chunk packer."""
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    vdtype = jnp.int8 if int8q else jnp.int16
    layout = P.FrameLayout(h, w, bs, 1 if int8q else 2, True, True, mv8, q4,
                           False, tail=tail, mvk=mvk, mvn=mvn, qfrac=qfrac,
                           devbits=devb)
    capq = layout.capq
    cap = layout.cape

    def row(recon, art, qdct, sm, pred_u8):
        is_i = sm[0] == 1
        payload = sm[1 : 1 + 5 * nb]
        rq = sm[1 + 5 * nb : 1 + 5 * nb + nbr]
        rb = sm[1 + 5 * nb + nbr :]
        meta_i = jnp.stack([jnp.int32(1), payload[nb : 2 * nb].sum(),
                            jnp.int32(2 * nb)])
        meta_p = jnp.stack([jnp.int32(0), payload[3 * nb : 4 * nb].sum(),
                            payload[4 * nb : 5 * nb].sum()])
        meta = jnp.concatenate([jnp.where(is_i, meta_i, meta_p), rq, rb])
        mv = jnp.where(is_i, 0, payload[: 3 * nb])
        modes = jnp.where(is_i, payload[:nb], 0).astype(jnp.uint8)
        if devb:
            db_, dbits_, dn_ = _devbits_dct(qdct, bs, layout)
            pb_, pbits_ = _devbits_pred_rt(rq, initial_qp, is_i, modes, mv,
                                           layout, nbr, nbc)
        if mvk == 2:
            mv = mv.reshape(-1, 3)[:, :2].reshape(-1)
        if layout.mvd:
            bm_, mn_, mvz_ = P.pack_mv_delta(mv)
            mv = (bm_, mn_)
        else:
            mn_, mvz_ = jnp.int32(0), jnp.zeros(0, jnp.uint8)
        pred = pred_u8.astype(jnp.int32)
        x = P.exact_x_blocks(qdct, rq, bs)
        guess = P.recon_guess_from_x(x, pred, bs)
        # art half zeroed on intra rows (their res planes are host-derived)
        jb, jk, jn, re, rn, ae, an = P.pack_joint(
            recon, guess, art, P.art_guess_from_x(x), cap, art_valid=~is_i,
            capk=layout.capk)
        if tail:
            j2, j1z, j1n, jbz, jbn = P.split_bitmap(jb)
            codes = (j2, j1n, jbn, jn)
        else:
            j1z, j1n = jnp.zeros(0, jnp.uint8), jnp.int32(0)
            jbz, jbn = jnp.zeros(0, jnp.uint8), jnp.int32(0)
            codes = (jb, jk, jn)
        if devb:
            head = P.pack_row(codes, re, rn, meta, mv, modes,
                              None, None, None, ae, an, bs=bs, mv8=mv8,
                              mvn=mvn, tail=tail, dev=(dn_, dbits_, pbits_))
            return (head, jk, jn, jbz, jbn, j1z, j1n,
                    re, rn, ae, an, mvz_, mn_, db_, dbits_, pb_, pbits_)
        qp_ = P.pack_qdct(qdct, bs, capq, vdtype, q4)
        head = P.pack_row(codes, re, rn, meta, mv, modes,
                          qp_[0], qp_[1], qp_[2], ae, an, bs=bs, mv8=mv8,
                          mvn=mvn, qe4=qp_[3] if q4 else None,
                          qn4=qp_[4] if q4 else None,
                          qe=qp_[5] if q4 else None,
                          qn=qp_[6] if q4 else None, tail=tail)
        qe_ = qp_[5] if q4 else jnp.zeros(0, jnp.int16)
        qn_ = qp_[6] if q4 else jnp.int32(0)
        qe4_ = qp_[3] if q4 else jnp.zeros(0, jnp.uint8)
        qn4_ = qp_[4] if q4 else jnp.int32(0)
        return (head, jk, qp_[0], qe_, jn, qp_[2], qn_, jbz, jbn, j1z, j1n,
                re, rn, ae, an, qe4_, qn4_, mvz_, mn_)

    if devb:
        (heads, jks, jns, jbzs, jbns, j1zs, j1ns, res, rns, aes, ans,
         mvzs, mns, dbs, dbitss, pbs, pbitss) = jax.vmap(row)(
            recons, arts, qdcts, smalls, preds)
        if not tail:
            return heads
        pool = P.pack_tail_pool(layout, jks, None, None, jns, None, None,
                                jbzs, jbns, j1zs, j1ns, res, rns, aes, ans,
                                mvzs=mvzs if layout.mvd else None,
                                mns=mns if layout.mvd else None,
                                dbs=dbs, dbitss=dbitss, pbs=pbs,
                                pbitss=pbitss)
        return jnp.concatenate([heads.reshape(-1), pool])

    (heads, jks, qvs, qes, jns, qts, qns, jbzs, jbns, j1zs, j1ns, res, rns,
     aes, ans, qe4s, qn4s, mvzs, mns) = jax.vmap(row)(recons, arts, qdcts,
                                                      smalls, preds)
    if not tail:
        return heads
    pool = P.pack_tail_pool(layout, jks, qvs, qes if q4 else None,
                            jns, qts, qns, jbzs, jbns, j1zs, j1ns,
                            res, rns, aes, ans, qe4s if q4 else None, qn4s,
                            mvzs=mvzs if layout.mvd else None,
                            mns=mns if layout.mvd else None)
    # fused [K*headB + pool] buffer: one predictively-sized fetch per chunk
    # (:func:`_pack_chunk_rows` has the rationale)
    return jnp.concatenate([heads.reshape(-1), pool])


@partial(jax.jit, static_argnames=("bs", "search_range", "rc1", "fast",
                                   "frac", "exact", "compact", "int8q",
                                   "mv8", "q4", "tail", "packed_shape",
                                   "qfrac", "devb"))
def encode_chunk_mixed(
    frames: jnp.ndarray,        # uint8 [K, H, W] (or packed upload buffer)
    ref0: jnp.ndarray,          # uint8 [H, W] incoming reference
    hp0: jnp.ndarray,           # uint8 [2H, 2W] its half-pel plane (iff frac)
    is_intra: jnp.ndarray,      # bool [K]: per-frame mode by GOP position
    row_qps: jnp.ndarray,       # int32 [nbr]
    budget0: jnp.ndarray,
    tbl_qps: jnp.ndarray,
    tbl_bits: jnp.ndarray,
    initial_qp: jnp.ndarray,
    bs: int,
    search_range: int,
    rc1: bool,
    fast: bool,
    frac: bool,
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
    """Multi-GOP chunk (single reference, RC 0/1): a ``lax.scan`` whose step
    ``lax.cond``s into the intra or P encode by the frame's GOP position, so
    one dispatched program (and ONE d2h fetch) spans I-frame boundaries —
    :func:`encode_chunk` caps chunks at ``I_Period`` frames, which leaves
    2-10-frame chunks paying a fetch round trip each on short-GOP configs
    (the reference's own benchmark configs run I_Period 1-21,
    reference assign1/ex4_plots.py, assign3/Deliverable.py).

    The per-frame mode is a TRACED array, so every chunk composition reuses
    one compiled program per chunk length.  Returns
    ``((recons, arts, qdcts, smalls, packed), ref_out, hp_out)`` with the
    runtime-mode smalls layout of models/two_pass.py (mode-led, mvk=2)."""
    if packed_shape is not None:
        frames = P.unpack_input_chunk(frames, *packed_shape)
    k, h, w = frames.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    zeros_hp = jnp.zeros((2 * h, 2 * w), jnp.uint8)

    def step(carry, x):
        ref, hp = carry
        curr, is_i = x

        def as_intra(_):
            recon, hp2, art, qdct, smalls = intra_encode_frame(
                curr, row_qps, budget0, tbl_qps, tbl_bits, initial_qp, bs,
                rc1, emit_halfpel=frac, exact=exact,
            )
            modes = smalls[:nb]
            sm = jnp.concatenate([
                jnp.ones(1, jnp.int32), smalls[: 2 * nb],
                jnp.zeros(3 * nb, jnp.int32), smalls[2 * nb :],
            ])
            out = (recon, hp2 if frac else hp, art, qdct, sm)
            if compact:
                pred = P.intra_pred_plane(recon, modes.reshape(nbr, nbc), bs)
                out = out + (pred.astype(jnp.uint8),)
            return out

        def as_p(_):
            out_p = pframe_encode(
                curr, (ref,), (hp,) if frac else (), row_qps, budget0,
                tbl_qps, tbl_bits, initial_qp, bs, search_range, rc1, fast,
                frac, False, emit_halfpel=frac, exact=exact,
                emit_pred=compact,
            )
            recon, hp2, art, qdct, smalls = out_p[:5]
            sm = jnp.concatenate([jnp.zeros(1, jnp.int32), smalls])
            out = (recon, hp2 if frac else hp, art, qdct, sm)
            if compact:
                out = out + (out_p[5],)
            return out

        res = jax.lax.cond(is_i, as_intra, as_p, None)
        recon, hp2 = res[0], res[1]
        return (recon, hp2), (recon,) + res[2:]

    carry = (ref0, hp0 if frac else zeros_hp)
    (ref_out, hp_out), scanned = jax.lax.scan(step, carry, (frames, is_intra))
    recons, arts, qdcts, smalls = scanned[:4]
    if compact:
        mvn = P.mv_nibble_static(fast, frac, search_range, 1)
        packed = _pack_runtime_mode_rows(recons, arts, qdcts, smalls,
                                         scanned[4], bs, int8q, mv8, q4,
                                         h, w, tail=tail, mvk=2, mvn=mvn,
                                         qfrac=qfrac, devb=devb,
                                         initial_qp=initial_qp)
    else:
        # bundle the full planes into one buffer per chunk (the two_pass
        # non-compact transport: bitcast+concat, one transfer per chunk)
        packed = jax.vmap(
            lambda r, a, q, sm: P.concat_bytes(r, a, q, sm)
        )(recons, arts, qdcts, smalls)
    return (recons, arts, qdcts, smalls, packed), ref_out, hp_out


def _push_ref(refs, hps, n_valid, recon, hp, frac):
    """Append to a fixed-shape rolling reference stack (deque semantics:
    slot 0 = oldest, reference encoder.py:33/PFrame.py:103).  While warming
    up, the new frame lands in slot ``n_valid``; once full, the stack shifts
    left and the new frame takes the last slot."""
    R = refs.shape[0]
    full = n_valid >= R
    refs_s = jnp.where(full, jnp.roll(refs, -1, axis=0), refs)
    idx = jnp.where(full, R - 1, n_valid)
    refs2 = jax.lax.dynamic_update_index_in_dim(refs_s, recon, idx, 0)
    if frac:
        hps_s = jnp.where(full, jnp.roll(hps, -1, axis=0), hps)
        hps2 = jax.lax.dynamic_update_index_in_dim(hps_s, hp, idx, 0)
    else:
        hps2 = hps
    return refs2, hps2, jnp.minimum(n_valid + 1, R)


@partial(jax.jit, static_argnames=("bs", "search_range", "rc1", "fast", "frac",
                                   "first_is_intra", "exact", "compact",
                                   "int8q", "mv8", "q4", "tail",
                                   "packed_shape", "qfrac", "devb"))
def encode_chunk_multiref(
    frames: jnp.ndarray,        # uint8 [K, H, W] (or packed upload buffer)
    refs0: jnp.ndarray,         # uint8 [R, H, W] incoming rolling stack
    hps0: jnp.ndarray,          # uint8 [R, 2H, 2W] (used iff frac)
    n_valid0: jnp.ndarray,      # int32 scalar: populated slots of refs0
    row_qps: jnp.ndarray,
    budget0: jnp.ndarray,
    tbl_qps: jnp.ndarray,
    tbl_bits: jnp.ndarray,
    initial_qp: jnp.ndarray,
    bs: int,
    search_range: int,
    rc1: bool,
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
    """nRefFrames > 1 GOP chunk: :func:`encode_chunk` with the single
    reference replaced by a rolling stack carried through the scan.  The
    stack is fixed-shape; ``n_valid`` masks the warm-up (ops/me.py /
    ops/fastme.py candidate masking reproduces the reference's
    variable-length deque decisions exactly).

    Returns ``(intra_out | None, p_out, refs_out, hps_out, n_valid_out
    [, packed])`` with the same per-frame leaves as :func:`encode_chunk`.
    """
    if packed_shape is not None:
        frames = P.unpack_input_chunk(frames, *packed_shape)
    k, h, w = frames.shape
    R = refs0.shape[0]
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc

    if first_is_intra:
        recon_i, hp_i, art_i, qdct_i, smalls_i = intra_encode_frame(
            frames[0], row_qps, budget0, tbl_qps, tbl_bits, initial_qp,
            bs, rc1, emit_halfpel=frac, exact=exact,
        )
        intra_out = (recon_i, art_i, qdct_i, smalls_i)
        refs_c = jnp.zeros((R, h, w), jnp.uint8)
        hps_c = jnp.zeros((R, 2 * h, 2 * w), jnp.uint8)
        refs_c, hps_c, nv = _push_ref(
            refs_c, hps_c, jnp.int32(0), recon_i,
            hp_i if frac else jnp.zeros((2 * h, 2 * w), jnp.uint8), frac)
        carry = (refs_c, hps_c, nv)
        p_frames = frames[1:]
    else:
        intra_out = None
        carry = (refs0, hps0, n_valid0)
        p_frames = frames

    def step(carry, curr):
        refs, hps, nv = carry
        out = pframe_encode(
            curr, refs, hps if frac else (), row_qps, budget0,
            tbl_qps, tbl_bits, initial_qp, bs, search_range, rc1, fast, frac,
            True, emit_halfpel=frac, exact=exact, n_valid=nv, emit_pred=compact,
        )
        recon, hp2, art, qdct, smalls = out[:5]
        outs = (recon, art, qdct, smalls) + ((out[5],) if compact else ())
        refs, hps, nv = _push_ref(
            refs, hps, nv, recon,
            hp2 if frac else jnp.zeros((2 * h, 2 * w), jnp.uint8), frac)
        return (refs, hps, nv), outs

    if p_frames.shape[0] > 0:
        (refs_out, hps_out, nv_out), p_out = jax.lax.scan(step, carry, p_frames)
    else:
        refs_out, hps_out, nv_out = carry
        p_out = (
            jnp.zeros((0, h, w), jnp.uint8),
            jnp.zeros((0, h, w), jnp.uint8),
            jnp.zeros((0, h, w), jnp.int16),
            jnp.zeros((0, 5 * nb + 2 * nbr), jnp.int32),
        ) + ((jnp.zeros((0, h, w), jnp.uint8),) if compact else ())

    if not compact:
        return intra_out, p_out, refs_out, hps_out, nv_out

    packed = _pack_chunk_rows(
        (recon_i, qdct_i, smalls_i) if intra_out is not None else None,
        p_out[:4], p_out[4], bs, int8q, h, w, mv8, q4, q4 and not rc1,
        tail=tail, qfrac=qfrac, devb=devb, initial_qp=initial_qp)
    return intra_out, p_out[:4], refs_out, hps_out, nv_out, packed


def decode_row_bytes(h: int, w: int, cap: int) -> int:
    """Byte width of one compact decode row: the 2-bit code plane, the
    escape list and the int32 escape count (:func:`_decode_codes_row` /
    ops/pack.pack_vs_base define the layout; the empty-chunk stubs below
    must agree)."""
    return h * w // 4 + cap + 4


def _decode_codes_row(dec, qdct, row_qps, pred_u8, bs, cap):
    """Compact decode transfer: one frame's 2-bit correction codes vs the
    integer-exact reconstruction guess the host recomputes from the parsed
    stream (qdct + prediction), concat'd with the escape list and count —
    ~HW/4 bytes instead of the HW decoded plane."""
    x = P.exact_x_blocks(qdct, row_qps, bs)
    guess = P.recon_guess_from_x(x, pred_u8.astype(jnp.int32), bs)
    codes2, esc, rn = P.pack_vs_base(dec, guess, cap)
    return P.concat_bytes(codes2, esc, rn)


@partial(jax.jit, static_argnames=("bs", "frac", "exact", "compact"))
def decode_chunk_intra_only(
    qdcts: jnp.ndarray,     # int32 [K, H, W]
    modes: jnp.ndarray,     # int32 [K, nbr, nbc]
    row_qps: jnp.ndarray,   # int32 [K, nbr]
    bs: int,
    frac: bool,
    exact: bool = False,
    compact: bool = False,
):
    """All-intra decode chunk: frames are independent -> vmap.
    Returns ``(decoded [K, H, W], ref_out, hp_out[, packed])``."""
    h, w = qdcts.shape[1:]
    cap = P.esc_cap(h, w)

    def one(q, m, r):
        dec = intra_decode_frame(q, m, r, bs, emit_halfpel=False,
                                 exact=exact)[0]
        if not compact:
            return dec, jnp.zeros(0, jnp.uint8)
        pred = P.intra_pred_plane(dec, m, bs).astype(jnp.uint8)
        return dec, _decode_codes_row(dec, q, r, pred, bs, cap)

    decoded, packed = jax.vmap(one)(qdcts, modes, row_qps)
    ref_out = decoded[-1]
    if frac:
        from ..ops.interp import build_half_pel

        hp_out = build_half_pel(ref_out)
    else:
        hp_out = jnp.zeros((2 * h, 2 * w), jnp.uint8)
    if compact:
        return decoded, ref_out, hp_out, packed
    return decoded, ref_out, hp_out


@partial(jax.jit, static_argnames=("bs", "frac", "first_is_intra", "exact",
                                   "compact"))
def decode_chunk(
    qdcts: jnp.ndarray,     # int32 [K, H, W]
    mvs: jnp.ndarray,       # int32 [K, nbr, nbc, 3] (row 0 ignored if intra)
    row_qps: jnp.ndarray,   # int32 [K, nbr]
    modes0: jnp.ndarray,    # int32 [nbr, nbc] (frame 0's intra modes)
    ref0: jnp.ndarray,      # uint8 [H, W] incoming reference
    hp0: jnp.ndarray,       # uint8 [2H, 2W]
    bs: int,
    frac: bool,
    first_is_intra: bool,
    exact: bool = False,
    compact: bool = False,
):
    """Decode one GOP segment in a single program (the decode mirror of
    :func:`encode_chunk`).  Returns ``(decoded [K, H, W], ref_out,
    hp_out[, packed [K, rowB]])``."""
    k, h, w = qdcts.shape
    cap = P.esc_cap(h, w)

    if first_is_intra:
        dec0, hp_i = intra_decode_frame(qdcts[0], modes0, row_qps[0], bs,
                                        emit_halfpel=frac, exact=exact)
        if compact:
            pred0 = P.intra_pred_plane(dec0, modes0, bs).astype(jnp.uint8)
            row0 = _decode_codes_row(dec0, qdcts[0], row_qps[0], pred0, bs,
                                     cap)
        carry = (dec0, hp_i if frac else hp0)
        p_qdcts, p_mvs, p_qps = qdcts[1:], mvs[1:], row_qps[1:]
    else:
        carry = (ref0, hp0)
        p_qdcts, p_mvs, p_qps = qdcts, mvs, row_qps

    def step(carry, inp):
        ref, hp = carry
        qdct, mv, qps = inp
        out = pframe_decode(qdct, mv, qps, (ref,), (hp,) if frac else (),
                            bs, frac, emit_halfpel=frac, exact=exact,
                            emit_pred=compact)
        dec, hp2 = out[0], out[1]
        if not frac:
            hp2 = hp
        ys = ((dec, _decode_codes_row(dec, qdct, qps, out[2], bs, cap))
              if compact else dec)
        return (dec, hp2), ys

    if p_qdcts.shape[0] > 0:
        (ref_out, hp_out), scanned = jax.lax.scan(
            step, carry, (p_qdcts, p_mvs, p_qps))
        decs, rows = scanned if compact else (scanned, None)
    else:
        ref_out, hp_out = carry
        decs = jnp.zeros((0, h, w), jnp.uint8)
        rows = jnp.zeros((0, decode_row_bytes(h, w, cap)), jnp.uint8)
    if first_is_intra:
        decoded = jnp.concatenate([dec0[None], decs])
        if compact:
            rows = jnp.concatenate([row0[None], rows])
    else:
        decoded = decs
    if compact:
        return decoded, ref_out, hp_out, rows
    return decoded, ref_out, hp_out


@partial(jax.jit, static_argnames=("bs", "frac", "first_is_intra", "exact",
                                   "compact"))
def decode_chunk_multiref(
    qdcts: jnp.ndarray,     # int32 [K, H, W]
    mvs: jnp.ndarray,       # int32 [K, nbr, nbc, 3] (row 0 ignored if intra)
    row_qps: jnp.ndarray,   # int32 [K, nbr]
    modes0: jnp.ndarray,    # int32 [nbr, nbc] (frame 0's intra modes)
    refs0: jnp.ndarray,     # uint8 [R, H, W] incoming rolling stack
    hps0: jnp.ndarray,      # uint8 [R, 2H, 2W]
    n_valid0: jnp.ndarray,  # int32 scalar
    bs: int,
    frac: bool,
    first_is_intra: bool,
    exact: bool = False,
    compact: bool = False,
):
    """nRefFrames > 1 decode chunk: :func:`decode_chunk` with a rolling
    reference stack (encoder-produced MV ref indices are always < the
    populated slot count, so no candidate masking is needed here).
    Returns ``(decoded [K, H, W], refs_out, hps_out, n_valid_out
    [, packed])``."""
    k, h, w = qdcts.shape
    R = refs0.shape[0]
    cap = P.esc_cap(h, w)

    if first_is_intra:
        dec0, hp_i = intra_decode_frame(qdcts[0], modes0, row_qps[0], bs,
                                        emit_halfpel=frac, exact=exact)
        if compact:
            pred0 = P.intra_pred_plane(dec0, modes0, bs).astype(jnp.uint8)
            row0 = _decode_codes_row(dec0, qdcts[0], row_qps[0], pred0, bs,
                                     cap)
        refs_c = jnp.zeros((R, h, w), jnp.uint8)
        hps_c = jnp.zeros((R, 2 * h, 2 * w), jnp.uint8)
        refs_c, hps_c, nv = _push_ref(
            refs_c, hps_c, jnp.int32(0), dec0,
            hp_i if frac else jnp.zeros((2 * h, 2 * w), jnp.uint8), frac)
        carry = (refs_c, hps_c, nv)
        p_qdcts, p_mvs, p_qps = qdcts[1:], mvs[1:], row_qps[1:]
    else:
        carry = (refs0, hps0, n_valid0)
        p_qdcts, p_mvs, p_qps = qdcts, mvs, row_qps

    def step(carry, inp):
        refs, hps, nv = carry
        qdct, mv, qps = inp
        out = pframe_decode(qdct, mv, qps, refs, hps if frac else (),
                            bs, frac, emit_halfpel=frac, exact=exact,
                            emit_pred=compact)
        dec, hp2 = out[0], out[1]
        refs, hps, nv = _push_ref(
            refs, hps, nv, dec,
            hp2 if frac else jnp.zeros((2 * h, 2 * w), jnp.uint8), frac)
        ys = ((dec, _decode_codes_row(dec, qdct, qps, out[2], bs, cap))
              if compact else dec)
        return (refs, hps, nv), ys

    if p_qdcts.shape[0] > 0:
        (refs_out, hps_out, nv_out), scanned = jax.lax.scan(
            step, carry, (p_qdcts, p_mvs, p_qps))
        decs, rows = scanned if compact else (scanned, None)
    else:
        refs_out, hps_out, nv_out = carry
        decs = jnp.zeros((0, h, w), jnp.uint8)
        rows = jnp.zeros((0, decode_row_bytes(h, w, cap)), jnp.uint8)
    if first_is_intra:
        decoded = jnp.concatenate([dec0[None], decs])
        if compact:
            rows = jnp.concatenate([row0[None], rows])
    else:
        decoded = decs
    if compact:
        return decoded, refs_out, hps_out, nv_out, rows
    return decoded, refs_out, hps_out, nv_out
