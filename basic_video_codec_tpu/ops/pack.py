"""Compact device->host transfer codecs for the chunked encode pipeline.

The scheme was built for the earlier accelerator's narrow device->host
link; what it costs and saves on the GPU is not yet measured.  The raw
per-frame outputs are ~4 bytes/pixel (recon u8 + res_w_mc u8 + qdct i16); this module shrinks
them to ~2 bytes/pixel *losslessly* by exploiting structure the host can
cheaply re-expand:

* **qdct**: after zigzag, blocks end in long zero tails — transfer only each
  block's nonzero prefix (values + per-block lengths), scatter-compacted on
  device into a fixed-size buffer; at fixed QP >= 5 the values travel as
  4-bit nibbles with an int16 escape list (~3% escape rate measured).
  Typical CIF P-frame: 203 KB -> ~24 KB.
* **recon + res_w_mc** (P-frames): both planes travel as correction codes
  against integer-exact guesses the host recomputes bit-identically from
  one shared integer IDCT (ops/transform.py idct2_exact_core):
  ``recon_guess = clip(rshift_round(x + (pred << SHIFT)))`` and
  ``art_guess = trunc(x >> SHIFT) mod 256``.  Each code is {match, +1, -1,
  escape}, and because round(...) and trunc(...) flip at different
  fractional boundaries the two planes' nonzero codes are nearly disjoint
  (~0.1% overlap measured) — so ONE joint state stream (:func:`pack_joint`)
  encodes both, entropy-split into a 1-bit nonzero bitmap plus a compacted
  3-bit kind list: 2 x 101 KB -> ~25 KB + tiny escape lists.  Inter frames
  rebuild vectorized; intra frames rebuild
  block-by-block in scan order (the prediction chain), with the IDCT still
  batched.
* **res_w_mc** (I-frames): pure integer function of (curr, recon, modes) —
  all host-resident — so nothing is transferred at all.

Every scheme has a per-frame overflow flag; the full planes remain device
outputs and are fetched only for flagged frames (never on typical content —
caps are sized ~2x the measured worst case).  Correctness is independently
guarded by the pipeline's bit-pricing assertion and the golden-parity tests,
which compare every artifact byte-for-byte.

Device-side packing is pure vector work (one stream compaction per plane,
:func:`compact_stream`); host-side unpacking is vectorized NumPy on the finalize worker pool.
"""

import jax
import jax.numpy as jnp
import numpy as np

PREFIX_CAP_FRACTION = 3, 8  # capacity = 3/8 of the plane's coefficients

def _use_sort_compaction() -> bool:
    """Stream compaction by stable sort on the GPU, by scatter on the CPU.

    Measured at the CIF plane size (8 frames, 30% kept, two payloads): on an
    H100 the sort takes 0.26 ms and the scatter 1,957 ms, since every dropped
    element scatters to the same dump slot; on the CPU backend the scatter is
    the faster one (~5 vs ~200 ms).  Outputs are byte-identical either way
    (asserted in tests/test_pack.py)."""
    return jax.default_backend() != "cpu"


def compact_stream(keep: jnp.ndarray, payloads: tuple, cap: int):
    """Stream compaction: each payload's ``keep`` elements move to the
    front in original order, truncated to ``cap``, zeros beyond the kept
    count.  ``keep`` is bool [n]; payloads are 1-D [n] arrays (n >= cap).

    Returns ``(n_keep int32, out_0, ..., out_m)`` with ``out_i`` shaped
    [cap].  The sort and scatter implementations produce identical bytes
    (:func:`_use_sort_compaction` picks one); both vmap cleanly over
    frames."""
    if _use_sort_compaction():
        return compact_stream_sort(keep, payloads, cap)
    return compact_stream_scatter(keep, payloads, cap)


def compact_stream_sort(keep, payloads, cap):
    """:func:`compact_stream` as one stable sort keyed by the drop flag."""
    n = keep.sum().astype(jnp.int32)
    sorted_ = jax.lax.sort(((~keep).astype(jnp.uint8),) + tuple(payloads),
                           dimension=0, is_stable=True, num_keys=1)[1:]
    live = jnp.arange(cap, dtype=jnp.int32) < n
    return (n, *[jnp.where(live, o[:cap], jnp.zeros((), o.dtype))
                 for o in sorted_])


def compact_stream_scatter(keep, payloads, cap):
    """:func:`compact_stream` as a cumsum of ``keep`` and one scatter per
    payload."""
    n = keep.sum().astype(jnp.int32)
    off = jnp.cumsum(keep) - keep
    idx = jnp.where(keep & (off < cap), off, cap)
    return (n, *[jnp.zeros(cap + 1, p.dtype).at[idx].set(p)[:cap]
                 for p in payloads])


# Escape lists hold only float-vs-fixed-point rounding disagreements (both
# the recon codes and the art codes are based on integer-exact guesses), so
# the capacity is a small fraction of the plane (measured: <= a handful of
# escapes per CIF frame; the cap leaves ~100x headroom, and an overflow
# only costs a full-plane fallback fetch, never correctness).
ESC_DIVISOR = 256


def qdct_caps(nb: int, bs: int, qfrac: tuple = None) -> int:
    """Zigzag-prefix value capacity: a config-class fraction of the plane's
    coefficient count (:func:`qcap_fraction`).  Sized from measured prefix
    totals: RC / qp >= 5 configs peak at ~33% of the plane (bs-16
    deliverable) and bs-8 bench configs well under 10%, so they carry 3/8;
    fixed low QPs keep far more coefficients and get generous caps.  An
    undersized cap is worse than a generous one — every overflowing frame
    costs a synchronous full-plane fallback fetch (the tail-mode transport
    only ever fetches USED bytes, so a
    larger cap costs only device pool allocation and a bigger first-chunk
    prefetch estimate)."""
    num, den = qfrac if qfrac is not None else PREFIX_CAP_FRACTION
    cap = max(nb * bs * bs * num // den, 2048)
    return (cap + 7) // 8 * 8  # whole bytes for the 2-bit/nibble packings


def rc_bits_per_coeff(ec) -> float:
    """Rate-controlled budget density: target bits per frame over the
    plane's coefficient count.  The budget bounds how many prefix slots a
    frame can afford, so it is the right static classifier for RC caps —
    QP itself is a runtime value under RC."""
    w, h = ec.resolution
    return ec.targetBR / getattr(ec, "frame_rate", 30) / float(w * h)


def qcap_fraction(ec) -> tuple:
    """Static prefix-cap sizing class for a config.  Measured qt peaks:

    * RC with a BINDING budget stays under 3/8 of the plane (the budget
      pushes QPs up on expensive frames; the 2.4 Mbps CIF deliverable
      peaks ~33%), but a generous budget floors QP at the table minimum
      and prefixes reach ~86% (12 Mbps CIF measured qt 87k/101k, which
      overflowed EVERY frame at 3/8) — so RC classes by budget density.
    * FIXED QP has no feedback at all; its peaks are geometry-driven —
      qp 5 at block 16 / r=1 reaches ~49% on high-motion content, qp 3-4
      ~53% at r=4 (with r=1 headroom -> 3/4); fixed qp <= 2 can fill the
      plane outright.

    Tail-mode transfers fetch only USED bytes, so the generous caps cost
    device pool allocation, not transfer bytes."""
    if ec.RCflag:
        b = rc_bits_per_coeff(ec)
        if b < 0.5:
            return PREFIX_CAP_FRACTION
        if b < 1.0:
            return (3, 4)
        return (1, 1)
    if ec.quantization_factor >= 5:
        return (5, 8)
    if ec.quantization_factor >= 3:
        return (3, 4)
    return (1, 1)


def esc_cap(h: int, w: int) -> int:
    return max(h * w // ESC_DIVISOR, 256)


def mv_int8_safe(ec) -> bool:
    """True when every MV component fits int8: full search bounds |dx|, |dy|
    by the (half-pel-doubled) search range and the reference index by
    nRefFrames; fastME refinement walks are unbounded (frame-clamped), so
    fastME always uses int16."""
    r2 = max(ec.search_range, 0) * (2 if ec.fracMeEnabled else 1)
    return not ec.fastME and r2 <= 127 and ec.nRefFrames <= 127


def mv_nibble_static(fast: bool, frac: bool, search_range: int,
                     n_ref: int) -> bool:
    """True when a block's (dx, dy) fits ONE byte (two signed nibbles):
    single-reference full search with half-pel-doubled range <= 7 — the
    common small-range configs, e.g. the r=2 benchmark.  All inputs are
    static under jit, so the chunk programs call THIS function too (the
    single source of the bound; a divergent copy would pack rows in a
    layout the host no longer matches)."""
    return not fast and n_ref == 1 and search_range * (2 if frac else 1) <= 7


def mv_nibble_safe(ec) -> bool:
    """:func:`mv_nibble_static` over an EncoderConfig (host layouts)."""
    return mv_nibble_static(ec.fastME, ec.fracMeEnabled,
                            max(ec.search_range, 0), ec.nRefFrames)


def qdct_int8_safe(ec) -> bool:
    """True when every possible quantized coefficient fits int8: the max
    |coefficient| of an orthonormal 2D DCT over a [-255, 255] residual is
    255 * bs, and the smallest quant divisor is 2^qp (reference dct.py:21-32).
    Rate-controlled runs pick table QPs (>= 1), so gate on the worst case."""
    min_qp = ec.quantization_factor if ec.RCflag == 0 else 1
    # <= 126: one count of slack for the exact-transform mode's +-1 vs float
    return round(255 * ec.block_size / 2 ** min_qp) <= 126


def input_esc_cap(h: int, w: int) -> int:
    """Escape capacity of the packed INPUT upload (entries per frame):
    ~3% of the pixels — ~2x the bench fixture's measured 1.4% rate.  A
    frame exceeding it makes the whole chunk upload raw (host-side
    fallback in entropy/native.pack_input_frames), never a wrong result."""
    return max(h * w // 32, 512)


def unpack_input_chunk(buf: jnp.ndarray, k: int, h: int, w: int) -> jnp.ndarray:
    """Device inverse of the native input packer (bvc_pack_input):
    u8 [k*(h*w/2 + 2*cap)] -> u8 frames [k, h, w].

    Per frame: expand the nibble stream to int deltas (sentinel -8 =
    escape), place the int16 escape deltas (a stream compaction of the
    escape positions, then one scatter of the values), then rebuild pixels
    with a row cumsum from the 128 column-0 predictor."""
    hw = h * w
    cap = input_esc_cap(h, w)
    nib_bytes = buf[: k * hw // 2].reshape(k, hw // 2)
    esc = jax.lax.bitcast_convert_type(
        buf[k * hw // 2 :].reshape(k, cap, 2), jnp.int16)
    lo = (nib_bytes & 15).astype(jnp.int32)
    hi = (nib_bytes >> 4).astype(jnp.int32)
    nib = jnp.stack([lo, hi], axis=-1).reshape(k, hw)
    nib = nib - (nib >= 8) * 16  # sign-extend; -8 = escape sentinel

    def one(nibf, escf):
        is_esc = nibf == -8
        # pixel position of escape #r (unused slots -> dump index hw)
        n, pos = compact_stream(is_esc, (jnp.arange(hw, dtype=jnp.int32),),
                                cap)
        live = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(n, cap)
        pos = jnp.where(live, pos, hw)
        esc_plane = jnp.zeros(hw + 1, jnp.int32).at[pos].set(
            escf.astype(jnp.int32))[:hw]
        d = jnp.where(is_esc, esc_plane, nibf)
        px = 128 + jnp.cumsum(d.reshape(h, w), axis=1)
        return px.astype(jnp.uint8)

    return jax.vmap(one)(nib, esc)


# ---------------------------------------------------------------------------
# Device side (traced; called inside the chunk jits, vmapped over frames)
# ---------------------------------------------------------------------------

def pack_qdct(qdct: jnp.ndarray, bs: int, cap: int, vdtype, q4: bool = False):
    """int16 plane [H, W] -> (vals, lens [nb] int32, total int32
    [, qe4, qn4, qe, qn]).

    vals holds the concatenated zigzag nonzero prefixes of all blocks in
    raster order; total > cap means overflow (fetch the full plane).

    With ``q4`` (rate-controlled and high-QP fixed-QP configs,
    :func:`qdct_nibble_safe`) the values travel entropy-split in three
    levels (measured bench-config distribution: 57% zeros, 27% +-1, ~13%
    |v| in 2..7, ~3% larger):

    * 2-bit codes, four per byte (``vals`` u8 [cap/4]): 0 -> 0, 1 -> +1,
      2 -> -1, 3 -> escape;
    * escapes as 4-bit nibbles in stream order (``qe4`` u8 [cap4/2]):
      |v| <= 7 inline, larger values the sentinel -8;
    * sentinel values as int16 in stream order (``qe``).

    qn4 > cap4 or qn > capqe means overflow (fetch the full plane)."""
    from . import bitlen

    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    L = bs * bs
    scans = bitlen.zigzag_rows(
        qdct.reshape(nbr, bs, nbc, bs).transpose(0, 2, 1, 3).reshape(nb, L), bs
    )
    nz = scans != 0
    lens = jnp.where(nz.any(axis=1), L - jnp.argmax(nz[:, ::-1], axis=1), 0)
    total = lens.sum()
    k = jnp.arange(L, dtype=lens.dtype)
    # kept (block-major, scan-minor) order IS the prefix-stream order, so
    # one compaction lays the stream out directly (compact_stream)
    keep = (k[None, :] < lens[:, None]).reshape(-1)
    if not q4:
        _, vals = compact_stream(keep, (scans.astype(vdtype).reshape(-1),),
                                 cap)
        return vals, lens.astype(jnp.int32), total.astype(jnp.int32)

    # the compacted prefix VALUES once; codes and both escape levels then
    # derive from cap-sized streams instead of plane-sized ones
    _, s = compact_stream(keep, (scans.astype(jnp.int16).reshape(-1),), cap)
    # level 1: 2-bit codes over the prefix stream (s is zero-filled beyond
    # the stream, so positions past min(total, cap) code to 0 — exactly the
    # scatter layout's zero padding)
    c = jnp.where(s == 0, 0, jnp.where(s == 1, 1, jnp.where(s == -1, 2, 3)))
    c4 = c.reshape(-1, 4)  # reshape + column ops, NOT strided slices
    vals2 = (c4[:, 0] | (c4[:, 1] << 2) | (c4[:, 2] << 4)
             | (c4[:, 3] << 6)).astype(jnp.uint8)
    # level 2: |v| >= 2 values in stream order, counted within the cap
    # window (beyond-cap escapes are already covered by the qt > cap
    # overflow check the host does first)
    qn4 = (c == 3).sum().astype(jnp.int32)
    cap4 = q4e_cap(cap)
    _, s1 = compact_stream(c == 3, (s,), cap4)
    live = jnp.arange(cap4, dtype=jnp.int32) < qn4
    deep = ((s1 > 7) | (s1 < -7)) & live
    nib = jnp.where(deep, -8, s1).astype(jnp.int32) & 15
    n2 = nib.reshape(-1, 2)
    qe4 = (n2[:, 0] | (n2[:, 1] << 4)).astype(jnp.uint8)
    # level 3: sentinel (|v| > 7) true values, compacted from the cap4 list
    qn, qe = compact_stream(deep, (s1,), qe_cap(cap))
    return (vals2, lens.astype(jnp.int32), total.astype(jnp.int32),
            qe4, qn4, qe, qn)


def qe_cap(capq: int) -> int:
    """Deep-escape (|v| > 7) value capacity: 1/16 of the prefix value slots
    (~2x the measured worst case — 1761 escapes on a CIF bench-config
    frame; overflow falls back to the full plane)."""
    return max(capq // 16, 256)


def q4e_cap(capq: int) -> int:
    """First-level escape (|v| >= 2 nibble) capacity: 1/3 of the prefix
    value slots — ~4x the measured bench rate (7% of capq) with headroom
    for low-QP RC rows; overflow falls back to the full plane.  Even (two
    nibbles per byte)."""
    return max(capq // 3 // 2 * 2, 512)


def qdct_nibble_safe(ec) -> bool:
    """Nibble-packed qdct values: configs whose measured escape rate
    (|v| > 7) stays a few percent — fixed QP >= 5 and budget-BOUND
    rate-controlled modes (the 2.4 Mbps deliverable, budget density ~0.8
    bits/coeff, peaks at ~1k escapes/frame vs a 4752-entry cap).  A
    generous RC budget floors QP at the table minimum and the nibble
    escapes storm like fixed low QP (12 Mbps CIF measured 18k first-level
    + 6k deep escapes/frame), so rich budgets stay on whole-byte values,
    like fixed QP < 5."""
    if ec.RCflag > 0:
        return rc_bits_per_coeff(ec) < 1.0
    return ec.quantization_factor >= 5


def pack_vs_base(plane: jnp.ndarray, base: jnp.ndarray, cap: int):
    """u8 plane [H, W] vs an int base plane the host can recompute ->
    (codes2 [H*W/4] u8, esc [cap] u8, n_esc int32).

    Codes per pixel: 0 -> plane == base (mod 256), 1 -> base+1, 2 -> base-1,
    3 -> escape (raw byte in ``esc``, raster order).  n_esc > cap means
    overflow (fetch the full plane)."""
    c = ((plane.astype(jnp.int32) - base.astype(jnp.int32)) & 255).reshape(-1)
    code = jnp.where(c == 0, 0, jnp.where(c == 1, 1, jnp.where(c == 255, 2, 3)))
    cf = code.reshape(-1, 4)
    codes2 = (cf[:, 0] | (cf[:, 1] << 2) | (cf[:, 2] << 4) | (cf[:, 3] << 6)
              ).astype(jnp.uint8)
    esc_mask = code == 3
    n_esc, esc = compact_stream(esc_mask, (plane.reshape(-1),), cap)
    return codes2, esc, n_esc


# Joint recon+art correction states.  round(...) and trunc(...) flip at
# DIFFERENT fractional boundaries (0.5 vs 0.0), so the two planes' nonzero
# codes are nearly disjoint (measured overlap ~0.1%) and one joint state
# stream beats two independent 2-bit streams.  The stream is entropy-split:
# a 1-bit nonzero BITMAP (most pixels match both guesses) plus a compacted
# 3-bit KIND list for the nonzero pixels only — at the measured nonzero
# rates (8-28% typical, up to ~42% at QP 0) this beats a flat 3-bit plane
# by another ~30-40%.  Every (cr, ca) pair still has a state, so the only
# content-dependent failure is kind-list overflow, which falls back to
# full planes like every other cap.
J_NONE, J_RP, J_RM, J_AP, J_AM, J_RESC, J_AESC, J_BESC = range(8)


def jk_cap(h: int, w: int, tight: bool) -> int:
    """Nonzero-kind list capacity (entries).  ``tight`` (the q4 config
    class: fixed QP >= 5) covers the measured <= 29% nonzero rate with
    3/8; rate-controlled / low-QP configs can reach ~42%, so they carry
    1/2.  Multiples of 8 (3-bit group packing)."""
    frac = (3, 8) if tight else (1, 2)
    return max(h * w * frac[0] // frac[1] // 8 * 8, 1024)


def _code_vs(plane, base):
    d = ((plane.astype(jnp.int32) - base.astype(jnp.int32)) & 255).reshape(-1)
    return jnp.where(d == 0, 0, jnp.where(d == 1, 1, jnp.where(d == 255, 2, 3)))


def _compact_bytes(mask, plane_flat, cap):
    n, out = compact_stream(mask, (plane_flat,), cap)
    return out, n


def pack_mv_delta(mv):
    """Delta-bitmap MV transport (``mvd`` layouts: nibble-safe + tail mode).

    ``mv`` is the flat [2*nb] (dx, dy) vector.  Each block's pair packs
    into one byte (two signed nibbles, as the plain ``mvn`` field); most
    consecutive blocks share their MV on real content (global/smooth
    motion; intra rows are all-zero), so the head carries only a
    changed-vs-previous-block bitmap + count and the changed BYTES ride
    the tail pool at used size.  The host rebuilds by forward-filling
    (:meth:`FrameLayout._mv_delta`).  Returns ``(bitmap u8 [ceil(nb/8)],
    mn i32, mvz u8 [nb])`` — the cap is the full field, so overflow is
    impossible."""
    pairs = mv.reshape(-1, 2)
    b = ((pairs[:, 0] & 15) | ((pairs[:, 1] & 15) << 4)).astype(jnp.uint8)
    prev = jnp.concatenate([jnp.zeros(1, jnp.uint8), b[:-1]])
    nz = b != prev
    mvz, mn = _compact_bytes(nz, b, b.shape[0])
    return _bitmap_of(nz), mn, mvz


def _pack3(vals, n_groups):
    """3-bit pack: int [8*n_groups] (values 0..7) -> u8 [3*n_groups]
    (little-endian bit order, 8 values per 3 bytes)."""
    s = vals.reshape(n_groups, 8).astype(jnp.uint32)
    w24 = (s << (3 * jnp.arange(8, dtype=jnp.uint32))[None, :]).sum(axis=1)
    return jnp.stack([w24 & 255, (w24 >> 8) & 255, (w24 >> 16) & 255],
                     axis=-1).astype(jnp.uint8).reshape(-1)


def pack_joint(recon, guess_r, art, guess_a, cap, art_valid=None,
               tight=False, capk=None):
    """-> (jb u8 [H*W/8], jk u8 [3*capk/8], jn i32, re [cap], rn i32,
    ae [cap], an i32).

    ``jb`` is the nonzero bitmap (little-endian bits); ``jk`` the 3-bit
    kind list of the nonzero pixels in raster order; ``jn`` the nonzero
    count (> capk means overflow: fetch BOTH full planes).  Escapes carry
    raw plane bytes in raster order.  ``art_valid`` (scalar bool, optional)
    zeroes the art half per frame — used for intra rows of runtime-mode
    layouts, whose res plane is host-derived."""
    cr = _code_vs(recon, guess_r)
    ca = _code_vs(art, guess_a)
    if art_valid is not None:
        ca = jnp.where(art_valid, ca, 0)
    state = jnp.where(
        (cr == 0) & (ca == 0), J_NONE,
        jnp.where(ca == 0, jnp.where(cr == 1, J_RP,
                                     jnp.where(cr == 2, J_RM, J_RESC)),
                  jnp.where(cr == 0, jnp.where(ca == 1, J_AP,
                                               jnp.where(ca == 2, J_AM,
                                                         J_AESC)),
                            J_BESC)))
    esc_r = (state == J_RESC) | (state == J_BESC)
    esc_a = (state == J_AESC) | (state == J_BESC)
    rn = esc_r.sum().astype(jnp.int32)
    an = esc_a.sum().astype(jnp.int32)
    nz = state != 0
    weights = (1 << jnp.arange(8, dtype=jnp.uint32))[None, :]
    jb = (nz.reshape(-1, 8).astype(jnp.uint32) * weights).sum(
        axis=1).astype(jnp.uint8)
    if capk is None:
        capk = jk_cap(recon.shape[0], recon.shape[1], tight)
    # ONE plane-sized compaction carries the kind and both planes' bytes;
    # the escape lists then compact from the capk-sized stream (escapes
    # are a subset of the nonzero pixels, so nothing is lost while
    # jn <= capk — and a kind-list overflow falls back to full planes)
    jn, st_c, re_c, ae_c = compact_stream(
        nz, (state.astype(jnp.uint8), recon.reshape(-1), art.reshape(-1)),
        capk)
    jk = _pack3(st_c.astype(jnp.int32), capk // 8)
    _, re = compact_stream((st_c == J_RESC) | (st_c == J_BESC), (re_c,), cap)
    _, ae = compact_stream((st_c == J_AESC) | (st_c == J_BESC), (ae_c,), cap)
    return jb, jk, jn, re, rn, ae, an


def _blockify(plane, bs):
    h, w = plane.shape
    return plane.reshape(h // bs, bs, w // bs, bs).swapaxes(1, 2)


def _unblockify(blocks):
    nbr, nbc, bs, _ = blocks.shape
    return blocks.swapaxes(1, 2).reshape(nbr * bs, nbc * bs)


def exact_x_blocks(qdct: jnp.ndarray, row_qps: jnp.ndarray, bs: int) -> jnp.ndarray:
    """Rescale + integer-exact IDCT: int32 [nbr, nbc, bs, bs], scaled by
    ``2^EXACT_SHIFT`` — the shared input of both device-side guesses
    (deterministic int32 arithmetic, bit-identical to the host twin
    :func:`_x_int_blocks_np`)."""
    from . import transform as T

    q = _blockify(qdct.astype(jnp.int32), bs)
    Qi = jnp.asarray(T.quant_matrices(bs)).astype(jnp.int32)[row_qps]
    return T.idct2_exact_core(q * Qi[:, None], jnp.asarray(T.dct_matrix_int(bs)))


def recon_guess_from_x(x: jnp.ndarray, pred: jnp.ndarray, bs: int) -> jnp.ndarray:
    """Integer-exact reconstruction guess, uint8 [H, W] (device side).

    ``guess = clip(rshift_round(x + (pred << S)))`` — the product
    reconstruction ``clip(round(idct_float + pred))`` differs from it by
    {0, +-1} except at rare float-vs-fixed-point disagreements (escapes)."""
    from . import transform as T

    s = T.EXACT_SHIFT
    p = _blockify(pred.astype(jnp.int32), bs)
    g = (x + (p << s) + (1 << (s - 1))) >> s
    return _unblockify(jnp.clip(g, 0, 255).astype(jnp.uint8))


def art_guess_from_x(x: jnp.ndarray) -> jnp.ndarray:
    """Integer-exact res_w_mc guess, uint8 [H, W]: ``trunc(x / 2^S) mod
    256`` — the reference stores the residual as ``astype(int8)`` of the
    float IDCT (truncation toward zero), which the truncated fixed-point
    residual reproduces except at float-edge pixels."""
    from . import transform as T

    s = T.EXACT_SHIFT
    t = jnp.where(x >= 0, x >> s, -((-x) >> s))
    return _unblockify((t & 255).astype(jnp.uint8))


def recon_guess_plane(qdct: jnp.ndarray, row_qps: jnp.ndarray,
                      pred: jnp.ndarray, bs: int) -> jnp.ndarray:
    """:func:`recon_guess_from_x` of :func:`exact_x_blocks` (convenience)."""
    return recon_guess_from_x(exact_x_blocks(qdct, row_qps, bs), pred, bs)


def intra_pred_plane(recon: jnp.ndarray, modes: jnp.ndarray, bs: int) -> jnp.ndarray:
    """Intra prediction plane from the FINAL reconstruction + mode grid
    (device twin of the pred step in :func:`host_intra_art`): valid because
    each block's predictor reads only already-final neighbor pixels.
    Preserves the transposed-predictor quirk (ops/intra.py): within a block,
    H-mode pixel (a, b) reads the left neighbor column at row offset b and
    V-mode pixel (a, b) reads the top neighbor row at column offset a.
    Pure slice/broadcast, no gathers."""
    blocks = _blockify(recon.astype(jnp.int32), bs)     # [nbr, nbc, bs, bs]
    nbr, nbc = blocks.shape[:2]
    border = jnp.full((1,), 128, jnp.int32)
    left = jnp.concatenate(
        [jnp.broadcast_to(border, (nbr, 1, bs)), blocks[:, :-1, :, -1]], axis=1)
    top = jnp.concatenate(
        [jnp.broadcast_to(border, (1, nbc, bs)), blocks[:-1, :, -1, :]], axis=0)
    pred_h = jnp.broadcast_to(left[:, :, None, :], blocks.shape)   # f(b)
    pred_v = jnp.broadcast_to(top[:, :, :, None], blocks.shape)    # f(a)
    sel = (modes.astype(jnp.int32) == 0)[:, :, None, None]
    return _unblockify(jnp.where(sel, pred_h, pred_v))


def tail_pool_cap(layout) -> int:
    """Static pool capacity per frame (bytes): the sum of the tail fields'
    caps — the pool can never overflow beyond the per-field caps."""
    if layout.devbits:
        cap = layout.capdb + layout.capp  # packed dct + pred bitstreams
    else:
        cap = layout.capq // 4 if layout.q4 else layout.capq * layout.vbytes
        if layout.q4:
            cap += layout.capq4 // 2 + 2 * layout.capqe
    cap += layout.cape  # re
    if layout.with_art:
        cap += (3 * layout.capk // 8 + layout.h * layout.w // 8
                + layout.j1C + layout.cape)  # jk + jbz + j1z + ae
    if layout.mvd:
        cap += layout.nb  # changed-MV bytes (cap = the full field)
    return cap


def _bitmap_of(bits):
    """bool [n] -> little-endian presence bitmap u8 [ceil(n/8)]."""
    n = bits.shape[0]
    n8 = (n + 7) // 8
    if n8 * 8 != n:
        bits = jnp.concatenate([bits, jnp.zeros(n8 * 8 - n, bool)])
    weights = (1 << jnp.arange(8, dtype=jnp.uint32))[None, :]
    return (bits.reshape(-1, 8).astype(jnp.uint32) * weights).sum(
        axis=1).astype(jnp.uint8)


def split_bitmap(jb):
    """Two-level split of the correction bitmap (device side).

    Corrections cluster in textured/moving regions, so most of a typical
    frame's bitmap BYTES are zero — and most of the first-level presence
    bytes too (measured: jbn ~0.5-3% of bitmap bytes on bench content, so
    ~70%+ of j1's bytes are zero as well).  Each level keeps a presence bit
    per byte and compacts the nonzero bytes into the tail pool: the head
    carries only ``j2`` (bytes/64) plus two counts.  Returns
    ``(j2, j1z, j1n, jbz, jbn)``."""
    c = jb.shape[0]
    nz = jb != 0
    jbn, jbz = compact_stream(nz, (jb,), c)
    j1 = _bitmap_of(nz)
    nz1 = j1 != 0
    j1n, j1z = compact_stream(nz1, (j1,), j1.shape[0])
    j2 = _bitmap_of(nz1)
    return j2, j1z, j1n, jbz, jbn


def pack_tail_pool(layout, jks, qvs, qes, jns, qts, qns, jbzs=None,
                   jbns=None, j1zs=None, j1ns=None, res=None, rns=None,
                   aes=None, ans=None, qe4s=None, qn4s=None, mvzs=None,
                   mns=None, dbs=None, dbitss=None, pbs=None, pbitss=None):
    """Chunk-level compaction of the variable-size transfer fields.

    The cap-padded fields (``j1z``/``jbz`` bitmap bytes, ``jk`` kind lists,
    ``re``/``ae`` escape lists, ``qv`` 2-bit prefix codes, ``qe4``/``qe``
    escape levels) average a small fraction of their caps on typical
    content, so the fixed-size row wastes most of the d2h bytes of a
    transfer-bound pipeline.  This packs each frame's USED bytes — in
    field order [j1z, jbz, jk, re, ae, qv, qe4, qe, mvz] — contiguously into
    one chunk-wide pool; the host re-derives every offset from the head
    counts (:meth:`FrameLayout.tail_sizes`) and fetches only
    ``pool[:bucket(total)]``.

    ``jks``/``qes``/``j1zs``/``res``/``aes``/``qe4s`` may be None for
    layouts without those fields; arrays are [K, cap_bytes] uint8 (already
    bitcast).  Returns ``pool [K*cap] u8``."""
    k = (dbitss if qts is None else qts).shape[0]
    zeros = jnp.zeros(k, jnp.int32)
    u_j1 = jnp.minimum(j1ns, layout.j1C) if j1zs is not None else zeros
    u_jb = jnp.minimum(jbns, layout.jbC) if jbzs is not None else zeros
    u_jk = layout.jk_used(jns) if layout.with_art else zeros
    u_re = jnp.minimum(rns, layout.cape) if res is not None else zeros
    u_ae = jnp.minimum(ans, layout.cape) if aes is not None else zeros
    u_mv = layout.mv_used(mns) if mvzs is not None else zeros
    cap = k * tail_pool_cap(layout)
    if layout.devbits:
        u_db = layout.db_used(dbitss)
        u_pb = layout.pb_used(pbitss)
        sizes = u_j1 + u_jb + u_jk + u_re + u_ae + u_db + u_pb + u_mv
        fields = [(f, u) for f, u in (
            (j1zs, u_j1), (jbzs, u_jb), (jks, u_jk), (res, u_re),
            (aes, u_ae), (dbs, u_db), (pbs, u_pb), (mvzs, u_mv),
        ) if f is not None]
    else:
        u_qv = layout.qv_used(qts)
        u_qe4 = layout.qe4_used(qn4s) if qe4s is not None else zeros
        u_qe = layout.qe_used(qns) if layout.q4 else zeros
        sizes = u_j1 + u_jb + u_jk + u_re + u_ae + u_qv + u_qe4 + u_qe + u_mv
        fields = [(f, u) for f, u in (
            (j1zs, u_j1), (jbzs, u_jb), (jks, u_jk), (res, u_re),
            (aes, u_ae),
            (_as_bytes2d(qvs), u_qv),
            (qe4s, u_qe4),
            (_as_bytes2d(qes) if qes is not None else None, u_qe),
            (mvzs, u_mv),
        ) if f is not None]

    if _use_sort_compaction():
        # the pool IS one big compaction: concatenating the cap-padded
        # fields per frame in field order and dropping the unused bytes
        # yields exactly the [frame][field][used] layout — one chunk-wide
        # stable sort instead of nine scatters
        srcs, keeps = [], []
        for f, u in fields:
            ar = jnp.arange(f.shape[1], dtype=jnp.int32)
            srcs.append(f)
            keeps.append(ar[None, :] < u[:, None])
        src = jnp.concatenate(srcs, axis=1).reshape(-1)
        keep = jnp.concatenate(keeps, axis=1).reshape(-1)
        if src.shape[0] < cap:  # layout variants whose field set is narrower
            pad = cap - src.shape[0]
            src = jnp.concatenate([src, jnp.zeros(pad, jnp.uint8)])
            keep = jnp.concatenate([keep, jnp.zeros(pad, bool)])
        _, pool = compact_stream(keep, (src,), cap)
        return pool

    offs = jnp.cumsum(sizes) - sizes
    pool = jnp.zeros(cap + 1, jnp.uint8)

    def scatter(pool, field, base, used):
        ar = jnp.arange(field.shape[1], dtype=jnp.int32)
        idx = offs[:, None] + base[:, None] + ar[None, :]
        keep = ar[None, :] < used[:, None]
        idx = jnp.where(keep & (idx < cap), idx, cap)
        return pool.at[idx.reshape(-1)].set(field.reshape(-1))

    base = zeros
    for field, used in fields:
        pool = scatter(pool, field, base, used)
        base = base + used
    return pool[:cap]


def _as_bytes2d(a):
    """[K, C] any dtype -> [K, C*itemsize] uint8 (little-endian, matching
    the host's np ``view``)."""
    if a.dtype == jnp.uint8:
        return a
    b = jax.lax.bitcast_convert_type(a, jnp.uint8)
    return b.reshape(a.shape[0], -1)


def pack_row(codes, re, rn, meta, mv, modes, qv, ql, qt, ae=None,
             an=None, *, bs, mv8=False, mvn=False, qe4=None, qn4=None,
             qe=None, qn=None, tail=False, dev=None):
    """One frame's transfer row in :class:`FrameLayout` field order (device).

    ``codes`` is the joint state tuple ``(jb, jk, jn)`` (:func:`pack_joint`,
    ``with_art`` layouts, with ``ae``/``an``; in ``tail`` mode the
    two-level ``(j2, j1n, jbn, jn)`` from :func:`split_bitmap`) or the
    2-bit recon code plane (:func:`pack_vs_base`, art-less layouts);
    ``re``/``rn`` its recon escapes / count; ``mv`` int [3*nb] or None
    (layout without MVs), narrowed to int8 under ``mv8``; ``modes``
    uint8/int [nb] of {0, 1}, bit-packed here (little-endian bit order,
    the host re-expands with ``np.unpackbits``); ``ql`` is narrowed to u8
    when a block's scan fits one byte (bs*bs <= 255).  In ``tail`` mode
    the cap-padded arrays (re, ae, qv, qe) leave the row for the chunk
    pool; only their counts stay.  ``dev``: devbits layouts — the
    ``(dn, dbits, pbits)`` int32 head fields replace the qv/ql/qt group
    (the packed bitstreams themselves ride the tail pool)."""
    nb = modes.shape[0]
    nbm = (nb + 7) // 8
    m = modes.astype(jnp.uint8)
    if nbm * 8 != nb:
        m = jnp.concatenate([m, jnp.zeros(nbm * 8 - nb, jnp.uint8)])
    weights = (1 << jnp.arange(8, dtype=jnp.uint8))[None, :]
    mbits = (m.reshape(nbm, 8) * weights).sum(axis=1).astype(jnp.uint8)
    if nbm & 1:
        mbits = jnp.concatenate([mbits, jnp.zeros(1, jnp.uint8)])
    cparts = codes if isinstance(codes, tuple) else (codes,)
    parts = [*cparts] + ([] if tail else [re]) + [rn, meta]
    if mv is not None:
        if mvn and tail:
            # mvd layout: ``mv`` is pack_mv_delta's (bitmap, mn); the
            # changed bytes travel in the tail pool.  A raw flat MV array
            # under this flag combo would be silently indexed as a tuple
            # and emit a malformed head row — reject it at trace time.
            assert isinstance(mv, tuple), (
                "mvd layout (mvn and tail) requires pack_mv_delta's "
                "(bitmap, mn) tuple, not a raw MV array")
            parts += [mv[0], mv[1]]
        elif mvn:
            pairs = mv.reshape(-1, 2)
            parts.append(((pairs[:, 0] & 15) | ((pairs[:, 1] & 15) << 4))
                         .astype(jnp.uint8))
        else:
            parts.append(mv.astype(jnp.int8 if mv8 else jnp.int16))
    parts.append(mbits)
    if dev is not None:
        parts += [jnp.asarray(v, jnp.int32).reshape(1) for v in dev]
    else:
        parts += ([] if tail else [qv]) + [
            ql.astype(jnp.uint8 if bs * bs <= 255 else jnp.int16), qt]
        if qe4 is not None:
            parts += ([] if tail else [qe4]) + [qn4]
        if qe is not None:
            parts += ([] if tail else [qe]) + [qn]
    if ae is not None:
        parts += ([] if tail else [ae]) + [an]
    return concat_bytes(*parts)


def concat_bytes(*arrays):
    """Bitcast-and-concatenate per-frame outputs into ONE uint8 vector.

    Every device->host transfer pays its own latency, so a chunk's outputs
    travel as a single buffer; the host re-views the bytes with
    :class:`FrameLayout` (no copies)."""
    parts = []
    for a in arrays:
        if a.dtype != jnp.uint8:
            a = jax.lax.bitcast_convert_type(a, jnp.uint8)
        parts.append(a.reshape(-1))
    return jnp.concatenate(parts)


class FrameLayout:
    """Byte offsets of one frame's packed transfer buffer (host side).

    Field order matches :func:`concat_bytes` callers in models/chunk.py and
    models/two_pass.py:

    * ``rc`` u8 [H*W/4], ``re`` u8 [cape], ``rn`` i32 — reconstruction
      correction codes vs :func:`recon_guess_from_x` (the full plane never
      travels except on escape-count overflow)
    * ``meta``   i32 [3 + 2*nbr] — (mode, metric_sum, comparison_sum,
      row_qps, row_bits); MV/comparison vectors travel reduced, not raw
    * ``mv``     i8 or i16 [3*nb] (``with_mv`` layouts; zeros on intra rows;
      int8 when the search geometry bounds every component to +-127 —
      ``mv8``)
    * ``modes``  bit-packed [ceil(nb/8) rounded up to even]  (zeros on
      inter rows; ``split`` returns them re-expanded to u8 [nb])
    * ``qv``     [capq] int8/int16, ``ql`` u8 (bs*bs <= 255) or i16 [nb],
      ``qt`` i32
    * ``ac`` u8 [H*W/4], ``ae`` u8 [cape], ``an`` i32  (``with_art``
      layouts) — codes vs :func:`art_guess_from_x`
    """

    def __init__(self, h, w, bs, vbytes, with_mv, with_art, mv8=False,
                 q4=False, jt=None, tail=False, mvk=3, mvn=False,
                 qfrac=None, devbits=False):
        nbr = h // bs
        nb = nbr * (w // bs)
        self.h, self.w, self.nb, self.nbr = h, w, nb, nbr
        self.vbytes = vbytes
        self.with_mv = with_mv
        self.with_art = with_art
        self.mv8 = mv8
        self.q4 = q4
        self.tail = tail
        # MV components per block: single-reference configs drop the
        # always-zero reference index (2), multi-reference keep it (3);
        # ``mvn`` (mv_nibble_safe) packs (dx, dy) into one byte
        self.mvk = mvk
        self.mvn = mvn
        self.qlbytes = 1 if bs * bs <= 255 else 2
        self.bs = bs
        self.qfrac = qfrac
        # NOTE: whole-plane (overflow-proof) tail caps were tried and
        # reverted — transfer-neutral (the pool ships USED bytes) but the 2.7x
        # larger device-side compaction scatters measured slightly slower
        # steady-state with no benefit on in-distribution content.
        # Pathological content (film grain at fixed mid QPs) can still
        # overflow the fraction caps and takes the synchronous full-plane
        # fallback (correct, slow); qcap_fraction sizes the classes so
        # that never happens on realistic configs.
        self.capq = qdct_caps(nb, bs, qfrac)
        self.cape = esc_cap(h, w)
        self.capqe = qe_cap(self.capq)
        self.capq4 = q4e_cap(self.capq)
        # devbits: the frame's FINAL pred/dct bitstreams are packed on
        # device (ops/bitpack.py) and travel in the tail pool at used size;
        # the q-prefix fields (qv/ql/qt/qe*) leave the layout entirely and
        # the head carries (dn, dbits, pbits) instead.  Requires tail mode
        # (the streams are variable-size by construction).
        self.devbits = bool(devbits)
        if devbits:
            from .bitpack import dct_sym_cap, dct_word_cap, pred_word_cap

            assert tail, "devbits layouts require tail mode"
            self.capsym = dct_sym_cap(self.capq, nb, bs * bs)
            self.capdb = 4 * dct_word_cap(self.capsym, bs)
            self.npred = (nbr * (1 + (w // bs) * mvk) if with_mv
                          else nbr * (1 + w // bs))
            self.capp = 4 * pred_word_cap(self.npred)
        nbm = (nb + 7) // 8
        nbm2 = nbm + (nbm & 1)
        self.nbm = nbm
        # kind-list sizing decouples from the nibble flag: RC runs can be
        # nibble-eligible but still reach ~40% nonzero code rates
        self.capk = jk_cap(h, w, q4 if jt is None else jt)
        # with_art layouts carry the joint recon+art state stream as a
        # nonzero bitmap + compacted 3-bit kind list (pack_joint); art-less
        # layouts a 2-bit recon code plane.  In ``tail`` mode every
        # cap-padded field (j1z/jbz bitmap bytes, jk, re, ae, qv, qe)
        # leaves the fixed row and travels in the chunk's compacted pool
        # (:func:`pack_tail_pool`) at its USED size; the counts (j1n, jbn,
        # jn, rn, an, qt, qn) stay in the head so the host can re-derive
        # every pool offset.
        self.jbC = h * w // 8  # flat correction-bitmap bytes
        self.j1C = (self.jbC + 7) // 8  # first-level presence bytes
        if with_art and tail:
            sizes = [("j2", (self.j1C + 7) // 8), ("j1n", 4), ("jbn", 4),
                     ("jn", 4)]
        elif with_art:
            sizes = [("jb", self.jbC), ("jk", 3 * self.capk // 8),
                     ("jn", 4)]
        else:
            sizes = [("rc", h * w // 4)]
        sizes += (([] if tail else [("re", self.cape)]) + [("rn", 4)]
                  + [("meta", (3 + 2 * nbr) * 4)])
        # mvd: nibble-safe MV fields in tail mode travel as a
        # changed-vs-previous-block bitmap (head) + compacted changed bytes
        # (tail pool) — see :func:`pack_mv_delta`
        self.mvd = bool(with_mv and mvn and tail)
        if self.mvd:
            sizes += [("mvb", nbm), ("mn", 4)]
        elif with_mv:
            sizes.append(("mv", nb if mvn
                          else mvk * nb * (1 if mv8 else 2)))
        sizes.append(("modes", nbm2))
        if devbits:
            sizes += [("dn", 4), ("dbits", 4), ("pbits", 4)]
        else:
            sizes += (([] if tail else
                       [("qv", self.capq // 4 if q4 else self.capq * vbytes)])
                      + [("ql", nb * self.qlbytes), ("qt", 4)])
            if q4:
                sizes += (([] if tail else [("qe4", self.capq4 // 2)])
                          + [("qn4", 4)]
                          + ([] if tail else [("qe", self.capqe * 2)])
                          + [("qn", 4)])
        if with_art:
            sizes += ([] if tail else [("ae", self.cape)]) + [("an", 4)]
        self.offsets = {}
        pos = 0
        for name, n in sizes:
            self.offsets[name] = (pos, pos + n)
            pos += n
        self.total = pos

    # -- tail-mode size formulas (host ints; device twins below) ----------
    def tail_sizes(self, j1n: int, jbn: int, jn: int, qt: int, qn4: int,
                   qn: int, rn: int, an: int, mn: int = 0, dbits: int = 0,
                   pbits: int = 0) -> tuple:
        """(j1_bytes, jb_bytes, jk_bytes, re_bytes, ae_bytes, qv_bytes,
        qe4_bytes, qe_bytes, db_bytes, pb_bytes, mv_bytes) of one frame's
        pool segment — the POOL BYTE ORDER (mv last) — from the head
        counts, bit-identical to the device formulas used by
        :func:`pack_tail_pool` (overflowing counts clamp at the caps; the
        pipeline falls back to full planes for those frames, but the pool
        walk must still agree on every offset).  devbits layouts carry the
        packed bitstreams instead of the qv/qe4/qe prefix fields."""
        u_j1 = min(j1n, self.j1C) if self.with_art else 0
        u_jb = min(jbn, self.jbC) if self.with_art else 0
        u_jk = (min(jn, self.capk) + 7) // 8 * 3 if self.with_art else 0
        u_re = min(rn, self.cape)
        u_ae = min(an, self.cape) if self.with_art else 0
        if self.devbits:
            u_qv = u_qe4 = u_qe = 0
            u_db = min((dbits + 7) // 8, self.capdb)
            u_pb = (pbits + 7) // 8
        else:
            u_qv = ((min(qt, self.capq) + 3) // 4 if self.q4
                    else min(qt, self.capq) * self.vbytes)
            u_qe4 = (min(qn4, self.capq4) + 1) // 2 if self.q4 else 0
            u_qe = 2 * min(qn, self.capqe) if self.q4 else 0
            u_db = u_pb = 0
        u_mv = min(mn, self.nb) if self.mvd else 0
        return (u_j1, u_jb, u_jk, u_re, u_ae, u_qv, u_qe4, u_qe,
                u_db, u_pb, u_mv)

    def jk_used(self, jn):
        return (jnp.minimum(jn, self.capk) + 7) // 8 * 3

    def qv_used(self, qt):
        qt = jnp.minimum(qt, self.capq)
        return (qt + 3) // 4 if self.q4 else qt * self.vbytes

    def qe4_used(self, qn4):
        return (jnp.minimum(qn4, self.capq4) + 1) // 2

    def qe_used(self, qn):
        return 2 * jnp.minimum(qn, self.capqe)

    def mv_used(self, mns):
        return jnp.minimum(mns, self.nb)

    def db_used(self, dbits):
        return jnp.minimum((dbits + 7) // 8, self.capdb)

    def pb_used(self, pbits):
        return (pbits + 7) // 8  # worst-case-exact cap: cannot overflow

    def head_counts(self, buf) -> tuple:
        """(j1n, jbn, jn, qt, qn4, qn, rn, an, mn, dbits, pbits) from a
        head row (ints)."""
        wa = self.with_art and self.tail
        j1n = int(self._f(buf, "j1n", np.int32)[0]) if wa else 0
        jbn = int(self._f(buf, "jbn", np.int32)[0]) if wa else 0
        jn = int(self._f(buf, "jn", np.int32)[0]) if self.with_art else 0
        if self.devbits:
            qt = qn4 = qn = 0
            dbits = int(self._f(buf, "dbits", np.int32)[0])
            pbits = int(self._f(buf, "pbits", np.int32)[0])
        else:
            qt = int(self._f(buf, "qt", np.int32)[0])
            qn4 = int(self._f(buf, "qn4", np.int32)[0]) if self.q4 else 0
            qn = int(self._f(buf, "qn", np.int32)[0]) if self.q4 else 0
            dbits = pbits = 0
        rn = int(self._f(buf, "rn", np.int32)[0])
        an = int(self._f(buf, "an", np.int32)[0]) if self.with_art else 0
        mn = int(self._f(buf, "mn", np.int32)[0]) if self.mvd else 0
        return j1n, jbn, jn, qt, qn4, qn, rn, an, mn, dbits, pbits

    def _f(self, buf, name, dtype):
        s, e = self.offsets[name]
        return buf[s:e].view(dtype)

    def _mv(self, buf):
        """MV field as a flat [(x, y, ref) * nb] int array — re-inserts the
        zero reference column for 2-component (single-reference) layouts
        and expands the nibble-pair packing (``mvn``)."""
        if self.mvn:
            return self._mv_nibbles(self._f(buf, "mv", np.uint8))
        m = self._f(buf, "mv", np.int8 if self.mv8 else np.int16)
        if self.mvk == 3:
            return m
        m2 = m.reshape(-1, 2)
        out = np.zeros((m2.shape[0], 3), m.dtype)
        out[:, :2] = m2
        return out.reshape(-1)

    def _mv_nibbles(self, b):
        """Nibble-pair bytes [nb] -> flat [(x, y, 0) * nb] int16."""
        b = b.astype(np.int16)
        out = np.zeros((b.shape[0], 3), np.int16)
        out[:, 0] = (b & 15) - ((b & 8) << 1)              # sign-extend dx
        hi = b >> 4
        out[:, 1] = hi - ((hi & 8) << 1)                   # sign-extend dy
        return out.reshape(-1)

    def _mv_delta(self, buf, seg):
        """mvd inverse: head bitmap + pooled changed bytes -> MV field
        (forward-fill of the last changed byte; zero before the first)."""
        mask = np.unpackbits(self._f(buf, "mvb", np.uint8),
                             bitorder="little")[: self.nb].astype(bool)
        mn = min(int(self._f(buf, "mn", np.int32)[0]), self.nb)
        b = np.zeros(self.nb, np.uint8)
        b[np.flatnonzero(mask)[:mn]] = seg[:mn]
        last = np.maximum.accumulate(
            np.where(mask, np.arange(self.nb), -1))
        b = np.where(last >= 0, b[np.maximum(last, 0)], 0).astype(np.uint8)
        return self._mv_nibbles(b)

    def _qv(self, qv_bytes, qe4_bytes, qe_bytes):
        """qv bytes as int16 values (expands the ``q4`` 2-bit code stream
        and re-places its two escape levels; zero-copy view otherwise).

        On escape overflow (qn4 > capq4 or qn > capqe) the expansion is
        garbage but must not crash: the caller fetches the full plane
        instead (count checks in the pipeline's submit path)."""
        if not self.q4:
            return qv_bytes.view(np.int8 if self.vbytes == 1 else np.int16)
        c = ((qv_bytes[:, None] >> np.array([0, 2, 4, 6], np.uint8))
             & 3).reshape(-1)
        out = np.take(np.array([0, 1, -1, 0], np.int16), c)
        pos = np.flatnonzero(c == 3)  # escape positions, stream order
        nib = np.empty(2 * qe4_bytes.size, np.int16)
        nib[0::2] = qe4_bytes & 15
        nib[1::2] = qe4_bytes >> 4
        nib -= (nib >= 8) * 16  # sign-extend; sentinel -8 = deep escape
        n = min(pos.size, nib.size)
        out[pos[:n]] = nib[:n]
        sent = pos[:n][nib[:n] == -8]
        qe = qe_bytes.view(np.int16)
        m = min(sent.size, qe.size)
        out[sent[:m]] = qe[:m]
        return out

    def split(self, buf: np.ndarray, tail: np.ndarray | None = None) -> dict:
        """uint8 [total] (+ the frame's pool segment in ``tail`` mode) ->
        field views (zero-copy except modes)."""
        mv_seg = None
        db_b = pb_b = None
        if self.tail:
            (u_j1, u_jb, u_jk, u_re, u_ae, u_qv, u_qe4, u_qe, u_db, u_pb,
             u_mv) = self.tail_sizes(*self.head_counts(buf))
            p = u_j1 + u_jb
            jk = tail[p : p + u_jk]
            p += u_jk
            re = tail[p : p + u_re]
            ae = tail[p + u_re : p + u_re + u_ae]
            p += u_re + u_ae
            if self.devbits:
                db_b = tail[p : p + u_db]
                pb_b = tail[p + u_db : p + u_db + u_pb]
                p += u_db + u_pb
                qv_b = qe4_b = qe_b = None
            else:
                qv_b = tail[p : p + u_qv]
                p += u_qv
                qe4_b = tail[p : p + u_qe4]
                qe_b = tail[p + u_qe4 : p + u_qe4 + u_qe]
                p += u_qe4 + u_qe
            if self.mvd:
                mv_seg = tail[p : p + u_mv]
            jb = None
            if self.with_art:
                # re-inflate the two-level bitmap from the presence bits +
                # the compacted nonzero bytes (split_bitmap's inverse)
                j1 = np.zeros(self.j1C, np.uint8)
                pos1 = np.flatnonzero(np.unpackbits(
                    self._f(buf, "j2", np.uint8),
                    bitorder="little")[: self.j1C])
                j1[pos1[:u_j1]] = tail[:u_j1]
                jb = np.zeros(self.jbC, np.uint8)
                pos = np.flatnonzero(np.unpackbits(
                    j1, bitorder="little")[: self.jbC])
                jb[pos[:u_jb]] = tail[u_j1 : u_j1 + u_jb]
        else:
            jb = self._f(buf, "jb", np.uint8) if self.with_art else None
            jk = self._f(buf, "jk", np.uint8) if self.with_art else None
            re = self._f(buf, "re", np.uint8)
            ae = self._f(buf, "ae", np.uint8) if self.with_art else None
            s, e = self.offsets["qv"]
            qv_b = buf[s:e]
            qe4_b = self._f(buf, "qe4", np.uint8) if self.q4 else None
            qe_b = self._f(buf, "qe", np.uint8) if self.q4 else None
        out = {
            "h": self.h, "w": self.w, "lay": self,
            "rc": None if self.with_art else self._f(buf, "rc", np.uint8),
            # joint states and qdct values are derived lazily (the fused
            # native rebuild consumes the raw streams directly; the staged
            # fallback goes through joint_states_of / qv_of below)
            "jb": jb if self.with_art else None,
            "jk": jk if self.with_art else None,
            "jst": None,
            "jn": (int(self._f(buf, "jn", np.int32)[0]) if self.with_art
                   else 0),
            "re": re,
            "rn": int(self._f(buf, "rn", np.int32)[0]),
            "meta": self._f(buf, "meta", np.int32),
            "mv": (self._mv_delta(buf, mv_seg) if self.mvd
                   else self._mv(buf) if self.with_mv else None),
            "modes": np.unpackbits(
                self._f(buf, "modes", np.uint8)[: self.nbm],
                bitorder="little")[: self.nb],
            "qv_raw": qv_b,
            "qe4_raw": qe4_b if self.q4 and not self.devbits else None,
            "qe_raw": qe_b, "qv": None,
        }
        if self.devbits:
            out.update(
                ql=None, qt=0, qn4=0, qn=0,
                db=db_b, pb=pb_b,
                dn=int(self._f(buf, "dn", np.int32)[0]),
                dbits=int(self._f(buf, "dbits", np.int32)[0]),
                pbits=int(self._f(buf, "pbits", np.int32)[0]),
            )
        else:
            out.update(
                ql=self._f(buf, "ql",
                           np.uint8 if self.qlbytes == 1 else np.int16),
                qt=int(self._f(buf, "qt", np.int32)[0]),
                qn4=int(self._f(buf, "qn4", np.int32)[0]) if self.q4 else 0,
                qn=int(self._f(buf, "qn", np.int32)[0]) if self.q4 else 0,
            )
        if self.with_art:
            out["ae"] = ae
            out["an"] = int(self._f(buf, "an", np.int32)[0])
        else:
            out["ae"] = None
            out["an"] = 0
        return out


# ---------------------------------------------------------------------------
# Host side (NumPy, runs on the finalize worker pool)
# ---------------------------------------------------------------------------

def unpack_qdct(vals: np.ndarray, lens: np.ndarray, h: int, w: int, bs: int,
                zz: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_qdct` -> int16 plane [H, W] (native fast path
    with a vectorized-NumPy fallback, like the entropy codec)."""
    from ..entropy import native

    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    L = bs * bs
    lib = native._load()
    if lib is not None:
        out = np.zeros((h, w), np.int16)
        v = np.ascontiguousarray(vals, np.int16)
        ln = np.ascontiguousarray(lens, np.int32)
        zz64 = np.ascontiguousarray(zz, np.int64)
        lib.bvc_unpack_qdct(v.ctypes.data, ln.ctypes.data, nbr, nbc, bs,
                            zz64.ctypes.data, out.ctypes.data, w)
        return out
    lens = lens.astype(np.int64)  # lens may travel as i16; offsets overflow it
    offs = np.cumsum(lens) - lens
    k = np.arange(L)
    mask = k[None, :] < lens[:, None]
    scans = np.zeros((nb, L), np.int32)
    scans[mask] = vals[(offs[:, None] + k[None, :])[mask]]
    blocks = np.zeros((nb, L), np.int16)
    blocks[:, zz] = scans
    return (
        blocks.reshape(nbr, nbc, bs, bs).swapaxes(1, 2).reshape(h, w)
    )


def _unpack_codes(codes2: np.ndarray) -> np.ndarray:
    """2-bit code plane -> flat int array of {0, 1, 2, 3}."""
    return ((codes2[:, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3).reshape(-1)


def unpack_vs_base(codes2: np.ndarray, esc: np.ndarray,
                   base: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_vs_base` -> u8 [H, W] given the recomputed
    base plane (int, compared mod 256)."""
    h, w = base.shape
    code = _unpack_codes(codes2)
    delta = np.take(np.array([0, 1, -1, 0], np.int32), code)
    out = ((base.reshape(-1).astype(np.int32) + delta) & 255).astype(np.uint8)
    pos = np.flatnonzero(code == 3)
    out[pos] = esc[: pos.size]
    return out.reshape(h, w)


def host_joint_states(jc: np.ndarray) -> np.ndarray:
    """Inverse of the 3-bit packing in :func:`pack_joint` -> u8 [H*W]."""
    from ..entropy import native

    n_px = jc.size // 3 * 8
    lib = native._load()
    if lib is not None:
        jcc = np.ascontiguousarray(jc, np.uint8)
        out = np.empty(n_px, np.uint8)
        lib.bvc_joint_states(jcc.ctypes.data, n_px, out.ctypes.data)
        return out
    b = jc.reshape(-1, 3).astype(np.uint32)
    w24 = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return ((w24[:, None] >> (3 * np.arange(8))) & 7).astype(np.uint8).reshape(-1)


def host_joint_decode(jb: np.ndarray, jk: np.ndarray,
                      n_px: int) -> np.ndarray:
    """Inverse of pack_joint's bitmap + kind-list split -> u8 states [n_px].
    Kind-list overflow (jn > capk) decodes garbage-but-safe states; the
    pipeline fetches both full planes in that case."""
    from ..entropy import native

    lib = native._load()
    if lib is not None:
        jbc = np.ascontiguousarray(jb, np.uint8)
        jkc = np.ascontiguousarray(jk, np.uint8)
        out = np.empty(n_px, np.uint8)
        lib.bvc_joint_decode2(jbc.ctypes.data, jkc.ctypes.data, n_px,
                              jk.size // 3 * 8, out.ctypes.data)
        return out
    bits = np.unpackbits(jb, bitorder="little")[:n_px]
    kinds = host_joint_states(jk)
    out = np.zeros(n_px, np.uint8)
    pos = np.flatnonzero(bits)
    n = min(pos.size, kinds.size)
    out[pos[:n]] = kinds[:n]
    return out


def joint_states_of(f: dict) -> np.ndarray | None:
    """Memoized joint-state plane of a split-frame dict (None for layouts
    without art codes).  The fused native rebuild decodes the raw
    bitmap+kind streams itself; only the staged fallback and the intra
    path materialize the per-pixel states here."""
    jst = f.get("jst")
    if jst is None and f.get("jb") is not None:
        jst = host_joint_decode(f["jb"], f["jk"], f["h"] * f["w"])
        f["jst"] = jst
    return jst


def devbits_ok(f: dict) -> bool:
    """True when a devbits frame's device-packed dct stream is valid (the
    symbol compaction and the word buffer both stayed within cap) — the
    pipeline otherwise falls back to the full qdct plane and re-encodes on
    host, exactly like a q-cap overflow."""
    lay = f["lay"]
    return (lay.devbits and f["dn"] <= lay.capsym
            and f["dbits"] <= 8 * lay.capdb - 32)


def decode_qdct_devbits(f: dict, bs: int) -> np.ndarray:
    """Host qdct plane of a devbits frame: ONE native pass decoding the
    device-packed bitstream (exp-Golomb + RLE + inverse zigzag)."""
    from ..entropy import native
    from ..entropy.rle import EOB_MARKER
    from ..entropy.zigzag import zigzag_indices

    return native.decode_dct_plane(f["db"], f["dbits"], f["h"], f["w"], bs,
                                   zigzag_indices(bs), EOB_MARKER)


def qv_of(f: dict) -> np.ndarray:
    """Memoized qdct value stream of a split-frame dict (nibble expansion /
    dtype view deferred out of the main-thread split)."""
    v = f.get("qv")
    if v is None:
        v = f["lay"]._qv(f["qv_raw"], f["qe4_raw"], f["qe_raw"])
        f["qv"] = v
    return v


def host_rebuild_p(f: dict, row_qps: np.ndarray, bs: int, planes: np.ndarray,
                   mvs: np.ndarray, frac: bool):
    """Fused native P-frame rebuild (bvc_rebuild_p): qdct expansion +
    zigzag scatter + integer IDCT/art guess + joint-state decode + MC
    prediction + recon/art correction codes, one C call per frame.
    Returns ``(qdct int16 [H, W], recon u8, art u8)`` or None when the
    native library is unavailable (caller runs the staged chain).
    ``planes``: the reference stack [R, H, W] u8, or the half-pel stack
    [R, 2H, 2W] when ``frac``."""
    from ..entropy import native
    from ..entropy.zigzag import zigzag_indices
    from . import transform as T

    lib = native._load()
    if lib is None:
        return None
    lay = f["lay"]
    h, w = f["h"], f["w"]
    nbr, nbc = h // bs, w // bs
    if lay.devbits:
        qv_kind = 4  # qv = the packed dct bitstream; n_qe4 = its bit length
        qv = np.ascontiguousarray(f["db"], np.uint8)
        qe4 = np.zeros(0, np.uint8)
        qe = np.zeros(0, np.int16)
    elif lay.q4:
        qv_kind = 3  # 2-bit codes + nibble escapes + int16 deep escapes
        qv = np.ascontiguousarray(f["qv_raw"], np.uint8)
        qe4 = np.ascontiguousarray(f["qe4_raw"], np.uint8)
        qe_raw = f["qe_raw"]
        qe = (np.ascontiguousarray(qe_raw.view(np.int16))
              if qe_raw is not None and qe_raw.size
              else np.zeros(0, np.int16))
    else:
        qv_kind = 1 if lay.vbytes == 1 else 0
        qv = np.ascontiguousarray(f["qv_raw"], np.uint8)
        qe4 = np.zeros(0, np.uint8)
        qe = np.zeros(0, np.int16)
    n_qe4 = f["dbits"] if lay.devbits else 2 * qe4.size
    ql = (np.zeros(1, np.uint8) if lay.devbits
          else np.ascontiguousarray(f["ql"]))
    ql_u8 = 1 if ql.dtype == np.uint8 else 0
    zz = np.ascontiguousarray(zigzag_indices(bs), np.int64)
    rq = np.ascontiguousarray(row_qps, np.int32)
    d = np.ascontiguousarray(T.dct_matrix_int(bs), np.int32)
    jb = np.ascontiguousarray(f["jb"], np.uint8)
    jk = np.ascontiguousarray(f["jk"], np.uint8)
    re = np.ascontiguousarray(f["re"], np.uint8)
    ae = np.ascontiguousarray(f["ae"], np.uint8)
    pl = np.ascontiguousarray(planes, np.uint8)
    m = np.ascontiguousarray(mvs, np.int32)
    qdct = np.empty((h, w), np.int16)
    x = np.empty(nbr * nbc * bs * bs, np.int32)
    states = np.empty(h * w, np.uint8)
    pred = np.empty(h * w, np.uint8)
    recon = np.empty((h, w), np.uint8)
    art = np.empty((h, w), np.uint8)
    # bvc_rebuild_p hardcodes the joint-state ids; they are fixed by the
    # J_* enum above (J_NONE..J_BESC = range(8))
    lib.bvc_rebuild_p(
        qv.ctypes.data, qv_kind, qe4.ctypes.data, n_qe4,
        qe.ctypes.data, qe.size,
        ql.ctypes.data, ql_u8, zz.ctypes.data, rq.ctypes.data,
        d.ctypes.data, nbr, nbc, bs, T.EXACT_SHIFT, T.IDCT_GUARD,
        jb.ctypes.data, jk.ctypes.data, jk.size // 3 * 8,
        re.ctypes.data, re.size, ae.ctypes.data, ae.size,
        pl.ctypes.data, pl.shape[1], pl.shape[2], 1 if frac else 0,
        m.ctypes.data, qdct.ctypes.data, x.ctypes.data,
        states.ctypes.data, pred.ctypes.data, recon.ctypes.data,
        art.ctypes.data)
    return qdct, recon, art


def apply_joint(states: np.ndarray, esc: np.ndarray, base: np.ndarray,
                plus: int, minus: int, escs: tuple) -> np.ndarray:
    """Rebuild one of the joint-coded planes: ``base`` int [H, W] plus the
    per-pixel {0, +1, -1} deltas and the positioned escapes -> u8 [H, W]."""
    from ..entropy import native

    h, w = base.shape
    lib = native._load()
    if lib is not None:
        b8 = np.ascontiguousarray(base.astype(np.uint8))
        e8 = np.ascontiguousarray(esc, np.uint8)
        st = np.ascontiguousarray(states, np.uint8)
        out = np.empty(h * w, np.uint8)
        lib.bvc_apply_joint(st.ctypes.data, e8.ctypes.data, b8.ctypes.data,
                            out.ctypes.data, h * w, plus, minus,
                            escs[0], escs[1])
        return out.reshape(h, w)
    flat = base.reshape(-1).astype(np.int32)
    delta = (states == plus).astype(np.int32) - (states == minus)
    out = ((flat + delta) & 255).astype(np.uint8)
    pos = np.flatnonzero((states == escs[0]) | (states == escs[1]))
    out[pos] = esc[: pos.size]
    return out.reshape(h, w)


def joint_recon(states, re, guess_r):
    return apply_joint(states, re, guess_r, J_RP, J_RM, (J_RESC, J_BESC))


def joint_art(states, ae, guess_a):
    return apply_joint(states, ae, guess_a, J_AP, J_AM, (J_AESC, J_BESC))


def _x_int_blocks_np(qdct: np.ndarray, row_qps: np.ndarray, bs: int) -> np.ndarray:
    """Host twin of the rescale+integer-IDCT step of
    :func:`recon_guess_plane`: int32 [nbr, nbc, bs, bs], bit-identical to
    the device computation."""
    from . import transform as T

    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    q = qdct.reshape(nbr, bs, nbc, bs).swapaxes(1, 2).astype(np.int32)
    Qi = T.quant_matrices(bs).astype(np.int32)[np.asarray(row_qps, np.int32)]
    return T.idct2_exact_core_np(q * Qi[:, None], T.dct_matrix_int(bs))


def host_recon_guess_from_x(x: np.ndarray, pred: np.ndarray, bs: int) -> np.ndarray:
    """Host twin of :func:`recon_guess_from_x` (inter frames: the whole
    prediction plane is known up front, so this is fully vectorized)."""
    from . import transform as T

    nbr, nbc = x.shape[:2]
    h, w = nbr * bs, nbc * bs
    s = T.EXACT_SHIFT
    p = pred.reshape(nbr, bs, nbc, bs).swapaxes(1, 2).astype(np.int32)
    g = (x + (p << s) + (1 << (s - 1))) >> s
    return np.clip(g, 0, 255).astype(np.uint8).swapaxes(1, 2).reshape(h, w)


def host_art_guess_from_x(x: np.ndarray) -> np.ndarray:
    """Host twin of :func:`art_guess_from_x`: u8 [H, W]."""
    from . import transform as T

    nbr, nbc, bs = x.shape[:3]
    s = T.EXACT_SHIFT
    t = np.where(x >= 0, x >> s, -((-x) >> s))
    return (t & 255).astype(np.uint8).swapaxes(1, 2).reshape(nbr * bs, nbc * bs)


def host_recon_guess(qdct: np.ndarray, row_qps: np.ndarray,
                     pred: np.ndarray, bs: int) -> np.ndarray:
    """:func:`host_recon_guess_from_x` of :func:`_x_int_blocks_np`."""
    return host_recon_guess_from_x(_x_int_blocks_np(qdct, row_qps, bs), pred, bs)


def host_x_art(qdct: np.ndarray, row_qps: np.ndarray, bs: int,
               want_art: bool = True):
    """``(_x_int_blocks_np(...), host_art_guess_from_x(...))`` in ONE native
    pass (bvc_x_art) — the fixed-point IDCT is the single most expensive
    host-rebuild step, and fusing the truncation guess reads each x block
    while it is still in cache.  NumPy fallback composes the twins."""
    from ..entropy import native
    from . import transform as T

    lib = native._load()
    if lib is None:
        x = _x_int_blocks_np(qdct, row_qps, bs)
        return x, (host_art_guess_from_x(x) if want_art else None)
    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    q = np.ascontiguousarray(qdct, np.int16)
    rq = np.ascontiguousarray(row_qps, np.int32)
    d = np.ascontiguousarray(T.dct_matrix_int(bs), np.int32)
    x = np.empty((nbr, nbc, bs, bs), np.int32)
    art = np.empty((h, w), np.uint8) if want_art else None
    lib.bvc_x_art(q.ctypes.data, rq.ctypes.data, d.ctypes.data, nbr, nbc,
                  bs, T.EXACT_SHIFT, T.IDCT_GUARD, x.ctypes.data,
                  art.ctypes.data if want_art else None)
    return x, art


def host_recon_joint(x: np.ndarray, pred: np.ndarray, states: np.ndarray,
                     re: np.ndarray, bs: int) -> np.ndarray:
    """Inter reconstruction: guess from the blocked integer residuals +
    joint correction codes, fused in one native pass (bvc_recon_joint).
    NumPy fallback: :func:`joint_recon` over :func:`host_recon_guess_from_x`."""
    from ..entropy import native
    from . import transform as T

    lib = native._load()
    if lib is None:
        return joint_recon(states, re, host_recon_guess_from_x(x, pred, bs)
                           .astype(np.int32))
    nbr, nbc = x.shape[:2]
    p = np.ascontiguousarray(pred, np.uint8)
    st = np.ascontiguousarray(states, np.uint8)
    e8 = np.ascontiguousarray(re, np.uint8)
    xc = np.ascontiguousarray(x, np.int32)
    out = np.empty((nbr * bs, nbc * bs), np.uint8)
    lib.bvc_recon_joint(xc.ctypes.data, p.ctypes.data, st.ctypes.data,
                        e8.ctypes.data, nbr, nbc, bs, T.EXACT_SHIFT,
                        J_RP, J_RM, J_RESC, J_BESC, out.ctypes.data)
    return out


def host_rebuild_intra_recon(qdct: np.ndarray, modes: np.ndarray,
                             row_qps: np.ndarray, codes2: np.ndarray,
                             esc: np.ndarray, bs: int,
                             jst: np.ndarray | None = None,
                             x: np.ndarray | None = None) -> np.ndarray:
    """Rebuild an I-frame's reconstruction from its correction codes —
    either a 2-bit ``codes2`` plane (:func:`pack_vs_base`) or the recon half
    of a joint 3-bit state stream (``jst``, :func:`pack_joint`).

    Intra prediction reads *reconstructed* neighbors (reference
    IFrame.py:198-213), so blocks are corrected in scan order — each block's
    codes make it exact before the next block predicts from it.  The
    integer IDCT is batched up front; the loop applies prediction + codes
    per block (~microseconds each)."""
    from . import transform as T

    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    if jst is not None:
        code = np.take(np.array([0, 1, -1, 0, 0, 3, 0, 3], np.int32),
                       jst).reshape(h, w)
    else:
        code = np.take(np.array([0, 1, -1, 3], np.int32),
                       _unpack_codes(codes2)).reshape(h, w)
    is_esc = code == 3
    esc_plane = np.zeros(h * w, np.uint8)
    pos = np.flatnonzero(is_esc.reshape(-1))
    esc_plane[pos] = esc[: pos.size]
    esc_plane = esc_plane.reshape(h, w)
    if x is None:
        x = _x_int_blocks_np(qdct, row_qps, bs)

    from ..entropy import native

    lib = native._load()
    if lib is not None:
        xc = np.ascontiguousarray(x, np.int32)
        mc = np.ascontiguousarray(modes, np.int32)
        cc = np.ascontiguousarray(code, np.int8)
        ec_ = np.ascontiguousarray(esc_plane, np.uint8)
        out = np.empty((h, w), np.uint8)
        lib.bvc_intra_rebuild(xc.ctypes.data, mc.ctypes.data, cc.ctypes.data,
                              ec_.ctypes.data, nbr, nbc, bs, T.EXACT_SHIFT,
                              out.ctypes.data)
        return out
    s = T.EXACT_SHIFT
    half = 1 << (s - 1)
    border = np.full((bs, bs), 128, np.int32)
    recon = np.zeros((h, w), np.int32)
    for r in range(nbr):
        y0 = r * bs
        for c in range(nbc):
            x0 = c * bs
            if modes[r, c] == 0:  # H: pixel (a, b) reads recon[y0+b, x0-1]
                pred = (np.broadcast_to(recon[y0 : y0 + bs, x0 - 1][None, :],
                                        (bs, bs)) if c > 0 else border)
            else:                 # V: pixel (a, b) reads recon[y0-1, x0+a]
                pred = (np.broadcast_to(recon[y0 - 1, x0 : x0 + bs][:, None],
                                        (bs, bs)) if r > 0 else border)
            g = np.clip((x[r, c] + (pred << s) + half) >> s, 0, 255)
            cb = code[y0 : y0 + bs, x0 : x0 + bs]
            blk = np.where(is_esc[y0 : y0 + bs, x0 : x0 + bs],
                           esc_plane[y0 : y0 + bs, x0 : x0 + bs],
                           (g + cb) & 255)
            recon[y0 : y0 + bs, x0 : x0 + bs] = blk
    return recon.astype(np.uint8)


def host_pred_inter(refs: np.ndarray, mvs: np.ndarray, bs: int,
                    frac: bool, hps: np.ndarray | None = None) -> np.ndarray:
    """Motion-compensated prediction plane from host-resident data — the
    NumPy twin of ops.me.gather_pred_blocks.  ``refs`` is either one plane
    [H, W] (single-reference path: mv ref index is always 0) or the rolling
    stack [R, H, W] in deque order; ``hps`` likewise when ``frac``."""
    from ..entropy import native

    if refs.ndim == 2:
        refs = refs[None]
    if hps is not None and hps.ndim == 2:
        hps = hps[None]
    nbr, nbc = mvs.shape[:2]
    lib = native._load()
    if lib is not None:
        planes = np.ascontiguousarray(hps if frac else refs, np.uint8)
        m = np.ascontiguousarray(mvs, np.int32)
        out = np.empty((nbr * bs, nbc * bs), np.uint8)
        lib.bvc_pred_inter(planes.ctypes.data, planes.shape[1],
                           planes.shape[2], m.ctypes.data, nbr, nbc, bs,
                           1 if frac else 0, out.ctypes.data)
        return out.astype(np.int32)
    a = np.arange(bs)
    ref_idx = mvs[..., 2][..., None, None]
    if frac:
        planes = hps
        oy = (np.arange(nbr) * bs * 2)[:, None, None, None]
        ox = (np.arange(nbc) * bs * 2)[None, :, None, None]
        rows = oy + mvs[..., 1][..., None, None] + 2 * a[None, None, :, None]
        cols = ox + mvs[..., 0][..., None, None] + 2 * a[None, None, None, :]
    else:
        planes = refs
        oy = (np.arange(nbr) * bs)[:, None, None, None]
        ox = (np.arange(nbc) * bs)[None, :, None, None]
        rows = oy + mvs[..., 1][..., None, None] + a[None, None, :, None]
        cols = ox + mvs[..., 0][..., None, None] + a[None, None, None, :]
    pred = planes[ref_idx, rows, cols]
    h, w = nbr * bs, nbc * bs
    return pred.transpose(0, 2, 1, 3).reshape(h, w).astype(np.int32)


def host_intra_art(curr: np.ndarray, recon: np.ndarray, modes: np.ndarray,
                   bs: int) -> np.ndarray:
    """I-frame res_w_mc plane from host-resident data: the residual vs the
    chosen intra predictor, uint8-wrapped (reference IFrame.py:30,57).

    Preserves the transposed-predictor quirk (ops/intra.py): within a block
    at (y0, x0), H-mode pixel (a, b) reads recon[y0 + b, x0 - 1] and V-mode
    pixel (a, b) reads recon[y0 - 1, x0 + a]; borders predict 128."""
    from ..entropy import native

    h, w = curr.shape
    lib = native._load()
    if lib is not None:
        c = np.ascontiguousarray(curr, np.uint8)
        r = np.ascontiguousarray(recon, np.uint8)
        m = np.ascontiguousarray(modes, np.int32)
        out = np.empty((h, w), np.uint8)
        lib.bvc_intra_art(c.ctypes.data, r.ctypes.data, m.ctypes.data,
                          h // bs, w // bs, bs, out.ctypes.data)
        return out
    ys, xs = np.arange(h), np.arange(w)
    y0, x0 = (ys // bs) * bs, (xs // bs) * bs
    ri = recon.astype(np.int32)
    ry = y0[:, None] + (xs % bs)[None, :]
    pred_h = np.where((x0 - 1)[None, :] >= 0,
                      ri[ry, np.maximum(x0 - 1, 0)[None, :]], 128)
    cx = x0[None, :] + (ys % bs)[:, None]
    pred_v = np.where((y0 - 1)[:, None] >= 0,
                      ri[np.maximum(y0 - 1, 0)[:, None], cx], 128)
    mode_px = np.repeat(np.repeat(modes, bs, axis=0), bs, axis=1)
    pred = np.where(mode_px == 0, pred_h, pred_v)
    return ((curr.astype(np.int32) - pred) & 255).astype(np.uint8)
