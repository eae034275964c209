"""Device-side entropy coding: the FINAL bitstream bytes, packed on device.

The host entropy coder (entropy/native.py) packs each frame's pred/dct
symbol streams into exp-Golomb bitstreams after the compact transfer lands.
That leaves two costs on the host critical path: the qdct prefix codes in
the transfer (its largest field) and the host bit-packing pass.  Every codeword is closed-form — signed exp-Golomb
of value ``v`` is the integer ``mapped(v)+1`` written MSB-first in a field
of ``2*bitlen(mapped+1)-1`` bits (reference encoder/entropy_encoder.py:8-29)
— so the device can emit the finished bitstream itself:

* classify each zigzag position into RLE slots (run headers / literals /
  per-block terminator+EOB) with the same vector forms ops/bitlen.py uses
  for rate-control pricing (reference entropy_encoder.py:65-112 grammar);
* compute every slot's ABSOLUTE bit offset from two exclusive cumsums
  (within-block over interleaved header/literal slots, then over blocks);
* compact the valid slots (ops/pack.compact_stream)
  and scatter-add each codeword's two 32-bit word contributions.  Codes
  never share bits, so integer add == bitwise or, and int32 wraparound is
  irrelevant (no carries between disjoint bits).

The result is byte-identical to entropy/native.encode_symbols_bytes /
encode_dct_plane_bytes (asserted in tests/test_bitpack.py and by the golden
e2e parity suite); the host writes the bytes straight into encoded.bin and
re-derives the qdct plane by *decoding* them in one native pass.

Cost model (CIF block 8): the slot classification is elementwise +
two associative scans on [nb, L]; the compaction is one stable sort
(~0.2-0.5 ms); the scatter is 2x cap_sym adds (~0.3-0.6 ms).  The q-prefix
packers (pack_qdct) leave the program in exchange.
"""

from functools import partial

import jax
import jax.numpy as jnp

from .bitlen import EOB_LEN, _bitlen

EOB_CODE = 16380  # mapped(8190)+1: the EOB codeword's value field (27 bits)


def golomb_code(v: jnp.ndarray):
    """Signed value -> ``(code, nbits)``: the codeword as an integer (the
    ``mapped+1`` value, whose leading zeros inside the ``nbits``-wide field
    ARE the exp-Golomb prefix) and its total bit length."""
    v = v.astype(jnp.int32)
    mapped = jnp.where(v <= 0, -2 * v, 2 * v - 1)
    x = mapped + 1
    return x, 2 * _bitlen(x) - 1


def dct_slots(z: jnp.ndarray):
    """Zigzag scans ``[nb, L]`` -> flattened symbol slots with absolute bit
    offsets: ``(offs, codes, lens, valid, block_bits)``.

    Slot order per block: interleaved (header, literal) pairs per scan
    position, then the EOB marker — exactly the scalar RLE emission order
    (entropy/rle.py:21-39; a header precedes its run's first literal at the
    same position).  ``block_bits`` matches ops/bitlen.rle_block_bits.
    """
    z = z.astype(jnp.int32)
    nb, L = z.shape
    nz = z != 0
    pos = jnp.arange(L, dtype=jnp.int32)

    prev_nz = jnp.concatenate([~nz[:, :1], nz[:, :-1]], axis=1)
    start = (nz != prev_nz).at[:, 0].set(True)

    # next run start strictly after each position (reverse cummin)
    start_pos = jnp.where(start, pos, L)
    nxt = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(start_pos, axis=1), axis=1),
        axis=1,
    )
    nxt_after = jnp.concatenate([nxt[:, 1:], jnp.full_like(nxt[:, :1], L)], axis=1)
    run_len = nxt_after - pos  # valid at start positions
    reaches_end = nxt_after == L

    # header slots: -run_len for non-zero runs; zero runs emit their length,
    # or the 1-bit "0" terminator when the run reaches the block end
    hdr_val = jnp.where(nz, -run_len, jnp.where(reaches_end, 0, run_len))
    hv, hl = golomb_code(hdr_val)
    hl = jnp.where(start, hl, 0)
    # literal slots: every non-zero coefficient
    lv, ll = golomb_code(z)
    ll = jnp.where(nz, ll, 0)

    slot_len = jnp.stack([hl, ll], axis=-1).reshape(nb, 2 * L)
    slot_val = jnp.stack([hv, lv], axis=-1).reshape(nb, 2 * L)
    within = jnp.cumsum(slot_len, axis=1) - slot_len  # exclusive, per block
    block_bits = slot_len[:, -1] + within[:, -1] + EOB_LEN
    block_off = jnp.cumsum(block_bits) - block_bits  # exclusive, raster order

    offs = (block_off[:, None] + within).reshape(-1)
    codes = slot_val.reshape(-1)
    lens = slot_len.reshape(-1)
    valid = lens > 0

    eob_off = block_off + block_bits - EOB_LEN
    offs = jnp.concatenate([offs, eob_off])
    codes = jnp.concatenate([codes, jnp.full(nb, EOB_CODE, jnp.int32)])
    lens = jnp.concatenate([lens, jnp.full(nb, EOB_LEN, jnp.int32)])
    valid = jnp.concatenate([valid, jnp.ones(nb, bool)])
    return offs, codes, lens, valid, block_bits


def emit_codes(words: jnp.ndarray, offs, codes, lens, live):
    """Scatter-add codeword bit fields into a big-endian int32 word array.

    Each code occupies bits ``[b, b+len)`` of the 64-bit window starting at
    word ``offs >> 5`` (``b = offs & 31``), so it contributes to at most two
    words (codeword lengths <= 33 < 64 - 31).  Disjoint bit fields make
    add == or with no carries."""
    t = (offs & 31) + lens  # end bit within the 2-word window
    wi = offs >> 5
    lo_half = t <= 32
    # t can reach 64 (a 33-bit field starting at bit 31), making the raw
    # hi shift 32 — implementation-defined for int32 in XLA.  Codes are
    # positive int32 with <= 17 significant bits (field length 2*bitlen-1
    # <= 33 => value bits <= 17), so a logical >>32 is 0, and clamping to
    # >>31 yields that same 0 with defined semantics.
    sh = jnp.where(lo_half, 32 - t, jnp.minimum(t - 32, 31))
    hi = jnp.where(lo_half, codes << sh, codes >> sh)
    lo = jnp.where(lo_half, 0, codes << jnp.clip(64 - t, 0, 31))
    hi = jnp.where(live, hi, 0)
    lo = jnp.where(live, lo, 0)
    wi = jnp.where(live, wi, 0)
    return words.at[jnp.concatenate([wi, wi + 1])].add(
        jnp.concatenate([hi, lo]), mode="drop")


def words_to_bytes(words: jnp.ndarray) -> jnp.ndarray:
    """int32 big-endian words -> uint8 byte stream (4x length)."""
    w = words[:, None] >> jnp.array([24, 16, 8, 0], jnp.int32)[None, :]
    return (w & 255).astype(jnp.uint8).reshape(-1)


def dct_sym_cap(capq: int, nb: int, L: int) -> int:
    """Static symbol-slot capacity for the dct stream — the worst case
    given the config class's literal budget, so devbits overflow can only
    happen when the q-prefix class itself would overflow (and NEVER for
    the generous qfrac=(1,1) low-QP classes, where the bound is the
    mathematical plane maximum).

    Per block of ``L`` zigzag positions with ``k`` literals, headers (one
    per run) peak when nonzeros are isolated: ``min(2k, 2(L-k)) + 1``.
    Summed with literals and maximized over ``k`` under the class literal
    budget ``lits <= min(capq, nb*L)`` (the q-prefix cap counts the same
    nonzero coefficients): ``slots <= min(3*capq, 3*nb*L/2) + nb``, plus
    ``nb`` EOB markers.  The earlier measured-headroom cap (``capq + 2*nb``)
    overflowed EVERY qp-0 frame on camera-statistics content (headers
    alone reach ~L/3 per block), and each overflow costs a synchronous
    full-plane fallback fetch — while a generous
    cap costs only device pool allocation and scatter-add work, because
    tail-mode transfers ship USED bytes (ops/pack.py qdct_caps doctrine).
    """
    return min(3 * capq, 3 * nb * L // 2) + 2 * nb


def max_dct_code_bits(bs: int) -> int:
    """Longest single codeword the dct stream can contain for block size
    ``bs``: the worst-case quantized literal is |coeff| <= 255*bs (the
    orthonormal 2-D DCT's DC bound at Q=1), coded in 2*bitlen(2*255*bs+1)-1
    bits; headers are bounded by run length <= bs*bs and the EOB marker is
    EOB_LEN bits."""
    lit = 2 * int(2 * 255 * bs + 1).bit_length() - 1
    hdr = 2 * int(2 * bs * bs + 1).bit_length() - 1
    return max(lit, hdr, EOB_LEN)


def dct_word_cap(cap_sym: int, bs: int = 8) -> int:
    """Word capacity of the packed dct stream (+1 spill word for the
    scatter's ``wi + 1`` at the last code).  Sized from the longest
    codeword the config's block size can emit, so dense worst-case content
    hits the symbol-count overflow check (n > cap_sym) rather than
    silently exhausting the byte budget early."""
    return (cap_sym * max_dct_code_bits(bs) + 31) // 32 + 1


def pack_dct_bits(z: jnp.ndarray, cap_sym: int, bs: int = 8):
    """Zigzag scans ``[nb, L]`` -> ``(bytes u8 [4*cap_words], total_bits,
    n_sym)``.

    ``total_bits`` is exact (== ops/bitlen.rle_block_bits summed);
    ``n_sym > cap_sym`` or ``total_bits > 32*(cap_words-1)`` flags overflow
    — the byte stream is then invalid and the caller must fall back to the
    full qdct plane."""
    from .pack import compact_stream

    offs, codes, lens, valid, _ = dct_slots(z)
    total_bits = jnp.sum(lens * valid)
    n, offs_c, codes_c, lens_c = compact_stream(valid, (offs, codes, lens),
                                                cap_sym)
    cap_words = dct_word_cap(cap_sym, bs)
    live = jnp.arange(cap_sym, dtype=jnp.int32) < jnp.minimum(n, cap_sym)
    # drop any code whose window would spill past the cap (overflow case —
    # the stream is discarded anyway, but the scatter must stay in bounds)
    live = live & (offs_c + lens_c <= 32 * (cap_words - 1))
    words = jnp.zeros(cap_words, jnp.int32)
    words = emit_codes(words, offs_c, codes_c, lens_c, live)
    return words_to_bytes(words), total_bits, n


def pack_pred_bits(syms: jnp.ndarray, lens_valid=None, cap_words: int = None):
    """Fully-materialized pred symbol vector -> ``(bytes, total_bits)``.

    ``lens_valid``: optional bool mask — masked symbols occupy zero bits
    (used by runtime-mode rows where intra symbol rows are shorter than the
    static inter shape).  The cap is worst-case exact (33 bits/symbol), so
    this stream cannot overflow."""
    syms = syms.reshape(-1)
    codes, lens = golomb_code(syms)
    if lens_valid is not None:
        m = lens_valid.reshape(-1)
        lens = jnp.where(m, lens, 0)
    else:
        m = jnp.ones(syms.shape[0], bool)
    offs = jnp.cumsum(lens) - lens
    total_bits = lens.sum()
    if cap_words is None:
        cap_words = pred_word_cap(syms.shape[0])
    words = jnp.zeros(cap_words, jnp.int32)
    words = emit_codes(words, offs, codes, lens, m & (lens > 0))
    return words_to_bytes(words), total_bits


def pred_word_cap(n_syms: int) -> int:
    """Worst-case word capacity for ``n_syms`` pred symbols (33-bit codes:
    |qp diffs| and MV diffs stay far under 2^16)."""
    return (n_syms * 33 + 31) // 32 + 1


def pred_syms_intra(row_qps: jnp.ndarray, qp0: int, modes: jnp.ndarray):
    """Per-row ``[qp_diff, modes...]`` symbol matrix [nbr, 1+nbc]
    (reference IFrame.py entropy layout; golden/frames.py:181-185)."""
    nbr = row_qps.shape[0]
    qd = (row_qps.astype(jnp.int32) - qp0)[:, None]
    return jnp.concatenate([qd, modes.reshape(nbr, -1).astype(jnp.int32)],
                           axis=1)


def pred_syms_inter(row_qps: jnp.ndarray, qp0: int, mv_flat: jnp.ndarray,
                    nbr: int, k: int):
    """Per-row ``[qp_diff, mv diffs...]`` matrix [nbr, 1+nbc*k]: MV
    components differenced against the previous block raster-wide, first
    block against zero (reference PFrame.py entropy layout; the pipeline's
    host twin is models/pipeline._finalize_fields)."""
    flat = mv_flat.reshape(-1, 3).astype(jnp.int32)
    prev = jnp.concatenate([jnp.zeros((1, 3), jnp.int32), flat[:-1]], axis=0)
    diffs = (flat - prev)[:, :k].reshape(nbr, -1)
    qd = (row_qps.astype(jnp.int32) - qp0)[:, None]
    return jnp.concatenate([qd, diffs], axis=1)
