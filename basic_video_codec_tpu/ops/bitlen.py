"""Exact entropy bit lengths computed on device.

Rate control needs the *exact* number of bits each block row will occupy in
the final bitstream (reference decrements its budget with real bitarray
lengths, IFrame.py:63-70).  Exp-Golomb codeword lengths are closed-form
(``2*bitlen(mapped+1) - 1``), and the RLE run structure reduces to cumulative
boolean ops, so the device can price a row without materializing a single
bit — the host only packs bits once, after all QP decisions are made.
"""

import jax
import jax.numpy as jnp
import numpy as np


def _bitlen(x: jnp.ndarray) -> jnp.ndarray:
    """Integer bit length of non-negative values (< 2^17), exact — no float log."""
    x = x.astype(jnp.int32)
    n = jnp.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = x >> s
        has = hi > 0
        n = n + jnp.where(has, s, 0)
        x = jnp.where(has, hi, x)
    return n + (x > 0)


def golomb_len(values: jnp.ndarray) -> jnp.ndarray:
    """Signed exp-Golomb codeword length: ``2*bitlen(mapped+1) - 1``
    (codeword structure per reference entropy_encoder.py:8-29)."""
    v = values.astype(jnp.int32)
    mapped = jnp.where(v <= 0, -2 * v, 2 * v - 1)
    return 2 * _bitlen(mapped + 1) - 1


EOB_LEN = 27  # golomb_len(8190): mapped+1 = 16380, 14 bits -> 27


def rle_block_bits(zigzagged: jnp.ndarray) -> jnp.ndarray:
    """Exact RLE+exp-Golomb bit cost per block, including the EOB marker.

    Parameters
    ----------
    zigzagged : int ``[..., L]`` — zigzag scans (last axis = scan position).

    Matches ``sum(golomb_len(s) for s in rle_encode(scan)) + EOB_LEN``:

    * every non-zero coefficient contributes its own codeword,
    * every non-zero run start contributes the ``-run_len`` header,
    * every zero run contributes ``run_len`` header — or the 1-bit ``0``
      terminator when the run reaches the end of the block.
    """
    z = zigzagged.astype(jnp.int32)
    L = z.shape[-1]
    nz = z != 0
    pos = jnp.arange(L, dtype=jnp.int32)

    # run starts: position 0 or zero/non-zero class change
    prev_nz = jnp.concatenate([~nz[..., :1], nz[..., :-1]], axis=-1)
    start = nz != prev_nz
    start = start.at[..., 0].set(True)

    # next run start after each position (reverse cummin of start positions)
    start_pos = jnp.where(start, pos, L)
    nxt = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(start_pos, axis=-1), axis=-1),
        axis=-1,
    )
    nxt_after = jnp.concatenate(
        [nxt[..., 1:], jnp.full_like(nxt[..., :1], L)], axis=-1
    )  # first start strictly after this position
    run_len = nxt_after - pos  # valid at start positions

    # literal codewords for every non-zero coefficient
    lit_bits = jnp.where(nz, golomb_len(z), 0)
    # headers at run starts
    nz_header = golomb_len(-run_len)
    zero_reaches_end = nxt_after == L
    zero_header_val = jnp.where(zero_reaches_end, 0, run_len)
    zero_header = golomb_len(zero_header_val)
    header_bits = jnp.where(start, jnp.where(nz, nz_header, zero_header), 0)

    return lit_bits.sum(axis=-1) + header_bits.sum(axis=-1) + EOB_LEN


def zigzag_rows(blocks_flat: jnp.ndarray, bs: int) -> jnp.ndarray:
    """``[..., bs*bs]`` flattened int blocks -> int32 zigzag scans: a static
    gather (on an H100 it beat the exact 0/1 selector-matmul form at the CIF
    shapes, 0.044 vs 0.065 ms for 8 frames at block 8)."""
    from ..entropy.zigzag import zigzag_indices

    return blocks_flat[..., np.asarray(zigzag_indices(bs))].astype(jnp.int32)


def intra_mode_bits(modes: jnp.ndarray) -> jnp.ndarray:
    """Per-block intra mode codeword length (mode 0 -> 1 bit, 1 -> 3 bits)."""
    return jnp.where(modes == 0, 1, 3)
