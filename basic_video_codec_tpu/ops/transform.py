"""Device transform stack: batched 2D DCT/IDCT as matmuls + fused
quantize / rescale / reconstruct.

Replaces the reference's per-block ``scipy.fftpack.dct`` calls
(encoder/dct.py:9-18) and per-block quantize/reconstruct
(dct.py:35-42, Frame.py:197-202) with one batched op over all blocks of a
frame: ``coeffs = D @ X @ D.T`` where ``D`` is the orthonormal DCT-II matrix —
two ``[n_blocks, bs, bs] x [bs, bs]`` matmul sweeps, with the elementwise
quantize fused behind them.

Precision note (the "bit-exact" story): the transform is defined as the
float32 matmul DCT with ``precision=HIGHEST``.  The golden model's scipy FFT
path computes the same real transform with its own float32 rounding; the two
agree to ~1e-6 relative, so a quantized coefficient can differ by ±1 only when
``dct/Q`` lands within float error of a rounding boundary (chip_smoke.py
counts them at QP 0 on frame-difference residuals; PARITY.md states the
bound).  ``HIGHEST`` keeps the GPU's matmuls out of TF32.  What is *exact* by
construction: everything downstream of the quantized integers — entropy bits,
reconstruction arithmetic, and decoder/encoder agreement (decode == recon
bit-for-bit, since both run these same kernels).
"""

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

_HIGHEST = jax.lax.Precision.HIGHEST


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, computed in float64 and rounded to float32.

    ``D[k, m] = s_k * cos(pi * (2m + 1) * k / (2n))`` with
    ``s_0 = sqrt(1/n)``, ``s_k = sqrt(2/n)`` — the same transform scipy's
    ``dct(norm='ortho')`` evaluates (reference encoder/dct.py:9-18).
    """
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return d.astype(np.float32)


EXACT_SHIFT = 13  # fixed-point scale of the integer DCT basis
IDCT_GUARD = 6  # guard bits kept through the exact-IDCT mid stage


@lru_cache(maxsize=None)
def dct_matrix_int(n: int, shift: int = EXACT_SHIFT) -> np.ndarray:
    """Fixed-point DCT-II basis ``round(D * 2^shift)`` (int32).

    Powers the optional *exact transform* mode: integer matmuls are
    bit-deterministic on every backend (an H100 reproduces the NumPy twin
    and the CPU backend bit for bit over the full value ranges), so streams
    encoded with ``exact_transform=True`` are bit-identical across CPU and
    GPU — something no float DCT can guarantee.
    Basis quantization error is ~2^-13, far below the codec's own
    quantization at any QP.
    """
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return np.round(d * (1 << shift)).astype(np.int32)


def _rshift_round(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """Deterministic round-half-up ``x / 2^s`` for signed int32."""
    return (x + (1 << (s - 1))) >> s


def dct2_exact(blocks_i32: jnp.ndarray, d_int: jnp.ndarray) -> jnp.ndarray:
    """Integer-exact 2D DCT: two int32 matmuls with a mid-stage rescale;
    returns float32 coefficient values (exactly determined by the ints).

    Exactness argument: every *product* fits int32 (|t1'| <= 2^13,
    |d_int| <= 2^13 -> 2^26) and every *true* result fits int32 (final values
    are coefficient*2^(shift+2) <= 2^27), so two's-complement accumulation is
    correct even if loosely-bounded partial sums wrap.  The mid stage keeps
    2 guard bits for precision (basis error then dominates at ~2^-13).
    """
    x = blocks_i32.astype(jnp.int32)
    t1 = jnp.einsum("km,...mn->...kn", d_int, x)          # D_i @ X, <= 2^27
    t1 = _rshift_round(t1, EXACT_SHIFT - 2)               # ~t1_true * 4
    y = jnp.einsum("...kn,ln->...kl", t1, d_int)          # true <= 2^27
    return y.astype(jnp.float32) / jnp.float32(1 << (EXACT_SHIFT + 2))


def idct2_exact_core(rescaled_i32: jnp.ndarray, d_int: jnp.ndarray) -> jnp.ndarray:
    """Integer core of :func:`idct2_exact`: returns the residual scaled by
    ``2^EXACT_SHIFT`` as int32, before the float conversion.  Every operation
    is deterministic integer arithmetic, so :func:`idct2_exact_core_np` below
    reproduces it bit-for-bit on the host — the foundation of the compact
    transfer's reconstruction correction codes (ops/pack.py).

    The mid stage keeps ``IDCT_GUARD`` fractional bits: without them the
    per-entry rounding error (<= 0.5) amplifies through the second matmul to
    ~0.25 *pixel* units, flipping the rounded reconstruction on ~9% of
    pixels vs the float path — with 6 guard bits that drops ~30x (measured),
    which is what keeps the compact-transfer correction lists small.
    Exactness: mid products <= 2^13 * 2^13 = 2^26; second-stage products may
    wrap int32, but two's-complement sums stay congruent mod 2^32 and the
    TRUE result (residual * 2^(13+6) <= ~2^30) fits, so the wrap cancels."""
    y = rescaled_i32.astype(jnp.int32)
    t1 = jnp.einsum("km,...kl->...ml", d_int, y)          # D_i^T @ Y
    t1 = _rshift_round(t1, EXACT_SHIFT - IDCT_GUARD)      # ~t1_true * 2^g
    x = jnp.einsum("...ml,ln->...mn", t1, d_int)          # true <= ~2^30
    return _rshift_round(x, IDCT_GUARD)


def idct2_exact_core_np(rescaled_i32: np.ndarray, d_int: np.ndarray) -> np.ndarray:
    """Bit-identical NumPy twin of :func:`idct2_exact_core` (verified in
    tests/test_pack.py).  The matmuls run in float64 BLAS — NumPy integer
    einsums fall back to slow C loops (~6 ms per CIF block-16 frame, the
    whole host rebuild budget); batched ``np.matmul`` beats tensordot /
    flattened-GEMM variants here (measured).  Products stay < 2^32, exact
    in float64; the device's int32 wrap-on-overflow is reproduced by the
    float64 -> int64 -> int32 cast chain (modulo 2^32)."""
    d = d_int.astype(np.float64)
    y = rescaled_i32.astype(np.float64)
    t1f = np.matmul(d.T, y)                               # D_i^T @ Y
    t1 = t1f.astype(np.int64).astype(np.int32)
    sh = EXACT_SHIFT - IDCT_GUARD
    t1 = (t1 + np.int32(1 << (sh - 1))) >> sh
    t2f = np.matmul(t1.astype(np.float64), d)
    x = t2f.astype(np.int64).astype(np.int32)
    return (x + np.int32(1 << (IDCT_GUARD - 1))) >> IDCT_GUARD


def idct2_exact(rescaled_i32: jnp.ndarray, d_int: jnp.ndarray) -> jnp.ndarray:
    """Integer-exact inverse: ``D^T Y D`` with the same fixed-point scheme.
    Input is the rescaled (q * Q) integer coefficients (|Y| <= ~2^13).
    Same exactness argument: products <= 2^28, true results <= 2^28."""
    x = idct2_exact_core(rescaled_i32, d_int)
    return x.astype(jnp.float32) / jnp.float32(1 << EXACT_SHIFT)


@lru_cache(maxsize=None)
def quant_matrices(bs: int, max_qp: int | None = None) -> np.ndarray:
    """``[n_qp, bs, bs]`` float32 stack of power-of-two quant matrices
    (reference dct.py:21-32): 2^qp under the anti-diagonal, 2^(qp+1) on it,
    2^(qp+2) above.  All values <= 2^13 — exact in float32."""
    if max_qp is None:
        max_qp = int(np.log2(bs)) + 7
    xy = np.add.outer(np.arange(bs), np.arange(bs))
    exp = np.where(xy < bs - 1, 0, np.where(xy == bs - 1, 1, 2))
    qps = np.arange(max_qp + 1)[:, None, None]
    return (2.0 ** (qps + exp[None])).astype(np.float32)


def dct2(blocks: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Batched 2D DCT-II: ``D @ X @ D.T`` over ``[..., bs, bs]``."""
    x = blocks.astype(jnp.float32)
    y = jnp.einsum("km,...mn->...kn", d, x, precision=_HIGHEST)
    return jnp.einsum("...kn,ln->...kl", y, d, precision=_HIGHEST)


def idct2(coeffs: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse: ``D.T @ Y @ D``."""
    y = coeffs.astype(jnp.float32)
    x = jnp.einsum("km,...kl->...ml", d, y, precision=_HIGHEST)  # D.T @ Y
    return jnp.einsum("...ml,ln->...mn", x, d, precision=_HIGHEST)  # ... @ D


def quantize(dct_coeffs: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """``round(dct / Q)`` — banker's rounding like np.round (dct.py:35-37).
    Division by a power of two is exact in float32."""
    return jnp.round(dct_coeffs / Q)


def rescale(qcoeffs: jnp.ndarray, Q: jnp.ndarray) -> jnp.ndarray:
    """``q * Q`` (dct.py:40-42); magnitudes stay < 2^14, exact in float32."""
    return qcoeffs.astype(jnp.float32) * Q


def transform_quantize(residual_blocks: jnp.ndarray, d: jnp.ndarray, Q: jnp.ndarray):
    """residual -> (quantized int16 coeffs, float32 coeffs). One fused call."""
    coeffs = dct2(residual_blocks, d)
    q = quantize(coeffs, Q)
    return q.astype(jnp.int16), q


def reconstruct(qcoeffs: jnp.ndarray, Q: jnp.ndarray, pred_blocks: jnp.ndarray, d: jnp.ndarray):
    """rescale -> IDCT -> + pred -> round -> clip -> uint8 (Frame.py:197-202).

    Returns ``(recon uint8, idct_residual float32)``.
    """
    idct_res = idct2(rescale(qcoeffs, Q), d)
    recon = jnp.round(idct_res + pred_blocks.astype(jnp.float32))
    recon = jnp.clip(recon, 0, 255).astype(jnp.uint8)
    return recon, idct_res


def forward_coeffs(residual_blocks: jnp.ndarray, bs: int, exact: bool) -> jnp.ndarray:
    """Mode dispatch: float32 matmul DCT (reference parity) or integer-exact."""
    if exact:
        return dct2_exact(residual_blocks.astype(jnp.int32), jnp.asarray(dct_matrix_int(bs)))
    return dct2(residual_blocks.astype(jnp.float32), jnp.asarray(dct_matrix(bs)))


def reconstruct_mode(qcoeffs, Q, pred_blocks, bs: int, exact: bool):
    """Mode dispatch for rescale->IDCT->+pred->round->clip."""
    if exact:
        rescaled = qcoeffs.astype(jnp.int32) * Q.astype(jnp.int32)
        idct_res = idct2_exact(rescaled, jnp.asarray(dct_matrix_int(bs)))
        recon = jnp.round(idct_res + pred_blocks.astype(jnp.float32))
        return jnp.clip(recon, 0, 255).astype(jnp.uint8), idct_res
    return reconstruct(qcoeffs.astype(jnp.float32), Q, pred_blocks, jnp.asarray(dct_matrix(bs)))


@partial(jax.jit, static_argnames=("bs", "qp"))
def encode_blocks(residual_blocks: jnp.ndarray, bs: int, qp: int):
    """Convenience jit: DCT + quantize a batch of blocks at a fixed QP."""
    d = jnp.asarray(dct_matrix(bs))
    Q = jnp.asarray(quant_matrices(bs))[qp]
    return transform_quantize(residual_blocks, d, Q)


@partial(jax.jit, static_argnames=("bs", "qp"))
def decode_blocks(qcoeffs: jnp.ndarray, pred_blocks: jnp.ndarray, bs: int, qp: int):
    """Convenience jit: rescale + IDCT + reconstruct at a fixed QP."""
    d = jnp.asarray(dct_matrix(bs))
    Q = jnp.asarray(quant_matrices(bs))[qp]
    return reconstruct(qcoeffs, Q, pred_blocks, d)
