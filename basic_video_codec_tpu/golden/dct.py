"""Golden transform/quantization stage (reference encoder/dct.py semantics).

The reference computes a separable float32 DCT-II/III via
``scipy.fftpack.dct/idct(norm='ortho')`` (dct.py:9-18); the golden model calls
the same routine so its floats are bit-identical to the reference's.  The
device path (ops/transform.py) computes the same transform as float32 matmuls —
see there for the equivalence/tolerance discussion.
"""

import numpy as np
from scipy.fftpack import dct as _dct, idct as _idct


def apply_dct_2d(block: np.ndarray) -> np.ndarray:
    """Separable 2D DCT-II, float32 (reference dct.py:9-12)."""
    block = block.astype(np.float32)
    return _dct(_dct(block.T, norm="ortho").T, norm="ortho")


def apply_idct_2d(block: np.ndarray) -> np.ndarray:
    """Separable 2D inverse DCT, float32 (reference dct.py:15-18)."""
    block = block.astype(np.float32)
    return _idct(_idct(block.T, norm="ortho").T, norm="ortho")


def generate_quantization_matrix(i: int, qp: int) -> np.ndarray:
    """Power-of-two quant matrix (reference dct.py:21-32):
    ``2^qp`` below the anti-diagonal, ``2^(qp+1)`` on it, ``2^(qp+2)`` above."""
    xy = np.add.outer(np.arange(i), np.arange(i))
    Q = np.where(xy < i - 1, 2 ** qp, np.where(xy == i - 1, 2 ** (qp + 1), 2 ** (qp + 2)))
    return Q.astype(np.uint16)


def quantize_block(dct_block: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """``round(dct / Q)`` with banker's rounding (reference dct.py:35-37)."""
    return np.round(dct_block / Q)


def rescale_block(quantized_block: np.ndarray, Q: np.ndarray) -> np.ndarray:
    """``q * Q`` (reference dct.py:40-42)."""
    return quantized_block * Q


def apply_dct_and_quantization(residual_block: np.ndarray, block_size: int, qp: int,
                               exact: bool = False):
    """DCT -> quantize (reference Frame.py:190-194); optional integer-exact
    transform (see ops/transform.py — the NumPy twin below is bit-identical)."""
    coffs = apply_dct_2d_exact(residual_block) if exact else apply_dct_2d(residual_block)
    Q = generate_quantization_matrix(block_size, qp)
    return quantize_block(coffs, Q), Q


def reconstruct_block(quantized_dct_coffs, Q, predicted_block, exact: bool = False):
    """rescale -> IDCT -> +pred -> round -> clip to uint8
    (reference Frame.py:197-202)."""
    if exact:
        idct_residual = apply_idct_2d_exact(
            np.asarray(quantized_dct_coffs, dtype=np.int64) * Q.astype(np.int64))
    else:
        idct_residual = apply_idct_2d(rescale_block(quantized_dct_coffs, Q))
    recon = np.round(idct_residual + predicted_block).astype(np.int16)
    return np.clip(recon, 0, 255).astype(np.uint8), idct_residual


# --- integer-exact twin of the device transform (ops/transform.py) ---

EXACT_SHIFT = 13


def _dct_matrix_int(n: int) -> np.ndarray:
    k = np.arange(n)[:, None].astype(np.float64)
    m = np.arange(n)[None, :].astype(np.float64)
    d = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    d[0] *= np.sqrt(1.0 / n)
    d[1:] *= np.sqrt(2.0 / n)
    return np.round(d * (1 << EXACT_SHIFT)).astype(np.int64)


def _rshift_round(x: np.ndarray, s: int) -> np.ndarray:
    return (x + (1 << (s - 1))) >> s


def apply_dct_2d_exact(block) -> np.ndarray:
    """NumPy twin of ops/transform.dct2_exact — identical integers, so
    identical float32 coefficients on every backend."""
    d = _dct_matrix_int(np.asarray(block).shape[0])
    t1 = _rshift_round(d @ np.asarray(block, dtype=np.int64), EXACT_SHIFT - 2)
    y = (t1 @ d.T).astype(np.int32)
    return y.astype(np.float32) / np.float32(1 << (EXACT_SHIFT + 2))


IDCT_GUARD = 6  # mid-stage guard bits; MUST equal ops/transform.IDCT_GUARD


def apply_idct_2d_exact(rescaled_int) -> np.ndarray:
    d = _dct_matrix_int(np.asarray(rescaled_int).shape[0])
    t1 = _rshift_round(d.T @ np.asarray(rescaled_int, dtype=np.int64),
                       EXACT_SHIFT - IDCT_GUARD)
    x = _rshift_round((t1 @ d).astype(np.int64), IDCT_GUARD).astype(np.int32)
    return x.astype(np.float32) / np.float32(1 << EXACT_SHIFT)
