"""Array-level frame helpers.

Unlike the reference (common.py:50-93), which shuttles Python *lists* of blocks
around, the device design keeps a frame's blocks as one contiguous
``[n_rows, n_cols, bs, bs]`` (or flattened ``[n_blocks, bs, bs]``) tensor so
device kernels can vmap over them.  List-based ``split_into_blocks`` /
``merge_blocks`` are kept for the host-side entropy layer, where raster order
matters (reference common.py:50-59, 62-93).
"""

import os

import numpy as np

from .logger import get_logger

logger = get_logger()


def calculate_num_frames(file_path: str, width: int, height: int) -> int:
    """Frame count of a YUV420 file from its size (reference common.py:16-19)."""
    file_size = os.path.getsize(file_path)
    frame_size = width * height + 2 * (width // 2) * (height // 2)
    return file_size // frame_size


def padded_dims(width: int, height: int, block_size: int) -> tuple[int, int]:
    """(width, height) rounded up to block multiples — the dimensions every
    plane actually has after :func:`pad_frame`.  The reference sizes its
    entropy row structure from the *configured* resolution while its blocks
    come from the padded frame (IFrame.py:123 vs encoder.py:83), which breaks
    non-multiple resolutions; this framework consistently uses padded dims
    (documented divergence, PARITY.md)."""
    return (
        width + (block_size - width % block_size) % block_size,
        height + (block_size - height % block_size) % block_size,
    )


def pad_frame(frame: np.ndarray, block_size: int, pad_value: int = 128) -> np.ndarray:
    """Pad bottom/right to a block multiple with ``pad_value`` (reference common.py:22-32)."""
    height, width = frame.shape
    pad_h = (block_size - (height % block_size)) % block_size
    pad_w = (block_size - (width % block_size)) % block_size
    if pad_h or pad_w:
        logger.warning(f"frame is padded [{pad_h} , {pad_w}]")
        padded = np.full((height + pad_h, width + pad_w), pad_value, dtype=np.uint8)
        padded[:height, :width] = frame
        return padded
    return frame


def split_into_blocks(nd_array: np.ndarray, block_size: int) -> list:
    """Raster-order list of ``bs x bs`` views (reference common.py:50-59)."""
    height, width = nd_array.shape
    return [
        nd_array[y : y + block_size, x : x + block_size]
        for y in range(0, height, block_size)
        for x in range(0, width, block_size)
    ]


def merge_blocks(blocks, block_size: int, frame_shape) -> np.ndarray:
    """Merge raster-order blocks into one int frame (reference common.py:62-93).

    Keeps the reference's dtype choice (platform ``int``) because decoded
    quantized-DCT planes flow through here.
    """
    num_cols = frame_shape[1] // block_size
    frame = np.zeros(shape=frame_shape, dtype=int)
    for idx, block in enumerate(blocks):
        r = (idx // num_cols) * block_size
        c = (idx % num_cols) * block_size
        frame[r : r + block_size, c : c + block_size] = block
    return frame


def frame_to_blocks(frame: np.ndarray, block_size: int) -> np.ndarray:
    """``[H, W] -> [n_rows, n_cols, bs, bs]`` zero-copy-ish reshape (device layout)."""
    h, w = frame.shape
    return (
        frame.reshape(h // block_size, block_size, w // block_size, block_size)
        .swapaxes(1, 2)
    )


def blocks_to_frame(blocks: np.ndarray) -> np.ndarray:
    """Inverse of :func:`frame_to_blocks`: ``[n_rows, n_cols, bs, bs] -> [H, W]``."""
    n_rows, n_cols, bs, _ = blocks.shape
    return blocks.swapaxes(1, 2).reshape(n_rows * bs, n_cols * bs)


def mae(block1: np.ndarray, block2: np.ndarray) -> float:
    """Mean absolute error, reference semantics (common.py:43-45).

    NOTE: inherits the caller's dtypes — uint8 inputs wrap around exactly like
    the reference's intra-mode decision (reference IFrame.py:189-190).
    """
    return np.mean(np.abs(block1 - block2))


def psnr(im_true: np.ndarray, im_test: np.ndarray, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio, matching skimage's formula.

    The reference uses ``skimage.metrics.peak_signal_noise_ratio`` on uint8
    frames (encoder/encoder.py:123, decoder.py:76), which is
    ``10*log10(255^2 / mse)`` with the MSE in float64.
    """
    if (im_true.dtype == np.uint8 and im_test.dtype == np.uint8
            and im_true.shape == im_test.shape):
        from ..entropy import native

        lib = native._load()
        if lib is not None:
            a = np.ascontiguousarray(im_true)
            b = np.ascontiguousarray(im_test)
            # integer SSE / n in float64 is bit-identical to the NumPy mean
            # (the SSE is exact in float64 far beyond any frame size)
            err = lib.bvc_sse(a.ctypes.data, b.ctypes.data, a.size) / a.size
            if err == 0:
                return float("inf")
            return float(10.0 * np.log10((data_range ** 2) / err))
    err = np.mean(
        (im_true.astype(np.float64) - im_test.astype(np.float64)) ** 2
    )
    if err == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / err))


def pad_with_zeros(array: list, desired_length: int) -> list:
    """Extend a list with zeros to ``desired_length`` (reference common.py:129-143)."""
    if len(array) < desired_length:
        array.extend([0] * (desired_length - len(array)))
    return array


def signed_to_unsigned(value: int, bits: int) -> int:
    """Two's-complement encode (reference common.py:96-100)."""
    return (1 << bits) + value if value < 0 else value


def unsigned_to_signed(value: int, bits: int) -> int:
    """Two's-complement decode (reference common.py:103-107)."""
    return value - (1 << bits) if value >= (1 << (bits - 1)) else value


def int_to_3_bytes(value: int) -> bytes:
    """24-bit big-endian length field (reference common.py:110-118; the
    bitstream framing's DCT-payload length, encoder.py:117)."""
    return value.to_bytes(3, "big")


def bytes_to_int_3(three_bytes: bytes) -> int:
    """Inverse of :func:`int_to_3_bytes` (reference common.py:121-126)."""
    return int.from_bytes(three_bytes[:3], "big")
