"""ctypes bindings for the native entropy codec (basic_video_codec_tpu/native/entropy.cc).

Loads ``libbvc_entropy-<hash>.so``, building it with g++ on first use
(no external packaging).  The library is never committed: its name carries
a hash of the source, so it is rebuilt exactly when it is missing or the
source changed.  All entry points have pure-NumPy fallbacks — the
pipeline calls through :func:`encode_symbols_bytes` /
:func:`decode_symbols_np` / :func:`decode_dct_scans` and gets the native
path automatically when available.
"""

import ctypes
import hashlib
import os
import subprocess

import numpy as np

from ..utils.logger import get_logger

logger = get_logger()

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SRC_PATH = os.path.join(_NATIVE_DIR, "entropy.cc")

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_build())
        lib.bvc_encode_symbols.restype = ctypes.c_int64
        lib.bvc_encode_symbols.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_decode_symbols.restype = ctypes.c_int64
        lib.bvc_decode_symbols.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_decode_dct_blocks.restype = ctypes.c_int64
        lib.bvc_decode_dct_blocks.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.bvc_decode_dct_plane.restype = ctypes.c_int64
        lib.bvc_decode_dct_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.bvc_encode_dct_plane.restype = ctypes.c_int64
        lib.bvc_encode_dct_plane.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_format_mv_lines.restype = ctypes.c_int64
        lib.bvc_format_mv_lines.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        for name in ("bvc_unpack_qdct", "bvc_joint_states",
                     "bvc_apply_joint", "bvc_pred_inter",
                     "bvc_intra_rebuild", "bvc_wrap_diff",
                     "bvc_joint_decode2", "bvc_intra_art",
                     "bvc_rebuild_p"):
            getattr(lib, name).restype = None
        lib.bvc_unpack_qdct.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_joint_states.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
        lib.bvc_apply_joint.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64]
        lib.bvc_pred_inter.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.bvc_intra_rebuild.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.bvc_wrap_diff.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_joint_decode2.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.bvc_x_art.restype = None
        lib.bvc_x_art.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.bvc_recon_joint.restype = None
        lib.bvc_recon_joint.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.bvc_sse.restype = ctypes.c_int64
        lib.bvc_sse.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_pack_input.restype = ctypes.c_int64
        lib.bvc_pack_input.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.bvc_intra_art.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.bvc_rebuild_p.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        assert lib.bvc_version() == 10
        _lib = lib
    except Exception as e:  # missing compiler, load failure -> NumPy fallback
        logger.warning(f"native entropy codec unavailable ({e}); using NumPy fallback")
        _lib = None
    return _lib


def library_path() -> str:
    """Where the library built from the current source lives."""
    with open(_SRC_PATH, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, f"libbvc_entropy-{digest}.so")


def _build() -> str:
    so_path = library_path()
    if os.path.exists(so_path):
        return so_path
    # -march=native: the .so is always built on the machine that runs it,
    # so target the local SIMD set (the block-IDCT lanes vectorize 4-8x
    # with AVX2); falls back without the flag for compilers/platforms that
    # reject it.  Built under a temporary name and renamed into place, so
    # concurrent processes never load a half-written library.
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-fPIC", "-shared",
           "-std=c++17", "-o", tmp, _SRC_PATH]
    try:
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def available() -> bool:
    return _load() is not None


def encode_symbols_bytes(symbols: np.ndarray):
    """Symbols -> (packed bytes, bit length).  Native fast path with
    vectorized-NumPy fallback."""
    symbols = np.ascontiguousarray(symbols, dtype=np.int64)
    lib = _load()
    if lib is not None and symbols.size:
        # worst-case codeword here is ~63 bits; size the buffer generously
        cap = symbols.size * 8 + 64
        out = np.zeros(cap, dtype=np.uint8)
        nbits = lib.bvc_encode_symbols(
            symbols.ctypes.data, symbols.size, out.ctypes.data, cap)
        if nbits >= 0:
            return out[: (nbits + 7) // 8].tobytes(), int(nbits)
    from .expgolomb import symbols_to_bits

    bits = symbols_to_bits(symbols)
    return np.packbits(bits).tobytes(), int(bits.shape[0])


def decode_symbols_np(data: bytes, max_symbols: int) -> np.ndarray:
    """Packed bytes -> up to ``max_symbols`` decoded symbols (int64)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    lib = _load()
    if lib is not None:
        out = np.zeros(max_symbols, dtype=np.int64)
        n = lib.bvc_decode_symbols(
            buf.ctypes.data, buf.size * 8, out.ctypes.data, max_symbols)
        return out[:n]
    from .expgolomb import decode_symbols

    syms, _ = decode_symbols(np.unpackbits(buf), max_symbols=max_symbols)
    return np.asarray(syms, dtype=np.int64)


def encode_dct_plane_bytes(qdct: np.ndarray, bs: int, zz: np.ndarray, eob: int):
    """int16 qdct plane -> (packed bytes, bit length): zigzag + RLE +
    exp-Golomb + per-block EOB in one native pass."""
    lib = _load()
    if lib is not None:
        q = np.ascontiguousarray(qdct, dtype=np.int16)
        h, w = q.shape
        zz64 = np.ascontiguousarray(zz, dtype=np.int64)
        cap = h * w * 4 + 1024  # worst case ~27 bits per coefficient
        out = np.zeros(cap, dtype=np.uint8)
        nbits = lib.bvc_encode_dct_plane(
            q.ctypes.data, h, w, bs, zz64.ctypes.data, eob, out.ctypes.data, cap)
        if nbits >= 0:
            return out[: (nbits + 7) // 8].tobytes(), int(nbits)
    from .rle import rle_encode_blocks

    h, w = qdct.shape
    nbr, nbc = h // bs, w // bs
    blocks = qdct.reshape(nbr, bs, nbc, bs).swapaxes(1, 2).reshape(nbr * nbc, bs * bs)
    return encode_symbols_bytes(rle_encode_blocks(blocks[:, zz].astype(np.int64), eob))


def format_mv_lines(mvs: np.ndarray, bs: int) -> str:
    """mv.txt line for one frame (x-major order, reference file_io.py:65-70)."""
    lib = _load()
    nbr, nbc = mvs.shape[:2]
    if lib is not None:
        m = np.ascontiguousarray(mvs, dtype=np.int32)
        cap = nbr * nbc * 64 + 16
        out = np.zeros(cap, dtype=np.uint8)
        n = lib.bvc_format_mv_lines(m.ctypes.data, nbr, nbc, bs, out.ctypes.data, cap)
        if n >= 0:
            return out[:n].tobytes().decode("ascii")
    cols = mvs.transpose(1, 0, 2).tolist()
    parts = []
    for j, col in enumerate(cols):
        x = j * bs
        parts.extend(f"{x},{i * bs}:{v[0]},{v[1]}|" for i, v in enumerate(col))
    return "".join(parts) + "\n"


def pack_input_frames(frames: np.ndarray, cap: int) -> np.ndarray | None:
    """[K, H, W] u8 -> ONE uint8 upload buffer (nibble deltas + escape
    lists, layout consumed by ops/pack.unpack_input_chunk), or None when
    the native packer is unavailable / any frame's escape count exceeds
    ``cap`` (the caller then uploads the chunk raw).

    The left-predictor nibble stream halves the raw input frames on
    typical content (~1.4% escapes on the bench fixture)."""
    lib = _load()
    if lib is None:
        return None
    k, h, w = frames.shape
    if (h * w) % 2:
        return None
    nibs = np.empty((k, h * w // 2), np.uint8)
    escs = np.zeros((k, cap), np.int16)
    fr = np.ascontiguousarray(frames, np.uint8)
    for i in range(k):
        ne = lib.bvc_pack_input(
            fr[i].ctypes.data, h, w, nibs[i].ctypes.data,
            escs[i].ctypes.data, cap)
        if ne > cap:
            return None
    return np.concatenate([nibs.reshape(-1), escs.view(np.uint8).reshape(-1)])


def decode_dct_plane(data: np.ndarray, nbits: int, h: int, w: int, bs: int,
                     zz: np.ndarray, eob: int) -> np.ndarray:
    """Devbits dct bitstream bytes -> int16 qdct plane (exp-Golomb + RLE
    expansion + inverse zigzag in one native pass).  ``data`` is a uint8
    array of at least ``ceil(nbits/8)`` bytes."""
    buf = np.ascontiguousarray(data, np.uint8)
    lib = _load()
    if lib is not None:
        out = np.zeros((h, w), np.int16)
        lib.bvc_decode_dct_plane(
            buf.ctypes.data, nbits, h, w, bs,
            np.ascontiguousarray(zz, np.int64).ctypes.data, eob,
            out.ctypes.data)
        return out
    nbr, nbc = h // bs, w // bs
    scans = decode_dct_scans(buf.tobytes(), nbr * nbc, bs * bs, eob)
    blocks = np.zeros((nbr * nbc, bs * bs), np.int16)
    blocks[:, np.asarray(zz, np.int64)] = scans.astype(np.int16)
    return (blocks.reshape(nbr, nbc, bs, bs).swapaxes(1, 2)
            .reshape(h, w))


def decode_dct_scans(data: bytes, n_blocks: int, scan_len: int, eob: int) -> np.ndarray:
    """DCT payload -> ``[n_blocks, scan_len]`` int32 zigzag scans
    (exp-Golomb + RLE expansion in one native pass)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    lib = _load()
    out = np.zeros((n_blocks, scan_len), dtype=np.int32)
    if lib is not None:
        lib.bvc_decode_dct_blocks(
            buf.ctypes.data, buf.size * 8, out.ctypes.data, n_blocks, scan_len, eob)
        return out
    from .expgolomb import decode_symbols
    from .rle import rle_decode

    syms, _ = decode_symbols(np.unpackbits(buf))
    syms = np.asarray(syms, dtype=np.int64)
    ends = np.flatnonzero(syms == eob)
    starts = np.concatenate([[0], ends[:-1] + 1])
    for idx, (s, e) in enumerate(zip(starts, ends)):
        if idx >= n_blocks:
            break
        coffs = rle_decode(syms[s:e].tolist())[:scan_len]
        out[idx, : len(coffs)] = coffs
    return out
