"""GOP-parallel encoding over the ``data`` mesh axis.

GOPs are independent by construction: every I-frame clears the reference
deques (reference encoder.py:174-186), so a video is a sequence of closed
GOPs and a batch of GOPs is embarrassingly parallel.  This module wraps the
*production* GOP program — ``models.chunk.encode_chunk``, the same compiled
scan the single-chip pipeline dispatches — in a ``shard_map`` that places
ONE GOP on each device of the mesh's ``data`` axis (no collectives inside a
step, so the axis could also span hosts).

The product path is :func:`gop_batch_fn`, used by
``models.pipeline.encode_video`` when ``EncoderConfig.parallel_gops > 1``:
each shard produces the exact same per-frame outputs (including the compact
packed transfer buffers, ops/pack.py) as the serial chunked dispatch, so
the resulting ``encoded.bin`` and artifact tree are byte-identical to a
single-device run — asserted in tests/test_parallel.py.

:func:`encode_gop` remains as a convenience single-GOP fixed-QP API (same
program underneath).
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models.chunk import (
    encode_chunk,
    encode_chunk_intra_only,
    encode_chunk_multiref,
)


from functools import lru_cache


@lru_cache(maxsize=None)
def gop_batch_fn(mesh, intra_only: bool, bs: int, search_range: int, rc1: bool,
                 fast: bool, frac: bool, exact: bool, compact: bool, int8q: bool,
                 n_ref: int = 1, mv8: bool = False, q4: bool = False,
                 packed_shape: tuple | None = None,
                 qfrac: tuple | None = None):
    """Build the sharded GOP-batch program: ONE GOP per device via
    ``shard_map``, each shard running the *identical* serial chunk program.

    One-GOP-per-shard (not a vmapped batch) is deliberate: a vmapped variant
    compiles different HLO whose float32 DCT can round +-1 differently from
    the serial program on edge coefficients — shard_map keeps the local
    computation textually identical, so the multi-device bitstream is
    byte-identical to the serial one.

    ``packed_shape=(K, H, W)`` marks the input as per-GOP packed
    nibble-delta upload buffers [G, NB] (entropy/native.pack_input_frames),
    expanded on each shard by ops/pack.unpack_input_chunk — the same
    compact-upload transport the serial pipeline uses."""
    from jax import shard_map

    in_spec = (P("data", None) if packed_shape is not None
               else P("data", None, None, None))

    def body(gops, row_qps, budget0, tbl_qps, tbl_bits, initial_qp):
        from ..ops import pack as PK

        if packed_shape is not None:
            local = PK.unpack_input_chunk(gops[0], *packed_shape)
        else:
            local = gops[0]  # [K, H, W]: exactly one GOP on this shard
        h, w = local.shape[1:]
        if intra_only:
            out = encode_chunk_intra_only(
                local, row_qps, budget0, tbl_qps, tbl_bits, initial_qp,
                bs, rc1, exact=exact, compact=compact, int8q=int8q, q4=q4,
                qfrac=qfrac,
            )
        elif n_ref > 1:
            # GOPs start intra, so each shard's rolling stack initializes
            # from scratch — no cross-shard reference state
            out = encode_chunk_multiref(
                local, jnp.zeros((n_ref, h, w), jnp.uint8),
                jnp.zeros((n_ref, 2 * h, 2 * w), jnp.uint8), jnp.int32(0),
                row_qps, budget0, tbl_qps, tbl_bits, initial_qp,
                bs, search_range, rc1, fast, frac, True,
                exact=exact, compact=compact, int8q=int8q, mv8=mv8, q4=q4,
                qfrac=qfrac,
            )
            # drop the stack/validity carries; normalize to encode_chunk's
            # (intra_out, p_out, ref, hp[, packed]) shape for the fetcher
            out = ((out[0], out[1], out[2], out[3], out[5]) if compact
                   else out[:4])
        else:
            out = encode_chunk(
                local, jnp.zeros((h, w), jnp.uint8),
                jnp.zeros((2 * h, 2 * w), jnp.uint8),
                row_qps, budget0, tbl_qps, tbl_bits, initial_qp,
                bs, search_range, rc1, fast, frac, True,
                exact=exact, compact=compact, int8q=int8q, mv8=mv8, q4=q4,
                qfrac=qfrac,
            )
        return jax.tree_util.tree_map(lambda x: x[None], out)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(in_spec, P(), P(), P(), P(), P()),
        out_specs=P("data"),
        check_vma=False,
    )
    return jax.jit(fn)


def shard_gops(mesh, gops_np):
    """Place a GOP batch ([G, K, H, W] raw frames or [G, NB] packed upload
    buffers) with G sharded over ``data``."""
    spec = P("data", *([None] * (gops_np.ndim - 1)))
    return jax.device_put(gops_np, NamedSharding(mesh, spec))


@partial(jax.jit, static_argnames=("bs", "search_range", "qp", "frac"))
def encode_gop(frames: jnp.ndarray, bs: int, search_range: int, qp: int, frac: bool):
    """Encode one GOP at fixed QP through the production chunk program:
    frames[0] intra, frames[1:] inter (single reference = previous
    reconstruction).  Returns ``(recon [T,H,W] u8, qdct [T,H,W] i16,
    mvs [T-1,nbr,nbc,3], frame_bits [T])`` — frame_bits are the exact
    device-priced entropy bits (prediction + DCT payloads)."""
    t, h, w = frames.shape
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    row_qps = jnp.full(nbr, qp, jnp.int32)
    tblq = jnp.zeros(1, jnp.int32)
    tblb = jnp.zeros(1, jnp.float32)
    intra_out, p_out, _, _ = encode_chunk(
        frames, jnp.zeros((h, w), jnp.uint8), jnp.zeros((2 * h, 2 * w), jnp.uint8),
        row_qps, jnp.float32(0), tblq, tblb, jnp.int32(qp),
        bs, search_range, False, False, frac, True,
    )
    recon_i, _, qdct_i, smalls_i = intra_out
    recons, _, qdcts, smalls = p_out
    recon_all = jnp.concatenate([recon_i[None], recons])
    qdct_all = jnp.concatenate([qdct_i[None], qdcts])
    mvs = smalls[:, : 3 * nb].reshape(-1, nbr, nbc, 3)
    bits_i = smalls_i[2 * nb + nbr :].sum()
    bits_p = smalls[:, 5 * nb + nbr :].sum(axis=1)
    return recon_all, qdct_all, mvs, jnp.concatenate([bits_i[None], bits_p])


def encode_gops_sharded(mesh, gops, bs: int, search_range: int, qp: int, frac: bool = False):
    """Batch of GOPs ``[B, T, H, W]`` sharded over the ``data`` axis; each
    device encodes its GOPs independently (vmap of :func:`encode_gop`)."""
    gops = shard_gops(mesh, gops)
    fn = jax.vmap(partial(encode_gop, bs=bs, search_range=search_range, qp=qp, frac=frac))
    return jax.jit(fn)(gops)
