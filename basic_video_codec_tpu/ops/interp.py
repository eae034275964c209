"""Device half-pel interpolation: one batched stencil.

Replaces the reference's per-pixel Python loop
(encoder/block_predictor.py:145-177) — the single biggest fixed cost of its
frame loop — with whole-frame pair means assembled by interleave-reshape
(stack + reshape), which XLA lowers to cheap copies instead of strided
``.at[::2]`` scatters.

Semantics preserved exactly:

* even/even positions hold the original samples,
* odd positions hold the **ceil** of the 2- or 4-neighbour mean
  (integer forms ``(a+b+1)//2`` / ``(a+b+c+d+3)//4``),
* the last interpolated column/row (no right/bottom neighbour) stays 0.
"""

import jax
import jax.numpy as jnp


@jax.jit
def build_half_pel(frame: jnp.ndarray) -> jnp.ndarray:
    """uint8 [H, W] -> uint8 [2H, 2W] half-pel buffer (ceil semantics)."""
    f = frame.astype(jnp.int32)
    h, w = f.shape
    zcol = jnp.zeros((h, 1), jnp.int32)
    zrow = jnp.zeros((1, w), jnp.int32)

    horiz = jnp.concatenate([(f[:, :-1] + f[:, 1:] + 1) // 2, zcol], axis=1)
    vert = jnp.concatenate([(f[:-1, :] + f[1:, :] + 1) // 2, zrow], axis=0)
    diag_core = (f[:-1, :-1] + f[:-1, 1:] + f[1:, :-1] + f[1:, 1:] + 3) // 4
    diag = jnp.concatenate(
        [jnp.concatenate([diag_core, zcol[:-1]], axis=1), zrow], axis=0
    )

    even_rows = jnp.stack([f, horiz], axis=2).reshape(h, 2 * w)
    odd_rows = jnp.stack([vert, diag], axis=2).reshape(h, 2 * w)
    out = jnp.stack([even_rows, odd_rows], axis=1).reshape(2 * h, 2 * w)
    return out.astype(jnp.uint8)


def build_half_pel_batch(frames: jnp.ndarray) -> jnp.ndarray:
    """[N, H, W] -> [N, 2H, 2W] (vmapped stencil)."""
    return jax.vmap(build_half_pel)(frames)
