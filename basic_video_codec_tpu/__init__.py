"""basic_video_codec_tpu — a JAX (XLA/Pallas) block video codec framework for the GPU.

A from-scratch rebuild of the capabilities of the educational H.264-style codec
``dheri/basic_video_codec``, designed for an accelerator:

* full-search SAD motion estimation scores every candidate MV of every block of a
  frame in one batched device program instead of the reference's per-macroblock
  Python loops (reference: encoder/block_predictor.py:61-91); the serial fastME
  walk runs as one Pallas kernel per frame on the GPU,
* 2D DCT/IDCT run as batched matmuls ``D @ X @ D.T`` over all blocks
  (reference: encoder/dct.py:9-18),
* quantize / rescale / reconstruct / clip are fused element-wise device ops
  (reference: encoder/dct.py:35-42, encoder/Frame.py:197-202),
* half-pel interpolation is a one-shot batched stencil
  (reference: encoder/block_predictor.py:145-177),
* entropy coding (zigzag / RLE / exp-Golomb) is a thin host-side finalization over
  device-produced integer streams, with exact closed-form bit lengths computed on
  device for rate control (reference: encoder/entropy_encoder.py),
* multi-device scaling shards independent GOPs / sweep configs over a
  ``jax.sharding.Mesh`` and splits frames spatially with halo exchange
  (the reference is single-threaded Python and has no parallelism).

The public API mirrors the reference field-for-field (``EncoderConfig``,
``InputParameters``, ``encode_video``, ``decode_video``) and the on-disk artifact
tree and bitstream format are byte-compatible (reference: file_io.py,
encoder/encoder.py:104-121).

A pure-NumPy *golden model* (``basic_video_codec_tpu.golden``) reproduces the
reference's observable behaviour — including its quirks — and is the conformance
oracle for the device kernels.
"""

from .config import EncoderConfig, InputParameters
from .encoder import encode_video
from .decoder import decode_video

__version__ = "0.1.0"

__all__ = [
    "EncoderConfig",
    "InputParameters",
    "encode_video",
    "decode_video",
    "__version__",
]
