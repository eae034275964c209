"""Reference-exact pure-NumPy golden model.

This subpackage reproduces the observable behaviour of the reference encoder /
decoder (dheri/basic_video_codec) including its quirks — it is the conformance
oracle every device kernel and the full device pipeline are validated against,
and it doubles as a CPU fallback backend.

It is NOT the production path: the production encode/decode pipelines live in
``basic_video_codec_tpu.ops`` / ``models`` (JAX/XLA/Pallas).

Quirk inventory reproduced here (each cited at its implementation site):

* banker's rounding in quantize/reconstruct (reference encoder/dct.py:37,
  Frame.py:200)
* transposed intra predictors and uint8-wraparound mode decision
  (IFrame.py:184-213)
* ceil-mean half-pel interpolation with zeroed last row/col (block_predictor.py:145-177)
* full-search tie-breaks: first-seen minimum, then smaller |mvx|+|mvy|
  (block_predictor.py:88)
* fastME recursion seeded at MVP with origin-win termination and |mv|>=16 bound,
  including the late-binding lambda bug for nRefFrames > 1 (block_predictor.py:11-58)
* rate control always consults the 'I' row of the lookup table
  (Frame.py:169), tables have no QP 0 entry (RateControl/lookup.py:107),
  and the scene-change scaling factor is set on the first-pass frame but
  never reaches the second pass that would use it (encoder.py:94, Frame.py:48)
* artifact dtype wraps: I-frame residual plane stored uint8, P-frame residual
  planes int8 (IFrame.py:30, PFrame.py:39-40)
"""

from .encoder import encode_video as golden_encode_video
from .decoder import decode_video as golden_decode_video

__all__ = ["golden_encode_video", "golden_decode_video"]
