"""Run configuration — field-for-field API parity with the reference.

``EncoderConfig`` mirrors reference encoder/params.py:6-36 and
``InputParameters`` mirrors reference input_parameters.py:4-11 so that driver
code written against the reference works unchanged against this framework.

New knobs are keyword-only and default to the reference behaviour:

* ``backend``   — "auto" | "device" | "golden".  "golden" runs the pure-NumPy
  reference-exact model (the conformance oracle); "device" and "auto" (the
  default) both run the JAX pipeline on whatever device JAX selects — the
  GPU where one is present.  There is no automatic fallback to golden.
* ``exact_transform`` — opt-in integer-exact DCT/IDCT: streams become
  bit-identical across backends/hardware (the float reference cannot offer
  this); RD behaviour is indistinguishable (the fixed-point basis error is
  ~2^-13, far below the codec's own quantization).  Streams encoded with it
  must be decoded with it.
* ``strict_reference_crashes`` — when True, reproduce even the reference's
  hard crashes (e.g. an RCflag=0 multi-GOP run raises StatisticsError at
  reference IFrame.py:35 because the previous P-frame never populated
  rc_qp_per_row).  Default False: we seed the missing QP history with the
  config QP and keep encoding.
"""

import math

from .utils.logger import get_logger

logger = get_logger()

BACKENDS = ("auto", "device", "golden")


class EncoderConfig:
    """All encoder knobs (reference encoder/params.py:6-36)."""

    def __init__(
        self,
        block_size,
        search_range,
        I_Period,
        quantization_factor,
        nRefFrames=1,
        fastME=False,
        fracMeEnabled=False,
        RCflag=0,
        targetBR=0,
        resolution=(352, 288),
        *,
        backend="auto",
        exact_transform=False,
        strict_reference_crashes=False,
        parallel_gops=0,
    ):
        self.block_size = block_size
        self.search_range = search_range
        self.quantization_factor = quantization_factor
        self.I_Period = I_Period
        self.residual_approx_factor = 0
        self.nRefFrames = nRefFrames
        self.fastME = fastME
        self.fracMeEnabled = fracMeEnabled
        self.RCflag = RCflag
        self.rc_lookup_table = None
        self.targetBR = targetBR
        self.resolution = resolution
        self.frame_rate = 30
        self.backend = backend
        self.exact_transform = exact_transform
        self.strict_reference_crashes = strict_reference_crashes
        # > 1: encode this many GOPs concurrently, sharded over the device
        # mesh's data axis (parallel/gop.py).  Output artifacts are
        # byte-identical to a serial run.  Requires RCflag <= 1 (RC 2/3
        # carry the previous frame's average QP across GOP boundaries, a
        # serial dependence); all other features, including nRefFrames > 1,
        # are supported.  Ignored (with a warning) when ineligible.
        self.parallel_gops = parallel_gops
        self.validate()

    def validate(self):
        """Constraint checks (reference encoder/params.py:28-36).

        * QP must satisfy ``qp <= log2(block_size) + 7``.
        * Rate control needs a non-zero target bitrate.
        * fastME forces ``search_range = -1`` (sentinel used in artifact
          names and the results log, reference params.py:34-35).
        """
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r} is not one of {BACKENDS}")
        if self.quantization_factor > (math.log2(self.block_size) + 7):
            raise ValueError(
                f" qp [{self.quantization_factor}] > {math.log2(self.block_size) + 7}"
            )
        if self.RCflag:
            if self.targetBR == 0:
                raise ValueError("Target Bit Rate is 0 when Rate Control is On")
        if self.fastME:
            self.search_range = -1
        return self


class InputParameters:
    """Descriptor of one encode/decode run (reference input_parameters.py:4-11)."""

    def __init__(
        self,
        y_only_file,
        width,
        height,
        encoder_config: EncoderConfig,
        frames_to_process=12,
        yuv_file=None,
    ):
        self.yuv_file = yuv_file
        self.y_only_file = y_only_file
        self.width = width
        self.height = height
        self.frames_to_process = frames_to_process
        self.encoder_config = encoder_config
