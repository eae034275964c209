"""Public encode entry point — backend dispatch.

``encode_video(params)`` is the API-parity equivalent of reference
encoder/encoder.py:28.  The backend is selected by
``params.encoder_config.backend``:

* ``"device"`` / ``"auto"`` — the JAX device pipeline (models/pipeline.py):
  batched ME + matmul DCT on device, vectorized host entropy finalization.
* ``"golden"`` — the pure-NumPy reference-exact model (conformance oracle /
  CPU fallback).
"""

from .config import InputParameters
from .golden.encoder import encode_video as _golden_encode


def encode_video(params: InputParameters, results_csv_path: str | None = "results.csv"):
    backend = getattr(params.encoder_config, "backend", "auto")
    if backend == "golden":
        return _golden_encode(params, results_csv_path)
    from .models.pipeline import encode_video as _device_encode

    return _device_encode(params, results_csv_path)
