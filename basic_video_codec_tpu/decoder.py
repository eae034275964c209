"""Public decode entry point — backend dispatch (reference decoder.py:26)."""

from .config import InputParameters
from .golden.decoder import decode_video as _golden_decode


def decode_video(params: InputParameters):
    backend = getattr(params.encoder_config, "backend", "auto")
    if backend == "golden":
        return _golden_decode(params)
    from .models.pipeline import decode_video as _device_decode

    return _device_decode(params)
