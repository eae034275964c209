"""Integer-exact transform mode: cross-backend bit-exact streams.

The float reference cannot guarantee identical bitstreams across float
implementations (PARITY.md); with ``exact_transform=True`` the DCT/IDCT run
as integer matmuls (deterministic everywhere), so golden (NumPy) and the device
pipeline must produce IDENTICAL artifacts even at QP 0 — precisely where the
float paths diverge.
"""

import filecmp
import logging

import numpy as np
import pytest

from basic_video_codec_tpu.config import EncoderConfig, InputParameters
from basic_video_codec_tpu.golden.decoder import decode_video as golden_decode
from basic_video_codec_tpu.golden.encoder import encode_video as golden_encode
from basic_video_codec_tpu.io.fileio import FileIOHelper
from basic_video_codec_tpu.models.pipeline import decode_video as dev_decode
from basic_video_codec_tpu.models.pipeline import encode_video as dev_encode
from basic_video_codec_tpu.tools import ygen

logging.getLogger().setLevel(logging.ERROR)

W, H, N = 64, 48, 5


def _run(tmp_path, sub, enc, dec, **cfg):
    base = dict(block_size=8, search_range=2, I_Period=4, quantization_factor=0,
                resolution=(W, H), exact_transform=True)
    base.update(cfg)
    d = tmp_path / sub
    d.mkdir(parents=True, exist_ok=True)
    ygen.write_y_file(str(d / "t.y"), ygen.moving_sequence(W, H, N, seed=11))
    params = InputParameters(str(d / "t.y"), W, H, EncoderConfig(**base), N)
    enc(params, results_csv_path=None)
    dec(params)
    return FileIOHelper(params, create_dirs=False)


@pytest.mark.parametrize("cfg", [
    dict(),                               # QP 0: float mode diverges, exact must not
    dict(quantization_factor=3, fastME=True),
    dict(quantization_factor=2, fracMeEnabled=True),
    dict(I_Period=1, quantization_factor=0),
])
def test_exact_mode_bit_identical_across_backends(tmp_path, cfg):
    iog = _run(tmp_path, "g", golden_encode, golden_decode, **cfg)
    iot = _run(tmp_path, "t", dev_encode, dev_decode, **cfg)
    for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                "get_mc_decoded_file_name", "get_quant_dct_coff_fh_file_name"):
        assert filecmp.cmp(getattr(iog, get)(), getattr(iot, get)(), shallow=False), get
    # and the codec invariant holds
    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt)


def test_exact_mode_quality_matches_float_mode(tmp_path):
    """The fixed-point basis costs nothing measurable in RD terms."""
    import os

    results = {}
    for name, exact in (("float", False), ("exact", True)):
        d = tmp_path / name
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), ygen.moving_sequence(W, H, N, seed=11))
        ec = EncoderConfig(8, 2, 4, 3, resolution=(W, H), exact_transform=exact)
        params = InputParameters(str(d / "t.y"), W, H, ec, N)
        dev_encode(params, results_csv_path=None)
        io = FileIOHelper(params, create_dirs=False)
        rec = np.fromfile(io.get_mc_reconstructed_file_name(), np.uint8).astype(np.float64)
        src = ygen.moving_sequence(W, H, N, seed=11).ravel()
        results[name] = (
            10 * np.log10(255 ** 2 / np.mean((rec - src) ** 2)),
            os.path.getsize(io.get_encoded_file_name()),
        )
    psnr_f, bytes_f = results["float"]
    psnr_e, bytes_e = results["exact"]
    assert abs(psnr_f - psnr_e) < 0.05
    assert abs(bytes_f - bytes_e) / bytes_f < 0.01
