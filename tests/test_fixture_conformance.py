"""Conformance on the checked-in high-entropy fixtures.

``tests/fixtures/grain_cut_qcif.y`` is 8 QCIF frames of film-grain-like
content (textured planes + gaussian grain, per-frame std ~44-48) with a hard
scene cut at frame 5 and opposite pans on each side — the stress case the
ygen synthetics under-exercise: dense nonzero coefficients at low QP (the
float-DCT edge), a genuine scene-change trigger, and noisy clipped pixels
for the compact-transfer escape paths.

``tests/fixtures/cam_cut_cif.y`` is 10 CIF frames with real-camera
statistics (tools/ygen.camera_sequence: multi-octave ≈1/f detail, subpixel
pan+zoom, luma-dependent sensor grain, hard cut at frame 6) — the stand-in
for the reference's unhydrated LFS sequences (foreman/e3 CIF, reference
results/rd_experiment_results.csv).  The CIF tests pin what the reference's
published numbers were measured on: golden<->device parity at the deliverable
shape class, transport cap overflow rate < 1%, and RC bit accuracy.
"""

import filecmp
import os

import numpy as np
import pytest

from basic_video_codec_tpu.config import EncoderConfig, InputParameters
from basic_video_codec_tpu.golden.decoder import decode_video as golden_decode
from basic_video_codec_tpu.golden.encoder import encode_video as golden_encode
from basic_video_codec_tpu.io.fileio import FileIOHelper
from basic_video_codec_tpu.models.pipeline import decode_video as dev_decode
from basic_video_codec_tpu.models.pipeline import encode_video as dev_encode

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "grain_cut_qcif.y")
W, H, N = 176, 144, 8


def _run(tmp_path, sub, enc, dec, **cfg):
    import shutil

    d = tmp_path / sub
    d.mkdir(parents=True, exist_ok=True)
    y = str(d / "grain.y")
    shutil.copy(FIXTURE, y)
    params = InputParameters(y, W, H, EncoderConfig(**cfg), frames_to_process=N)
    enc(params, results_csv_path=None)
    dec(params)
    return FileIOHelper(params, create_dirs=False)


@pytest.mark.parametrize("qp", [0, 4, 8])
def test_grain_parity_and_invariant(tmp_path, qp):
    """QP 0 on grain content maximizes nonzero coefficients and float-edge
    exposure: the device stream must stay inside the documented tolerance vs
    golden, decode must equal recon bit-for-bit, and compact-transfer
    escape/overflow paths must rebuild artifacts exactly."""
    cfg = dict(block_size=8, search_range=2, I_Period=4, quantization_factor=qp,
               resolution=(W, H))
    iog = _run(tmp_path, f"g{qp}", golden_encode, golden_decode, **cfg)
    iot = _run(tmp_path, f"t{qp}", dev_encode, dev_decode, **cfg)

    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt), "codec invariant on grain content"

    rg = np.fromfile(iog.get_mc_reconstructed_file_name(), np.uint8)
    src = np.fromfile(FIXTURE, np.uint8).astype(np.float64)
    psnr_g = 10 * np.log10(255 ** 2 / np.mean((rg.astype(np.float64) - src) ** 2))
    psnr_t = 10 * np.log10(255 ** 2 / np.mean((rt.astype(np.float64) - src) ** 2))
    assert abs(psnr_g - psnr_t) < 0.06, (psnr_g, psnr_t)
    bg = os.path.getsize(iog.get_encoded_file_name())
    bt = os.path.getsize(iot.get_encoded_file_name())
    assert abs(bg - bt) / bg < 0.005, (bg, bt)
    if qp >= 8:
        assert filecmp.cmp(iog.get_encoded_file_name(),
                           iot.get_encoded_file_name(), shallow=False)


def test_grain_exact_transform_byte_identical_qp0(tmp_path):
    """exact_transform at QP 0 on grain: the hardest bit-exactness case —
    every artifact byte must match the golden oracle."""
    cfg = dict(block_size=8, search_range=2, I_Period=4, quantization_factor=0,
               resolution=(W, H), exact_transform=True)
    iog = _run(tmp_path, "ge", golden_encode, golden_decode, **cfg)
    iot = _run(tmp_path, "te", dev_encode, dev_decode, **cfg)
    for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                "get_mc_decoded_file_name", "get_quant_dct_coff_fh_file_name",
                "get_residual_w_mc_file_name", "get_residual_wo_mc_file_name",
                "get_mv_file_name"):
        assert filecmp.cmp(getattr(iog, get)(), getattr(iot, get)(),
                           shallow=False), get


CAM = os.path.join(os.path.dirname(__file__), "fixtures", "cam_cut_cif.y")
Wc, Hc, Nc = 352, 288, 10


def _run_cam(tmp_path, sub, enc, dec=None, n=Nc, **cfg):
    import shutil

    d = tmp_path / sub
    d.mkdir(parents=True, exist_ok=True)
    y = str(d / "cam.y")
    shutil.copy(CAM, y)
    params = InputParameters(y, Wc, Hc, EncoderConfig(**cfg), frames_to_process=n)
    enc(params, results_csv_path=None)
    if dec is not None:
        dec(params)
    return FileIOHelper(params, create_dirs=False)


@pytest.mark.slow
def test_cam_cif_parity_deliverable_class(tmp_path):
    """CIF end-to-end golden parity at the deliverable shape class
    (chip_smoke.py validates it on the GPU) — RC3 + fastME + nRefFrames 2,
    block 16, 5 frames on camera-statistics content.  This is the layout
    class where slice bugs live (the round-1 nb-mis-slice was exactly a
    shape-class bug the small tests didn't reach)."""
    cfg = dict(block_size=16, search_range=4, I_Period=8,
               quantization_factor=6, RCflag=3, targetBR=2_400_000,
               fastME=True, nRefFrames=2, resolution=(Wc, Hc))
    iog = _run_cam(tmp_path, "g", golden_encode, golden_decode, n=5, **cfg)
    iot = _run_cam(tmp_path, "t", dev_encode, dev_decode, n=5, **cfg)

    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt), "codec invariant at CIF"

    # decision parity: identical per-frame modes and MV files
    assert filecmp.cmp(iog.get_mv_file_name(), iot.get_mv_file_name(),
                       shallow=False)
    rg = np.fromfile(iog.get_mc_reconstructed_file_name(), np.uint8)
    src = np.fromfile(CAM, np.uint8)[: Wc * Hc * 5].astype(np.float64)
    psnr_g = 10 * np.log10(255 ** 2 / np.mean((rg.astype(np.float64) - src) ** 2))
    psnr_t = 10 * np.log10(255 ** 2 / np.mean((rt.astype(np.float64) - src) ** 2))
    assert abs(psnr_g - psnr_t) < 0.06, (psnr_g, psnr_t)
    bg = os.path.getsize(iog.get_encoded_file_name())
    bt = os.path.getsize(iot.get_encoded_file_name())
    assert abs(bg - bt) / bg < 0.005, (bg, bt)


@pytest.mark.slow
@pytest.mark.parametrize("cfg", [
    dict(block_size=16, search_range=4, I_Period=8, quantization_factor=4,
         fastME=True),
    dict(block_size=8, search_range=2, I_Period=4, quantization_factor=2),
    dict(block_size=16, search_range=2, I_Period=8, quantization_factor=6,
         RCflag=3, targetBR=2_400_000, fastME=True),
], ids=["bs16_fast_qp4", "bs8_qp2", "rc3_deliverable"])
def test_cam_cif_transport_overflow_rate(tmp_path, cfg):
    """The compact-transfer cap classes (ops/pack.qcap_fraction) were sized
    on synthetic content; camera statistics must stay under a 1% overflow
    rate or the transport is mis-sized for exactly the content class the
    reference's numbers come from."""
    from basic_video_codec_tpu.models import pipeline

    _run_cam(tmp_path, "o", dev_encode, resolution=(Wc, Hc), **cfg)
    stats = pipeline.LAST_RUN_STATS
    assert stats["frames"] == Nc
    rate = stats["overflow_frames"] / stats["frames"]
    assert rate <= 0.01, f"overflow on {stats['overflow_frames']}/{Nc} frames"


@pytest.mark.slow
def test_cam_cif_rc_bit_accuracy(tmp_path):
    """RC3 at 2.4 Mbps on camera content: the encoded stream must land near
    the per-frame budget (the RC tables were fit on real sequences; this
    pins that the fit holds on camera statistics, not just synthetics)."""
    cfg = dict(block_size=16, search_range=2, I_Period=8,
               quantization_factor=6, RCflag=3, targetBR=2_400_000,
               resolution=(Wc, Hc), fastME=True)
    iot = _run_cam(tmp_path, "rc", dev_encode, **cfg)
    total_bits = os.path.getsize(iot.get_encoded_file_name()) * 8
    target = 2_400_000 / 30 * Nc  # frame budget x frames (RateControl.py:5-6)
    assert 0.5 < total_bits / target < 1.5, (total_bits, target)


def test_grain_scene_change_rc3(tmp_path):
    """RC3 on the fixture: the hard cut at frame 5 must overshoot the
    lookup expectation and re-encode as INTRA (reference encoder.py:89-98),
    with identical mode decisions on both backends."""
    cfg = dict(block_size=16, search_range=2, I_Period=8, quantization_factor=9,
               RCflag=3, targetBR=1_200_000, resolution=(W, H))
    iog = _run(tmp_path, "grc", golden_encode, golden_decode, **cfg)
    iot = _run(tmp_path, "trc", dev_encode, dev_decode, **cfg)

    def modes_of(path):
        with open(path, "rb") as f:
            data = f.read()
        out, pos = [], 0
        while pos < len(data):
            out.append(data[pos])
            plen = int.from_bytes(data[pos + 1 : pos + 3])
            dlen = int.from_bytes(data[pos + 3 + plen : pos + 6 + plen])
            pos += 6 + plen + dlen
        return out

    mg = modes_of(iog.get_encoded_file_name())
    mt = modes_of(iot.get_encoded_file_name())
    assert mg == mt
    assert mt[0] == 1 and mt[4] == 1, mt  # first frame I, cut frame re-encoded I
    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt)
