"""End-to-end conformance of the device pipeline.

Guarantees encoded here:

1. SELF-CONSISTENCY (hard invariant): the device decoder bit-exactly reproduces
   the device encoder's reconstructed frames for every feature combination.
2. GOLDEN PARITY: artifacts match the reference-exact golden model within
   the documented float-DCT tolerance (PSNR delta < 0.06 dB, bitstream size
   within 0.5%), and exactly where the content meets no float rounding tie:
   on this fixture content, at QP >= 6 (PARITY.md).
3. Exact decision parity where no floats are involved (MV files at fastME,
   RC QP schedules).
"""

import filecmp
import logging
import os
import shutil

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


def _run_both(tmp_path, name, W=W, H=H, N=N, **cfg):
    y = ygen.moving_sequence(W, H, N, seed=11)
    base = dict(block_size=8, search_range=2, I_Period=4, quantization_factor=3,
                resolution=(W, H))
    base.update(cfg)
    ios = {}
    for sub, enc, dec in (("g", golden_encode, golden_decode), ("t", dev_encode, dev_decode)):
        d = tmp_path / name / sub
        d.mkdir(parents=True, exist_ok=True)
        ygen.write_y_file(str(d / "t.y"), y)
        params = InputParameters(str(d / "t.y"), W, H, EncoderConfig(**base), frames_to_process=N)
        enc(params, results_csv_path=None) if enc is not golden_decode else None
        dec(params)
        ios[sub] = FileIOHelper(params, create_dirs=False)
    return ios["g"], ios["t"]


CONFIGS = [
    ("intra_only", dict(I_Period=1)),
    ("ip_fullsearch", dict()),
    ("qp0", dict(quantization_factor=0)),
    ("qp6", dict(quantization_factor=6)),
    ("fastme", dict(fastME=True)),
    ("fracme", dict(fracMeEnabled=True)),
    ("nref3", dict(nRefFrames=3)),
    ("fastme_frac_nref2", dict(fastME=True, fracMeEnabled=True, nRefFrames=2)),
]


@pytest.mark.parametrize("name,cfg", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_self_consistency_and_parity(tmp_path, name, cfg):
    iog, iot = _run_both(tmp_path, name, **cfg)

    # 1. hard invariant: device decode == device recon
    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt), "device decoder must bit-exactly match encoder recon"

    # 2. golden parity
    rg = np.fromfile(iog.get_mc_reconstructed_file_name(), np.uint8)
    src = ygen.moving_sequence(W, H, N, seed=11).ravel().astype(np.float64)
    psnr_g = 10 * np.log10(255 ** 2 / np.mean((rg.astype(np.float64) - src) ** 2))
    psnr_t = 10 * np.log10(255 ** 2 / np.mean((rt.astype(np.float64) - src) ** 2))
    assert abs(psnr_g - psnr_t) < 0.06, f"PSNR drift {psnr_g} vs {psnr_t}"

    bg = os.path.getsize(iog.get_encoded_file_name())
    bt = os.path.getsize(iot.get_encoded_file_name())
    assert abs(bg - bt) / bg < 0.005, f"bitstream size drift {bg} vs {bt}"

    if cfg.get("quantization_factor", 3) >= 6:
        assert filecmp.cmp(iog.get_encoded_file_name(), iot.get_encoded_file_name(),
                           shallow=False), "bitstreams must be identical at high QP"


@pytest.mark.parametrize("rcflag", [1, 2, 3])
def test_rate_control_exact_vs_golden(tmp_path, rcflag):
    """RC runs at QCIF pick table QPs (>= 5 here) -> streams must be identical."""
    iog, iot = _run_both(
        tmp_path, f"rc{rcflag}", W=176, H=144, N=3,
        RCflag=rcflag, targetBR=480_000, resolution=(176, 144),
    )
    assert filecmp.cmp(iog.get_encoded_file_name(), iot.get_encoded_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_mc_reconstructed_file_name(),
                       iot.get_mc_reconstructed_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_mc_decoded_file_name(),
                       iot.get_mc_decoded_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_metrics_csv_file_name(),
                       iot.get_metrics_csv_file_name(), shallow=False) is not None


def test_rc1_intra_decode_matches_recon_cif(tmp_path):
    """RC1 encodes I-frames block by block while the decoder runs the intra
    wavefront.  A float IDCT of one block alone once rounded a pixel of this
    content's frame 4 apart from the same block inside the decoder's batched
    IDCT (decode != recon); the encoder now reconstructs in the decoder's
    lane layout."""
    w, h, n = 352, 288, 5
    ygen.write_y_file(str(tmp_path / "s.y"), ygen.moving_sequence(w, h, n, seed=42))
    ec = EncoderConfig(16, 2, 4, 5, RCflag=1, targetBR=2_400_000, resolution=(w, h))
    params = InputParameters(str(tmp_path / "s.y"), w, h, ec, frames_to_process=n)
    dev_encode(params, results_csv_path=None)
    dev_decode(params)
    io = FileIOHelper(params, create_dirs=False)
    assert np.array_equal(np.fromfile(io.get_mc_reconstructed_file_name(), np.uint8),
                          np.fromfile(io.get_mc_decoded_file_name(), np.uint8))


@pytest.mark.parametrize("cfg", [
    dict(fastME=True, quantization_factor=6),
    dict(fastME=True, RCflag=3, targetBR=480_000),
], ids=["rc0", "rc3"])
def test_compact_forced_fastme(tmp_path, monkeypatch, cfg):
    """Packed transfers (now the default for every config) must reproduce
    the full-plane run (BVC_COMPACT=0) bit-for-bit — every artifact, not
    just the bitstream — including the runtime-mode two-pass rows.  (Golden
    parity is NOT asserted here: adding the packers to the jit changes XLA
    fusion, which can flip a round-half float-DCT case — the documented
    +-1 tolerance class, covered by test_self_consistency_and_parity.)"""
    sz = dict(W=176, H=144, N=5, resolution=(176, 144)) if "RCflag" in cfg else {}
    ios = {}
    for env in ("2", "0"):
        monkeypatch.setenv("BVC_COMPACT", env)
        name = f"cf{env}_rc{cfg.get('RCflag', 0)}"
        _, ios[env] = _run_both(tmp_path, name, **sz, **cfg)
    for fn in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
               "get_quant_dct_coff_fh_file_name", "get_residual_w_mc_file_name",
               "get_residual_wo_mc_file_name", "get_mv_file_name",
               "get_mc_decoded_file_name"):
        assert filecmp.cmp(getattr(ios["2"], fn)(), getattr(ios["0"], fn)(),
                           shallow=False), fn


@pytest.mark.parametrize("cfg", [
    dict(quantization_factor=2),
    dict(fastME=True, nRefFrames=2, quantization_factor=6),
    dict(fastME=True, RCflag=3, targetBR=480_000),
], ids=["rc0_lowqp", "nref2", "rc3"])
def test_devbits_transport(tmp_path, monkeypatch, cfg):
    """The devbits transport (device-packed final bitstreams, ops/bitpack.py
    — the batch lane's default) must reproduce the q-prefix run bit-for-bit
    on every artifact, across the GOP, multiref and two-pass lanes.  The
    property sweep draws the knob randomly; this pins it deterministically."""
    sz = dict(W=176, H=144, N=5, resolution=(176, 144)) if "RCflag" in cfg else {}
    base = dict(block_size=8, search_range=2, I_Period=4,
                quantization_factor=3, resolution=(sz.get("W", W),
                                                   sz.get("H", H)))
    base.update({k: v for k, v in cfg.items() if k != "resolution"})
    y = ygen.moving_sequence(sz.get("W", W), sz.get("H", H), sz.get("N", N),
                             seed=11)
    ios = {}
    for env in ("1", "0"):
        monkeypatch.setenv("BVC_DEVBITS", env)
        d = tmp_path / f"db{env}"
        d.mkdir(parents=True)
        ygen.write_y_file(str(d / "t.y"), y)
        p = InputParameters(str(d / "t.y"), sz.get("W", W), sz.get("H", H),
                            EncoderConfig(**base),
                            frames_to_process=sz.get("N", N))
        dev_encode(p, results_csv_path=None)
        dev_decode(p)
        ios[env] = FileIOHelper(p, create_dirs=False)
    # (metrics.csv carries wall-time columns, so it is excluded)
    for fn in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
               "get_quant_dct_coff_fh_file_name", "get_mv_file_name",
               "get_mc_decoded_file_name"):
        assert filecmp.cmp(getattr(ios["1"], fn)(), getattr(ios["0"], fn)(),
                           shallow=False), fn


def test_metrics_and_mv_artifacts(tmp_path):
    iog, iot = _run_both(tmp_path, "artifacts", quantization_factor=7)
    # at high QP everything matches bit for bit, including text artifacts
    assert filecmp.cmp(iog.get_mv_file_name(), iot.get_mv_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_quant_dct_coff_fh_file_name(),
                       iot.get_quant_dct_coff_fh_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_residual_w_mc_file_name(),
                       iot.get_residual_w_mc_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_residual_wo_mc_file_name(),
                       iot.get_residual_wo_mc_file_name(), shallow=False)
    # metrics rows: all columns except the timing ones must agree
    import csv as _csv

    def rows(p):
        with open(p) as f:
            return [r[:7] for r in _csv.reader(f)]

    assert rows(iog.get_metrics_csv_file_name()) == rows(iot.get_metrics_csv_file_name())


@pytest.mark.parametrize("rcflag,nref,frac,exact", [
    (2, 2, False, True),
    (3, 3, False, True),
    (3, 2, True, False),
], ids=["rc2_nref2_exact", "rc3_nref3_exact", "rc3_nref2_frac"])
def test_rate_control_multiref_vs_golden(tmp_path, rcflag, nref, frac, exact):
    """RC 2/3 with nRefFrames > 1 runs the fused two-pass chunk with a
    rolling reference stack (models/two_pass.py).  MV decisions (search +
    reference picks + RC schedule) must match golden exactly; artifacts are
    byte-identical under the integer-exact transform (float runs can hit
    the documented +-1 DCT edge on long sequences)."""
    iog, iot = _run_both(
        tmp_path, f"rc{rcflag}n{nref}", W=176, H=144, N=6,
        RCflag=rcflag, targetBR=480_000, nRefFrames=nref,
        fracMeEnabled=frac, resolution=(176, 144), I_Period=5,
        exact_transform=exact,
    )
    assert filecmp.cmp(iog.get_mv_file_name(), iot.get_mv_file_name(),
                       shallow=False)
    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt)
    if exact:
        for fn in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                   "get_mc_decoded_file_name", "get_residual_wo_mc_file_name"):
            assert filecmp.cmp(getattr(iog, fn)(), getattr(iot, fn)(),
                               shallow=False), fn
    else:
        bg = os.path.getsize(iog.get_encoded_file_name())
        bt = os.path.getsize(iot.get_encoded_file_name())
        assert abs(bg - bt) / bg < 0.005


@pytest.mark.parametrize("nref", [1, 2], ids=["nref1", "nref2"])
def test_scene_change_second_pass(tmp_path, nref):
    """RC3 with a real scene cut: the P-frame whose first-pass bits overshoot
    1.3x the table expectation is re-encoded as an I-frame with cleared
    references (reference encoder.py:89-98) — including clearing the
    nRefFrames > 1 rolling stack."""
    from basic_video_codec_tpu.tools.ygen import noise_sequence, textured_frame

    Wq, Hq, Nq = 176, 144, 4
    base = np.stack([textured_frame(Wq, Hq, seed=1)] * 2)
    cut = noise_sequence(Wq, Hq, 2, seed=2)  # hard cut to noise
    frames = np.concatenate([base, cut])
    cfg = dict(block_size=16, search_range=2, I_Period=8, quantization_factor=9,
               RCflag=3, targetBR=1_200_000, resolution=(Wq, Hq),
               nRefFrames=nref)
    ios = {}
    for sub, enc, dec in (("g", golden_encode, golden_decode), ("t", dev_encode, dev_decode)):
        d = tmp_path / sub
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), frames)
        params = InputParameters(str(d / "t.y"), Wq, Hq,
                                 EncoderConfig(**cfg), frames_to_process=Nq)
        enc(params, results_csv_path=None)
        dec(params)
        ios[sub] = FileIOHelper(params, create_dirs=False)

    # the cut frame (index 3) must be INTRA in the bitstream
    with open(ios["t"].get_encoded_file_name(), "rb") as f:
        data = f.read()
    modes = []
    pos = 0
    for _ in range(Nq):
        modes.append(data[pos]); pos += 1
        plen = int.from_bytes(data[pos:pos + 2]); pos += 2 + plen
        dlen = int.from_bytes(data[pos:pos + 3]); pos += 3 + dlen
    assert modes[0] == 1 and modes[2] == 1, modes  # first frame I, cut frame I

    # golden parity: same decisions; noise content sits on the float-DCT
    # edge, so sizes agree within the documented tolerance rather than
    # byte-for-byte (PARITY.md)
    with open(ios["g"].get_encoded_file_name(), "rb") as f:
        gdata = f.read()
    gmodes = []
    pos = 0
    for _ in range(Nq):
        gmodes.append(gdata[pos]); pos += 1
        plen = int.from_bytes(gdata[pos:pos + 2]); pos += 2 + plen
        dlen = int.from_bytes(gdata[pos:pos + 3]); pos += 3 + dlen
    assert gmodes == modes
    assert abs(len(gdata) - len(data)) / len(gdata) < 0.005
    rt = np.fromfile(ios["t"].get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(ios["t"].get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt)


def test_non_multiple_resolution_device(tmp_path):
    """Padding path on the device pipeline: 100x60 at block 16 pads to 112x64;
    decode must still bit-match the encoder reconstruction."""
    Wn, Hn, Nn = 100, 60, 4
    y_path = str(tmp_path / "odd.y")
    ygen.write_y_file(y_path, ygen.moving_sequence(Wn, Hn, Nn, seed=2))
    ec = EncoderConfig(16, 2, 2, 4, resolution=(Wn, Hn))
    params = InputParameters(y_path, Wn, Hn, ec, Nn)
    dev_encode(params, results_csv_path=None)
    dev_decode(params)
    io = FileIOHelper(params, create_dirs=False)
    rec = np.fromfile(io.get_mc_reconstructed_file_name(), np.uint8)
    dec = np.fromfile(io.get_mc_decoded_file_name(), np.uint8)
    assert rec.size == 112 * 64 * Nn
    assert np.array_equal(rec, dec)


def test_nref4_chunked_multi_gop(tmp_path):
    """nRefFrames=4 through the GOP-chunked rolling-stack path: multiple
    GOPs, chunk boundaries mid-GOP, RC1 in-scan QP selection, and the
    reference-deque warm-up after each I-frame.  exact_transform pins the
    float edge so every decision (ME over the warm-up-masked stack, RC,
    entropy) must be byte-identical to the golden oracle."""
    iog, iot = _run_both(
        tmp_path, "nref4", W=176, H=144, N=9,
        block_size=16, search_range=2, I_Period=4, nRefFrames=4,
        RCflag=1, targetBR=600_000, resolution=(176, 144),
        exact_transform=True,
    )
    assert filecmp.cmp(iog.get_encoded_file_name(), iot.get_encoded_file_name(),
                       shallow=False)
    assert filecmp.cmp(iog.get_mv_file_name(), iot.get_mv_file_name(), shallow=False)
    assert filecmp.cmp(iog.get_residual_wo_mc_file_name(),
                       iot.get_residual_wo_mc_file_name(), shallow=False)
    rt = np.fromfile(iot.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(iot.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(fastME=True, fracMeEnabled=True),
    dict(RCflag=1, targetBR=600_000, W=176, H=144, resolution=(176, 144),
         N=9),
], ids=["fullsearch", "fastme_frac", "rc1"])
def test_mixed_multi_gop_chunks(tmp_path, cfg, monkeypatch):
    """BVC_MIXED=1 routes single-reference RC<=1 configs through the
    multi-GOP mixed chunk program (runtime per-frame mode, chunks spanning
    I-frame boundaries); every artifact must be byte-identical to the
    per-GOP default, and the self-consistency invariant must hold."""
    cfg = dict(cfg)
    dims = {k: cfg.pop(k) for k in ("W", "H", "N") if k in cfg}
    import basic_video_codec_tpu.models.pipeline as P

    monkeypatch.setattr(P, "MAX_CHUNK", 6)  # force chunks across GOPs
    monkeypatch.setenv("BVC_MIXED", "1")
    _, io_m = _run_both(tmp_path, "mixed", I_Period=3, **dims, **cfg)
    monkeypatch.setenv("BVC_MIXED", "0")
    _, io_g = _run_both(tmp_path, "pergop", I_Period=3, **dims, **cfg)
    for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                "get_quant_dct_coff_fh_file_name",
                "get_residual_w_mc_file_name",
                "get_residual_wo_mc_file_name", "get_mv_file_name"):
        assert filecmp.cmp(getattr(io_m, get)(), getattr(io_g, get)(),
                           shallow=False), get
    rt = np.fromfile(io_m.get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(io_m.get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt)


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(I_Period=1, quantization_factor=2),
    dict(nRefFrames=3, fracMeEnabled=True, block_size=16,
         quantization_factor=4),
], ids=["fullsearch", "intra_only", "nref3_frac"])
def test_decode_compact_transfers(tmp_path, cfg, monkeypatch):
    """BVC_DCOMPACT=1 (default) ships decoded frames as correction codes
    against the host-rebuilt integer-exact guess; the decoded file must be
    byte-identical to the full-plane path AND to the encoder
    reconstruction (the codec invariant)."""
    import hashlib

    from basic_video_codec_tpu.models.pipeline import decode_video

    base = dict(block_size=8, search_range=2, I_Period=4,
                quantization_factor=5, resolution=(W, H))
    base.update(cfg)
    y = ygen.moving_sequence(W, H, N, seed=11)
    d = tmp_path / "dc"
    d.mkdir()
    ygen.write_y_file(str(d / "t.y"), y)
    params = InputParameters(str(d / "t.y"), W, H, EncoderConfig(**base),
                             frames_to_process=N)
    dev_encode(params, results_csv_path=None)
    io = FileIOHelper(params, create_dirs=False)
    got = {}
    for mode in ("1", "0"):
        monkeypatch.setenv("BVC_DCOMPACT", mode)
        decode_video(params)
        got[mode] = hashlib.md5(
            open(io.get_mc_decoded_file_name(), "rb").read()).hexdigest()
    rec = hashlib.md5(
        open(io.get_mc_reconstructed_file_name(), "rb").read()).hexdigest()
    assert got["1"] == got["0"] == rec


def test_decode_compact_overflow_fallback(tmp_path, monkeypatch):
    """When the escape count blows the cap the pipeline must fall back to
    fetching the full decoded plane.  Forced here by sabotaging the
    device-side guess (every pixel escapes -> rn >> cap); the decoded
    output must still be byte-identical to the encoder reconstruction."""
    import hashlib

    import jax.numpy as jnp

    from basic_video_codec_tpu.models import chunk as chunk_mod
    from basic_video_codec_tpu.models.pipeline import decode_video

    y = ygen.moving_sequence(W, H, N, seed=11)
    d = tmp_path / "ovf"
    d.mkdir()
    ygen.write_y_file(str(d / "t.y"), y)
    ec = EncoderConfig(8, 2, 4, 5, resolution=(W, H))
    params = InputParameters(str(d / "t.y"), W, H, ec, frames_to_process=N)
    dev_encode(params, results_csv_path=None)
    io = FileIOHelper(params, create_dirs=False)
    rec = hashlib.md5(
        open(io.get_mc_reconstructed_file_name(), "rb").read()).hexdigest()
    monkeypatch.setenv("BVC_DCOMPACT", "1")
    chunk_mod.decode_chunk.clear_cache()
    # a garbage guess makes every pixel of every frame an escape
    monkeypatch.setattr(
        chunk_mod.P, "recon_guess_from_x",
        lambda x, pred, bs: jnp.zeros(pred.shape, jnp.uint8) + 7)
    try:
        decode_video(params)
        got = hashlib.md5(
            open(io.get_mc_decoded_file_name(), "rb").read()).hexdigest()
    finally:
        chunk_mod.decode_chunk.clear_cache()
    assert got == rec


# synthetic calibration table for resolutions without shipped CSVs
# (bits-per-block-row magnitudes scaled for a 112x64 padded plane)
_ODD_RC_TABLE = {
    qp: {"I": v, "P": max(v * 3 // 4, 40), "C": v * 7 // 8}
    for qp, v in [(1, 5200), (2, 3900), (3, 2800), (4, 1900), (5, 1250),
                  (6, 800), (7, 500), (8, 320), (9, 210), (10, 160), (11, 140)]
}


@pytest.mark.parametrize("rcflag", [1, 2])
def test_rate_control_odd_resolution(tmp_path, rcflag):
    """RC at a non-block-multiple resolution (100x60, bs=16, pads to 112x64):
    rows-left and smalls layouts must use the padded geometry end-to-end
    (PARITY.md divergence 6).  exact_transform
    makes golden and device streams byte-identical at every chosen QP."""
    Wn, Hn, Nn = 100, 60, 5
    y = ygen.moving_sequence(Wn, Hn, Nn, seed=9)
    ios = {}
    for sub, enc, dec in (("g", golden_encode, golden_decode), ("t", dev_encode, dev_decode)):
        d = tmp_path / sub
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), y)
        ec = EncoderConfig(16, 2, 3, 4, RCflag=rcflag, targetBR=360_000,
                           resolution=(Wn, Hn), exact_transform=True)
        ec.rc_lookup_table = dict(_ODD_RC_TABLE)
        params = InputParameters(str(d / "t.y"), Wn, Hn, ec, frames_to_process=Nn)
        enc(params, results_csv_path=None)
        dec(params)
        ios[sub] = FileIOHelper(params, create_dirs=False)
    assert filecmp.cmp(ios["g"].get_encoded_file_name(),
                       ios["t"].get_encoded_file_name(), shallow=False)
    rt = np.fromfile(ios["t"].get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(ios["t"].get_mc_decoded_file_name(), np.uint8)
    assert rt.size == 112 * 64 * Nn and np.array_equal(rt, dt)


@pytest.mark.parametrize("nref", [1, 2])
def test_truncated_input_raises(tmp_path, nref):
    """A truncated tail frame raises ValueError on every encode path
    (reference: np.frombuffer(buf).reshape on a short read) AFTER the full
    frames read before it were encoded and written."""
    ec = EncoderConfig(8, 2, 4, 4, nRefFrames=nref, resolution=(W, H))
    y_path = str(tmp_path / f"trunc{nref}.y")
    ygen.write_y_file(y_path, ygen.moving_sequence(W, H, 3, seed=3))
    with open(y_path, "ab") as f:
        f.write(b"\x80" * (W * H // 2))  # half a tail frame
    p = InputParameters(y_path, W, H, ec, frames_to_process=10)
    with pytest.raises(ValueError):
        dev_encode(p, results_csv_path=None)
    io = FileIOHelper(p, create_dirs=False)
    rec = np.fromfile(io.get_mc_reconstructed_file_name(), np.uint8)
    assert rec.size == W * H * 3, "full frames before the truncated tail must be written"
    with pytest.raises(ValueError):
        golden_encode(p, results_csv_path=None)


def test_decode_truncated_and_empty_streams(tmp_path):
    """Decode robustness (reference decoder.py:46-48 loop-break semantics):
    empty stream -> zero frames; stream cut at a frame boundary -> the prefix
    decodes unchanged; cut mid-frame -> graceful stop after the last complete
    frame (robustness superset: the reference crashes there); and
    frames_to_process beyond the stream -> whole stream, no error."""
    ec = EncoderConfig(8, 2, 3, 4, resolution=(W, H))
    y_path = str(tmp_path / "t.y")
    ygen.write_y_file(y_path, ygen.moving_sequence(W, H, 5, seed=4))
    p = InputParameters(y_path, W, H, ec, frames_to_process=5)
    dev_encode(p, results_csv_path=None)
    io = FileIOHelper(p, create_dirs=False)
    enc_path = io.get_encoded_file_name()
    with open(enc_path, "rb") as f:
        full = f.read()
    dev_decode(p)
    baseline = np.fromfile(io.get_mc_decoded_file_name(), np.uint8)
    assert baseline.size == W * H * 5

    # frame boundaries from the framing: 1B mode, 2B len, pred, 3B len, dct
    bounds = []
    pos = 0
    for _ in range(5):
        plen = int.from_bytes(full[pos + 1 : pos + 3])
        dlen = int.from_bytes(full[pos + 3 + plen : pos + 6 + plen])
        pos += 6 + plen + dlen
        bounds.append(pos)

    def decode_with(stream_bytes):
        with open(enc_path, "wb") as f:
            f.write(stream_bytes)
        dev_decode(p)
        return np.fromfile(io.get_mc_decoded_file_name(), np.uint8)

    try:
        assert decode_with(b"").size == 0
        out = decode_with(full[: bounds[2]])  # cut at a frame boundary
        assert out.size == W * H * 3
        assert np.array_equal(out, baseline[: out.size]), "prefix frames must be unchanged"
        out = decode_with(full[: bounds[2] + 4])  # cut mid-frame (inside frame 4)
        assert out.size == W * H * 3
        assert np.array_equal(out, baseline[: out.size])
        p.frames_to_process = 50  # beyond the stream
        out = decode_with(full)
        assert out.size == W * H * 5 and np.array_equal(out, baseline)
    finally:
        p.frames_to_process = 5
        with open(enc_path, "wb") as f:
            f.write(full)


def test_short_and_empty_inputs(tmp_path):
    """Fewer frames than requested -> encode what exists; empty file -> zero
    frames, valid (empty) artifacts (the reference's loop-break semantics,
    encoder.py:79-81)."""
    ec = EncoderConfig(8, 2, 4, 4, resolution=(W, H))
    short = str(tmp_path / "short.y")
    ygen.write_y_file(short, ygen.moving_sequence(W, H, 2, seed=1))
    p = InputParameters(short, W, H, ec, frames_to_process=10)
    dev_encode(p, results_csv_path=None)
    dev_decode(p)
    io = FileIOHelper(p, create_dirs=False)
    rec = np.fromfile(io.get_mc_reconstructed_file_name(), np.uint8)
    dec = np.fromfile(io.get_mc_decoded_file_name(), np.uint8)
    assert rec.size == W * H * 2 and np.array_equal(rec, dec)

    empty = str(tmp_path / "empty.y")
    open(empty, "wb").close()
    p = InputParameters(empty, W, H, ec, frames_to_process=5)
    dev_encode(p, results_csv_path=None)
    io = FileIOHelper(p, create_dirs=False)
    assert os.path.getsize(io.get_encoded_file_name()) == 0


def test_rerun_shrinks_artifacts(tmp_path):
    """Re-encoding fewer frames into an artifact tree left by a longer run
    must produce byte-identical files to a fresh-directory run: the
    overwrite-in-place artifact opens (io/fileio.overwrite_open) truncate
    to the new length at close."""
    y = ygen.moving_sequence(W, H, 8, seed=3)
    ec = EncoderConfig(8, 2, 4, 3, resolution=(W, H))
    for sub in ("reused", "fresh"):
        (tmp_path / sub).mkdir()
        ygen.write_y_file(str(tmp_path / sub / "s.y"), y)
    p8 = InputParameters(str(tmp_path / "reused" / "s.y"), W, H, ec,
                         frames_to_process=8)
    dev_encode(p8, results_csv_path=None)
    ios = {}
    for sub in ("reused", "fresh"):
        p4 = InputParameters(str(tmp_path / sub / "s.y"), W, H, ec,
                             frames_to_process=4)
        dev_encode(p4, results_csv_path=None)
        ios[sub] = FileIOHelper(p4, create_dirs=False)
    for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                "get_quant_dct_coff_fh_file_name",
                "get_residual_w_mc_file_name",
                "get_residual_wo_mc_file_name", "get_mv_file_name"):
        assert filecmp.cmp(getattr(ios["reused"], get)(),
                           getattr(ios["fresh"], get)(), shallow=False), get
    dev_decode(InputParameters(str(tmp_path / "reused" / "s.y"), W, H, ec,
                               frames_to_process=4))
    rec = np.fromfile(ios["reused"].get_mc_reconstructed_file_name(), np.uint8)
    dec = np.fromfile(ios["reused"].get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rec, dec)


def test_finalize_failure_leaves_clean_prefix(tmp_path, monkeypatch):
    """If a frame fails to finalize, the writer must stop: artifacts end as
    a clean prefix (no later frames written past the hole), and the
    original exception surfaces from encode_video."""
    import basic_video_codec_tpu.models.pipeline as pl

    y = ygen.moving_sequence(W, H, 6, seed=2)
    src = str(tmp_path / "t.y")
    ygen.write_y_file(src, y)
    real = pl._finalize_fields

    def boom(index, *a, **k):
        if index == 4:
            raise RuntimeError("injected finalize failure")
        return real(index, *a, **k)

    monkeypatch.setattr(pl, "_finalize_fields", boom)
    ec = EncoderConfig(8, 2, 3, 4, resolution=(W, H))
    p = InputParameters(src, W, H, ec, frames_to_process=6)
    with pytest.raises(RuntimeError, match="injected"):
        dev_encode(p, results_csv_path=None)
    io = FileIOHelper(p, create_dirs=False)
    n = os.path.getsize(io.get_mc_reconstructed_file_name())
    assert n % (W * H) == 0 and n // (W * H) <= 3  # frames 1..3 at most
