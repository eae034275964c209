"""Randomized cross-backend conformance sweep.

Draws seeded random configurations over the full feature space (block size,
search range, I_Period, QP, nRefFrames, fastME, fracME, RC mode, resolution
incl. non-block-multiples, parallel GOP sharding) and asserts that the device
pipeline's bitstream and artifact tree are byte-identical to the golden
oracle under ``exact_transform`` (which pins the one permitted float
divergence), plus the decode==recon invariant.  A fixed seed keeps the sweep
deterministic; ``BVC_PROPERTY_CASES`` scales it up for soak runs.
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
from basic_video_codec_tpu.tools import ygen

N_CASES = int(os.environ.get("BVC_PROPERTY_CASES", "8"))

RC_TABLE = {
    qp: {"I": v, "P": max(v * 3 // 4, 40), "C": v * 7 // 8}
    for qp, v in [(1, 5200), (2, 3900), (3, 2800), (4, 1900), (5, 1250),
                  (6, 800), (7, 500), (8, 320), (9, 210), (10, 160), (11, 140)]
}


def _table_for(bs):
    """Calibration capped at the block size's max representable QP — like
    the shipped tables, whose entry counts track log2(bs)+7 per block size
    (see rc/lookup.py); encode refuses tables that exceed the bound."""
    import math

    max_qp = int(math.log2(bs)) + 7
    return {q: dict(v) for q, v in RC_TABLE.items() if q <= max_qp}


def _draw(rng):
    bs = int(rng.choice([4, 8, 16]))
    w = int(rng.choice([48, 64, 100, 176]))
    h = int(rng.choice([32, 48, 60, 144]))
    rc = int(rng.choice([0, 0, 1, 2, 3]))
    cfg = dict(
        block_size=bs,
        search_range=int(rng.integers(1, 4)),
        I_Period=int(rng.choice([1, 2, 3, 5])),
        quantization_factor=int(rng.integers(0, 7)),
        nRefFrames=int(rng.choice([1, 1, 2, 4])),
        fastME=bool(rng.random() < 0.4),
        fracMeEnabled=bool(rng.random() < 0.4),
        RCflag=rc,
        targetBR=int(rng.choice([240_000, 480_000])) if rc else 0,
        resolution=(w, h),
        exact_transform=True,
    )
    n = int(rng.integers(3, 8))
    return cfg, w, h, n


def test_table_qp_beyond_block_range_rejected(tmp_path):
    """An RC table holding QPs beyond log2(bs)+7 is refused loudly on every
    backend: the reference's own tables respect the bound by construction,
    and the device quantization-matrix stack cannot represent such levels
    (it would silently clamp)."""
    y = ygen.moving_sequence(48, 32, 2, seed=1)
    ygen.write_y_file(str(tmp_path / "t.y"), y)
    ec = EncoderConfig(4, 1, 2, 3, RCflag=1, targetBR=100_000, resolution=(48, 32))
    ec.rc_lookup_table = {k: dict(v) for k, v in RC_TABLE.items()}  # up to QP 11
    p = InputParameters(str(tmp_path / "t.y"), 48, 32, ec, frames_to_process=2)
    with pytest.raises(ValueError, match="beyond the valid"):
        dev_encode(p, results_csv_path=None)
    with pytest.raises(ValueError, match="beyond the valid"):
        golden_encode(p, results_csv_path=None)


@pytest.mark.parametrize("case", [
    # half the draws run by default; the rest keep full coverage under
    # ``-m slow`` (suite-time budget: each draw is a full dual-backend
    # encode+decode roundtrip)
    pytest.param(c, marks=pytest.mark.slow) if c % 2 else c
    for c in range(N_CASES)])
def test_random_config_byte_parity(tmp_path, case, monkeypatch):
    rng = np.random.default_rng(6000 + case)
    cfg, w, h, n = _draw(rng)
    # transport knobs are conformance-neutral by design — draw the
    # non-default combinations too (mixed multi-GOP chunks, raw uploads,
    # full-plane decode fetches, non-tail rows)
    for var, p_on in (("BVC_MIXED", 0.33), ("BVC_UPACK", 0.75),
                      ("BVC_DCOMPACT", 0.75), ("BVC_TAIL", 0.85),
                      ("BVC_DEVBITS", 0.5)):
        monkeypatch.setenv(var, str(int(rng.random() < p_on)))
    y = ygen.moving_sequence(w, h, n, seed=int(rng.integers(0, 1 << 30)))
    ios = {}
    for sub, enc, dec in (("g", golden_encode, golden_decode),
                          ("t", dev_encode, dev_decode)):
        d = tmp_path / sub
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), y)
        ec = EncoderConfig(**cfg)
        if cfg["RCflag"]:
            ec.rc_lookup_table = _table_for(cfg["block_size"])
        p = InputParameters(str(d / "t.y"), w, h, ec, frames_to_process=n)
        enc(p, results_csv_path=None)
        dec(p)
        ios[sub] = FileIOHelper(p, create_dirs=False)
    label = {k: v for k, v in cfg.items() if v}
    for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                "get_mc_decoded_file_name", "get_quant_dct_coff_fh_file_name",
                "get_residual_w_mc_file_name", "get_residual_wo_mc_file_name",
                "get_mv_file_name"):
        assert filecmp.cmp(getattr(ios["g"], get)(), getattr(ios["t"], get)(),
                           shallow=False), (get, label)
    rt = np.fromfile(ios["t"].get_mc_reconstructed_file_name(), np.uint8)
    dt = np.fromfile(ios["t"].get_mc_decoded_file_name(), np.uint8)
    assert np.array_equal(rt, dt), label


@pytest.mark.parametrize("case", [
    # one default draw; the rest slow — and the count scales with
    # BVC_PROPERTY_CASES for soak runs like the config sweep above
    c if c == 0 else pytest.param(c, marks=pytest.mark.slow)
    for c in range(max(3, N_CASES // 2))])
def test_random_batch_group_parity(tmp_path, case):
    """Randomized batch-lane draw: a random base config grouped along one
    batched axis (target bitrates under RC, QPs otherwise) must write
    trees byte-identical to serial encodes — the batch analog of
    test_random_config_byte_parity, pinning the multiref / RC1 / two-pass
    vmap lanes against drift (exact transform pins the float edge)."""
    from basic_video_codec_tpu.models.batch import encode_videos_batched
    from basic_video_codec_tpu.models.pipeline import encode_video

    rng = np.random.default_rng(7000 + case)
    cfg, w, h, n = _draw(rng)
    if cfg["RCflag"]:
        variants = [dict(cfg, targetBR=br) for br in (240_000, 720_000)]
    else:
        qps = rng.choice(np.arange(0, 7), size=2, replace=False)
        variants = [dict(cfg, quantization_factor=int(q)) for q in qps]
    y = ygen.moving_sequence(w, h, n, seed=int(rng.integers(0, 1 << 30)))
    trees = {}
    for sub in ("b", "s"):
        d = tmp_path / sub
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), y)
        ps = []
        for v in variants:
            ec = EncoderConfig(**v)
            if v["RCflag"]:
                ec.rc_lookup_table = _table_for(v["block_size"])
            ps.append(InputParameters(str(d / "t.y"), w, h, ec,
                                      frames_to_process=n))
        trees[sub] = ps
    res = encode_videos_batched(trees["b"], results_csv_path=None)
    assert res.n_batched == 1, [v for v in variants]
    for p in trees["s"]:
        encode_video(p, results_csv_path=None)
    for pb, ps in zip(trees["b"], trees["s"]):
        iob = FileIOHelper(pb, create_dirs=False)
        ios_ = FileIOHelper(ps, create_dirs=False)
        for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                    "get_quant_dct_coff_fh_file_name", "get_mv_file_name",
                    "get_residual_w_mc_file_name"):
            assert filecmp.cmp(getattr(iob, get)(), getattr(ios_, get)(),
                               shallow=False), (get, pb.encoder_config.__dict__)
