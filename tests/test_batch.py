"""Batched multi-config encode (models/batch.py) conformance.

The batch lane vmaps N same-shape fixed-QP configs into one device program
(the SURVEY §7.7 "sweeps become vmapped batch encodes" item; reference
analog: the serial sweep loop in assign1/ex4_plots.py:131-257).  Guarantee
encoded here: every artifact a batched run writes is byte-identical to a
serial ``encode_video`` run of the same config — batching changes wall
time, never bytes.  (metrics.csv carries wall-clock columns, so it is
compared field-wise excluding the two timing fields.)
"""

import csv
import filecmp
import logging
import os

import pytest

from basic_video_codec_tpu.config import EncoderConfig, InputParameters
from basic_video_codec_tpu.io.fileio import FileIOHelper
from basic_video_codec_tpu.models.batch import (_batchable, _group_key,
                                                encode_videos_batched)
from basic_video_codec_tpu.models.pipeline import encode_video as serial_encode
from basic_video_codec_tpu.tools import ygen

logging.getLogger().setLevel(logging.ERROR)

W, H, N = 64, 48, 6


def _params(d, qp, **cfg):
    base = dict(block_size=8, search_range=2, I_Period=4,
                quantization_factor=qp, resolution=(W, H))
    base.update(cfg)
    return InputParameters(str(d / "t.y"), W, H, EncoderConfig(**base),
                           frames_to_process=N)


def _artifacts(params):
    io = FileIOHelper(params, create_dirs=False)
    return {
        "encoded": io.get_encoded_file_name(),
        "mv": io.get_mv_file_name(),
        "qdct": io.get_quant_dct_coff_fh_file_name(),
        "res_w": io.get_residual_w_mc_file_name(),
        "res_wo": io.get_residual_wo_mc_file_name(),
        "recon": io.get_mc_reconstructed_file_name(),
        "metrics": io.get_metrics_csv_file_name(),
    }


def _assert_identical_trees(p_batch, p_serial, label):
    a, b = _artifacts(p_batch), _artifacts(p_serial)
    for key in ("encoded", "mv", "qdct", "res_w", "res_wo", "recon"):
        assert filecmp.cmp(a[key], b[key], shallow=False), \
            f"{label}: artifact {key!r} differs between batched and serial"
    with open(a["metrics"]) as fa, open(b["metrics"]) as fb:
        rows_a, rows_b = list(csv.reader(fa)), list(csv.reader(fb))
    assert len(rows_a) == len(rows_b)
    hdr = rows_a[0]
    timing = {i for i, name in enumerate(hdr)
              if "time" in name.lower() or "elapsed" in name.lower()}
    assert timing, f"metrics header has no timing columns to mask: {hdr}"
    for ra, rb in zip(rows_a, rows_b):
        masked_a = [v for i, v in enumerate(ra) if i not in timing]
        masked_b = [v for i, v in enumerate(rb) if i not in timing]
        assert masked_a == masked_b, f"{label}: metrics row differs"


def _make_pair(tmp_path, name, seed=11):
    """Two dirs holding the same sequence: batch writes under b/, serial
    under s/ (artifact paths derive from the .y location, so the trees
    cannot collide)."""
    y = ygen.moving_sequence(W, H, N, seed=seed)
    dirs = []
    for sub in ("b", "s"):
        d = tmp_path / name / sub
        d.mkdir(parents=True, exist_ok=True)
        ygen.write_y_file(str(d / "t.y"), y)
        dirs.append(d)
    return dirs


GROUPS = [
    ("ip_fullsearch", dict(), [0, 3, 6]),
    ("intra_only", dict(I_Period=1), [2, 5]),
    # feature-combo legs are slow-marked (suite-time budget): the lanes
    # they exercise stay covered by default via the serial-pipeline and
    # multiref tests; run them with ``-m slow``
    pytest.param("fastme_b16",
                 dict(block_size=16, search_range=4, fastME=True), [1, 7],
                 marks=pytest.mark.slow),
    pytest.param("fracme", dict(fracMeEnabled=True), [3, 6],
                 marks=pytest.mark.slow),
]


@pytest.mark.parametrize("name,cfg,qps", GROUPS,
                         ids=["ip_fullsearch", "intra_only", "fastme_b16",
                              "fracme"])
def test_batched_group_matches_serial(tmp_path, name, cfg, qps):
    db, ds = _make_pair(tmp_path, name)
    batch_runs = [_params(db, qp, **cfg) for qp in qps]
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1, "group should have batched into one program"
    assert len(res.elapsed) == len(qps)
    for qp in qps:
        serial_encode(_params(ds, qp, **cfg), results_csv_path=None)
    for qp, pb in zip(qps, batch_runs):
        _assert_identical_trees(pb, _params(ds, qp, **cfg), f"{name} qp={qp}")


def test_mixed_eligibility_falls_back_serial(tmp_path):
    """Ineligible runs (golden backend; RC 2/3 two-pass) must fall back to
    per-run serial encodes and still write correct artifact trees."""
    from basic_video_codec_tpu.encoder import encode_video as dispatch_encode

    db, ds = _make_pair(tmp_path, "mixed")
    runs = [
        _params(db, 3),
        _params(db, 6),
        _params(db, 3, backend="golden"),
    ]
    assert not _batchable(runs[2])
    res = encode_videos_batched(runs, results_csv_path=None)
    assert res.n_batched == 1  # the two fixed-QP device-backend runs
    for p in [_params(ds, 3), _params(ds, 6)]:
        serial_encode(p, results_csv_path=None)
    dispatch_encode(_params(ds, 3, backend="golden"), results_csv_path=None)
    for pb, qp, cfg in [(runs[0], 3, {}), (runs[1], 6, {}),
                        (runs[2], 3, dict(backend="golden"))]:
        _assert_identical_trees(pb, _params(ds, qp, **cfg), f"mixed qp={qp}")


def test_multiref_group_matches_serial(tmp_path):
    """nRefFrames > 1 groups batch through the vmapped rolling-stack chunk
    program (the ablation driver's nRef=4 series shape,
    reference assign2/Deliverable.py) — byte-identical to serial."""
    db, ds = _make_pair(tmp_path, "multiref")
    qps = [3, 6]
    cfg = dict(nRefFrames=4)
    batch_runs = [_params(db, qp, **cfg) for qp in qps]
    assert all(_batchable(p) for p in batch_runs)
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1, "nRef=4 QP sweep should batch into one program"
    for qp in qps:
        serial_encode(_params(ds, qp, **cfg), results_csv_path=None)
    for qp, pb in zip(qps, batch_runs):
        _assert_identical_trees(pb, _params(ds, qp, **cfg),
                                f"multiref qp={qp}")


@pytest.mark.slow
def test_multiref_fastme_frac_group_matches_serial(tmp_path):
    """Multiref batching composed with fastME + fractional ME (the ablation
    grid's feature series)."""
    db, ds = _make_pair(tmp_path, "multiref_ff")
    qps = [2, 5]
    cfg = dict(nRefFrames=2, fastME=True, fracMeEnabled=True)
    batch_runs = [_params(db, qp, **cfg) for qp in qps]
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1
    for qp in qps:
        serial_encode(_params(ds, qp, **cfg), results_csv_path=None)
    for qp, pb in zip(qps, batch_runs):
        _assert_identical_trees(pb, _params(ds, qp, **cfg),
                                f"multiref_ff qp={qp}")


def test_mixed_iperiod_group_matches_serial(tmp_path):
    """Configs with DIFFERENT I_Periods (including all-intra) batch into the
    runtime-mode lane (encode_chunk_mixed vmapped): one group, per-frame
    traced intra flags, chunks spanning GOP boundaries — still
    byte-identical to per-config serial encodes."""
    db, ds = _make_pair(tmp_path, "mixed_ip")
    cfgs = [(1, 2), (4, 2), (3, 5), (6, 7)]  # (I_Period, qp)
    batch_runs = [_params(db, qp, I_Period=ip) for ip, qp in cfgs]
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1, "I_Period variants should share one group"
    for ip, qp in cfgs:
        serial_encode(_params(ds, qp, I_Period=ip), results_csv_path=None)
    for (ip, qp), pb in zip(cfgs, batch_runs):
        _assert_identical_trees(pb, _params(ds, qp, I_Period=ip),
                                f"ip={ip} qp={qp}")


def test_multi_stream_batch_matches_serial(tmp_path):
    """Multi-stream serving: DIFFERENT input sequences with same-shape
    configs batch into one program (frames in_axes=0) and each stream's
    artifact tree matches its serial encode byte-for-byte."""
    seqs = {s: ygen.moving_sequence(W, H, N, seed=s) for s in (31, 32, 33)}
    batch_runs, serial_params = [], []
    for s, y in seqs.items():
        for sub, bucket in (("b", batch_runs), ("s", serial_params)):
            d = tmp_path / f"{s}{sub}"
            d.mkdir()
            ygen.write_y_file(str(d / "t.y"), y)
            bucket.append(_params(d, 4))
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1, "streams should have batched into one program"
    for p in serial_params:
        serial_encode(p, results_csv_path=None)
    for pb, ps, s in zip(batch_runs, serial_params, seqs):
        _assert_identical_trees(pb, ps, f"stream seed={s}")


def test_rc1_group_matches_serial(tmp_path):
    """RC1 groups batch over target bitrates (the rc-compare study's shape,
    reference assign3/Ex2.py): the per-row budget chain is device scalar
    math, so ``budget0`` is just another batched axis — byte-identical to
    serial, including rc_qp per-row decisions.  Uses the integer-exact
    transform: the RC chain feeds actual row bits back into QP decisions,
    so the permitted float-DCT ±1 edge (batched matmul HLO rounding)
    would otherwise make byte-identity content-dependent; exact mode pins
    the RC-chain parity strictly."""
    Wq, Hq, Nq = 176, 144, 4  # RC lookup tables exist for QCIF
    y = ygen.moving_sequence(Wq, Hq, Nq, seed=21)
    dirs = []
    for sub in ("b", "s"):
        d = tmp_path / "rc1" / sub
        d.mkdir(parents=True)
        ygen.write_y_file(str(d / "t.y"), y)
        dirs.append(d)
    db, ds = dirs

    def rc_params(d, br):
        ec = EncoderConfig(block_size=8, search_range=2, I_Period=4,
                           quantization_factor=3, resolution=(Wq, Hq),
                           RCflag=1, targetBR=br, exact_transform=True)
        return InputParameters(str(d / "t.y"), Wq, Hq, ec,
                               frames_to_process=Nq)

    brs = [480_000, 1_200_000, 2_400_000]
    batch_runs = [rc_params(db, br) for br in brs]
    assert all(_batchable(p) for p in batch_runs)
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1, "RC1 bitrate sweep should batch into one program"
    for br in brs:
        serial_encode(rc_params(ds, br), results_csv_path=None)
    for br, pb in zip(brs, batch_runs):
        _assert_identical_trees(pb, rc_params(ds, br), f"rc1 br={br}")


def test_two_pass_group_matches_serial(tmp_path):
    """RC 2/3 groups batch through the vmapped fused two-pass program
    (models/two_pass.py): per-config budget / scene-change statistic /
    prev-avg-QP seed are batched scalars.  Content includes a mid-sequence
    cut so the scene-change intra path is exercised under vmap.
    Integer-exact transform for the same reason as the RC1 test: the
    two-pass chain feeds pass-1 bits into pass-2 QPs, so the float-DCT ±1
    edge would otherwise soften byte-identity."""
    Wq, Hq, Nq = 176, 144, 6
    y = ygen.camera_sequence(Wq, Hq, Nq, seed=7, cut_at=3)
    dirs = []
    for sub in ("b", "s"):
        d = tmp_path / "rc3" / sub
        d.mkdir(parents=True)
        ygen.write_y_file(str(d / "t.y"), y)
        dirs.append(d)
    db, ds = dirs

    def rc_params(d, br):
        ec = EncoderConfig(block_size=8, search_range=2, I_Period=6,
                           quantization_factor=3, resolution=(Wq, Hq),
                           RCflag=3, targetBR=br, exact_transform=True)
        return InputParameters(str(d / "t.y"), Wq, Hq, ec,
                               frames_to_process=Nq)

    brs = [480_000, 2_400_000]
    batch_runs = [rc_params(db, br) for br in brs]
    assert all(_batchable(p) for p in batch_runs)
    res = encode_videos_batched(batch_runs, results_csv_path=None)
    assert res.n_batched == 1, "RC3 bitrate sweep should batch into one program"
    for br in brs:
        serial_encode(rc_params(ds, br), results_csv_path=None)
    for br, pb in zip(brs, batch_runs):
        _assert_identical_trees(pb, rc_params(ds, br), f"rc3 br={br}")


def test_long_groups_route_serial(tmp_path):
    """Groups longer than BATCH_MAX_FRAMES route through the serial loop:
    n_batched == 0, artifacts still correct (they ARE serial encodes)."""
    from basic_video_codec_tpu.models import batch as B

    NL = B.BATCH_MAX_FRAMES + 1
    y = ygen.moving_sequence(W, H, NL, seed=13)
    d = tmp_path / "long"
    d.mkdir()
    ygen.write_y_file(str(d / "t.y"), y)
    runs = [InputParameters(str(d / "t.y"), W, H,
                            EncoderConfig(block_size=8, search_range=2,
                                          I_Period=4, quantization_factor=qp,
                                          resolution=(W, H)),
                            frames_to_process=NL) for qp in (3, 6)]
    res = encode_videos_batched(runs, results_csv_path=None)
    assert res.n_batched == 0, "long shared-input group should run serial"
    assert all(dt > 0 for dt in res.elapsed)


def test_multi_stream_unequal_lengths_raise(tmp_path):
    a = tmp_path / "a"; b = tmp_path / "b"
    a.mkdir(); b.mkdir()
    ygen.write_y_file(str(a / "t.y"), ygen.moving_sequence(W, H, N, seed=1))
    ygen.write_y_file(str(b / "t.y"), ygen.moving_sequence(W, H, N - 2, seed=2))
    with pytest.raises(ValueError, match="unequal frame counts"):
        encode_videos_batched([_params(a, 3), _params(b, 3)],
                              results_csv_path=None)


def test_group_key_separates_shapes(tmp_path):
    d = tmp_path / "k"
    d.mkdir()
    ygen.write_y_file(str(d / "t.y"), ygen.moving_sequence(W, H, N, seed=1))
    a = _params(d, 1)
    b = _params(d, 4)
    c = _params(d, 1, block_size=16, search_range=4)
    e = _params(d, 1, fastME=True)
    f = _params(d, 1, I_Period=1)
    assert _group_key(a) == _group_key(b)
    assert _group_key(a) == _group_key(f)  # I_Period rides the mixed lane
    assert _group_key(a) != _group_key(c)
    assert _group_key(a) != _group_key(e)
    # nRefFrames and RCflag shape the program: never grouped with nRef=1/RC0
    g = _params(d, 1, nRefFrames=2)
    h2 = _params(d, 1, nRefFrames=2, I_Period=8)
    assert _group_key(a) != _group_key(g)
    assert _group_key(g) != _group_key(h2)  # multiref pins I_Period
    assert _group_key(g) == _group_key(_params(d, 4, nRefFrames=2))
