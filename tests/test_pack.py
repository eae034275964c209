"""Compact device->host transfer codecs (ops/pack.py): lossless round trips,
overflow fallbacks, and host-side plane rebuilds vs the device kernels."""

import numpy as np
import pytest

import basic_video_codec_tpu.ops.pack as PK
from basic_video_codec_tpu.entropy.zigzag import zigzag_indices


def _random_qdct(rng, h, w, bs, density=0.15, lo=-120, hi=120):
    q = np.zeros((h, w), np.int16)
    mask = rng.random((h, w)) < density
    q[mask] = rng.integers(lo, hi + 1, size=mask.sum())
    return q


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_qdct_pack_roundtrip(bs):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    h, w = 4 * bs, 6 * bs
    nb = (h // bs) * (w // bs)
    q = _random_qdct(rng, h, w, bs)
    zz = zigzag_indices(bs)
    cap = nb * bs * bs  # roomy: dense random content has near-full prefixes
    vals, lens, total = PK.pack_qdct(jnp.asarray(q), bs, cap, jnp.int16)
    assert int(total) <= cap
    out = PK.unpack_qdct(np.asarray(vals), np.asarray(lens), h, w, bs, zz)
    assert np.array_equal(out, q)


def test_qdct_pack_overflow_flagged():
    import jax.numpy as jnp

    bs, h, w = 8, 32, 32
    q = np.full((h, w), 7, np.int16)  # every block has a full prefix
    zz = zigzag_indices(bs)
    cap = 64  # far too small
    vals, lens, total = PK.pack_qdct(jnp.asarray(q), bs, cap, jnp.int16)
    assert int(total) == h * w > cap  # overflow is detectable
    assert np.asarray(vals).shape == (cap,)


def _random_x_blocks(rng, h, w, bs):
    """Plausible integer-IDCT residual blocks (scaled by 2^EXACT_SHIFT)."""
    from basic_video_codec_tpu.ops.transform import EXACT_SHIFT

    x = rng.integers(-255, 256, (h // bs, w // bs, bs, bs)).astype(np.int64)
    jitter = rng.integers(-(1 << 12), 1 << 12, x.shape)
    return ((x << EXACT_SHIFT) + jitter).astype(np.int32)


@pytest.mark.parametrize("art_valid", [None, True, False])
def test_joint_pack_roundtrip(art_valid):
    """pack_joint (device: nonzero bitmap + 3-bit kind list + escape lists)
    vs the host rebuild (joint_recon / joint_art) across all state classes:
    match, +-1 on either plane, both-nonzero pixels, and raw escapes."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    h, w, bs = 48, 64, 8
    x = _random_x_blocks(rng, h, w, bs)
    guess_a = PK.host_art_guess_from_x(x).astype(np.int32)
    guess_r = rng.integers(0, 256, (h, w)).astype(np.int32)
    dr = rng.choice([0, 1, -1], (h, w), p=[0.85, 0.075, 0.075])
    da = rng.choice([0, 1, -1], (h, w), p=[0.85, 0.075, 0.075])
    recon = ((guess_r + dr) % 256).astype(np.uint8)
    art = ((guess_a + da) % 256).astype(np.uint8)
    for plane, base in ((recon, guess_r), (art, guess_a)):
        px = rng.random((h, w)) < 0.02
        plane[px] = rng.integers(0, 256, px.sum())
    cap = PK.esc_cap(h, w)
    av = None if art_valid is None else jnp.asarray(art_valid)
    jb, jk, jn, re, rn, ae, an = PK.pack_joint(
        jnp.asarray(recon), jnp.asarray(guess_r),
        jnp.asarray(art), jnp.asarray(guess_a), cap, art_valid=av)
    assert int(rn) <= cap and int(an) <= cap
    assert int(jn) <= PK.jk_cap(h, w, False)
    states = PK.host_joint_decode(np.asarray(jb), np.asarray(jk), h * w)
    out_r = PK.joint_recon(states, np.asarray(re), guess_r)
    assert np.array_equal(out_r, recon)
    if art_valid is False:
        assert int(an) == 0
        assert np.array_equal(
            PK.joint_art(states, np.asarray(ae), guess_a),
            (guess_a & 255).astype(np.uint8))  # art half empty
    else:
        out_a = PK.joint_art(states, np.asarray(ae), guess_a)
        assert np.array_equal(out_a, art)


def test_art_guess_device_host_identical():
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    h, w, bs = 48, 64, 8
    x = _random_x_blocks(rng, h, w, bs)
    dev = np.asarray(PK.art_guess_from_x(jnp.asarray(x)))
    host = PK.host_art_guess_from_x(x)
    assert np.array_equal(dev, host)


def test_joint_pack_overflow_flagged():
    import jax.numpy as jnp

    h, w = 32, 32
    zeros = np.zeros((h, w), np.int32)
    recon = np.full((h, w), 77, np.uint8)  # every pixel escapes the recon half
    art = np.zeros((h, w), np.uint8)
    cap = 16
    _, _, jn, _, rn, _, an = PK.pack_joint(
        jnp.asarray(recon), jnp.asarray(zeros),
        jnp.asarray(art), jnp.asarray(zeros), cap)
    assert int(rn) == h * w > cap
    assert int(jn) == h * w  # every pixel nonzero -> kind-list overflow
    assert int(an) == 0


@pytest.mark.parametrize("frac", [False, True])
def test_host_pred_matches_device_gather(frac):
    import jax.numpy as jnp

    from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
    from basic_video_codec_tpu.ops.me import gather_pred_blocks

    rng = np.random.default_rng(2)
    bs, h, w = 8, 48, 64
    nbr, nbc = h // bs, w // bs
    prev = rng.integers(0, 256, (h, w)).astype(np.uint8)
    hp = build_pre_interpolated_buffer(prev)
    r = 2 * (2 if frac else 1)
    mvs = np.zeros((nbr, nbc, 3), np.int32)
    mvs[..., 0] = rng.integers(-r, r + 1, (nbr, nbc))
    mvs[..., 1] = rng.integers(-r, r + 1, (nbr, nbc))
    # clamp to stay in range at the borders
    lim = (2 if frac else 1)
    for i in range(nbr):
        for j in range(nbc):
            mvs[i, j, 0] = np.clip(mvs[i, j, 0], -j * bs * lim,
                                   (w - (j + 1) * bs) * lim)
            mvs[i, j, 1] = np.clip(mvs[i, j, 1], -i * bs * lim,
                                   (h - (i + 1) * bs) * lim)
    dev = gather_pred_blocks(jnp.asarray(prev)[None], jnp.asarray(hp)[None],
                             jnp.asarray(mvs), bs, frac)
    dev_plane = np.asarray(dev).transpose(0, 2, 1, 3).reshape(h, w)
    host = PK.host_pred_inter(prev, mvs, bs, frac, hp)
    assert np.array_equal(host, dev_plane)


def test_host_intra_art_matches_device():
    import jax.numpy as jnp

    from basic_video_codec_tpu.ops.intra import intra_encode_frame

    rng = np.random.default_rng(3)
    bs, h, w = 8, 48, 64
    curr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    nbr, nbc = h // bs, w // bs
    recon, _, art, _, smalls = intra_encode_frame(
        jnp.asarray(curr), jnp.full(nbr, 4, jnp.int32), jnp.float32(0),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.float32), jnp.int32(4),
        bs, False,
    )
    modes = np.asarray(smalls)[: nbr * nbc].reshape(nbr, nbc)
    host = PK.host_intra_art(curr, np.asarray(recon), modes, bs)
    assert np.array_equal(host, np.asarray(art))


@pytest.mark.parametrize("esc_heavy", [False, True])
def test_qdct_nibble_roundtrip(esc_heavy):
    """q4 entropy-split packing (device: 2-bit codes + nibble escapes +
    int16 deep escapes) -> FrameLayout._qv expansion (host) must
    reproduce the int16 value stream, including both escape levels in
    stream order and the overflow counts."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    h, w, bs = 48, 64, 8
    nb = (h // bs) * (w // bs)
    cap = PK.qdct_caps(nb, bs)
    # sparse plane with mixed magnitudes (some |v| > 7 -> deep escapes)
    q = np.zeros((h, w), np.int16)
    # nonzeros concentrated at block starts (zigzag-prefix-friendly, like
    # real low-frequency-dominant coefficients) so qt stays under the cap
    blocks = q.reshape(h // bs, bs, w // bs, bs).swapaxes(1, 2)
    blocks[:, :, 0, : 3] = rng.integers(-200 if esc_heavy else -12,
                                        201 if esc_heavy else 13,
                                        (h // bs, w // bs, 3))
    vals2, lens, total, qe4, qn4, qe, qn = PK.pack_qdct(
        jnp.asarray(q), bs, cap, jnp.int16, q4=True)
    ref_vals, ref_lens, ref_total = PK.pack_qdct(jnp.asarray(q), bs, cap,
                                                 jnp.int16)
    assert int(total) == int(ref_total) <= cap
    assert int(qn4) <= PK.q4e_cap(cap)
    assert int(qn) <= PK.qe_cap(cap)
    # level-2 entries = values outside {0, +-1}; level-3 = |v| > 7
    ref = np.asarray(ref_vals)[: int(total)]
    assert int(qn4) == int((np.abs(ref) >= 2).sum())
    assert int(qn) == int((np.abs(ref) > 7).sum())
    lay = PK.FrameLayout(h, w, bs, 2, True, True, q4=True)
    row = np.asarray(PK.pack_row(
        (jnp.zeros(h * w // 8, jnp.uint8),
         jnp.zeros(3 * lay.capk // 8, jnp.uint8), jnp.int32(0)),
        jnp.zeros(lay.cape, jnp.uint8),
        jnp.int32(0), jnp.zeros(3 + 2 * lay.nbr, jnp.int32),
        jnp.zeros(3 * nb, jnp.int32), jnp.zeros(nb, jnp.uint8),
        vals2, lens, total,
        jnp.zeros(lay.cape, jnp.uint8),
        jnp.int32(0), bs=bs, qe4=qe4, qn4=qn4, qe=qe, qn=qn))
    f = lay.split(row)
    assert f["qn"] == int(qn) and f["qn4"] == int(qn4)
    n = int(total)
    assert np.array_equal(PK.qv_of(f)[:n], ref)
    out = PK.unpack_qdct(PK.qv_of(f), f["ql"], h, w, bs,
                         zigzag_indices(bs))
    assert np.array_equal(out, q)


@pytest.mark.parametrize("odd_nb", [False, True])
@pytest.mark.parametrize("mv8", [False, True])
def test_frame_bytes_roundtrip(odd_nb, mv8):
    """pack_row (device bitcast+concat) and FrameLayout.split (host views)
    must invert each other, including byte order of i16/i32 fields, the
    bit-packed modes padding, and the int8-MV layout variant."""
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    h, w, bs = 32, (56 if odd_nb else 64), 8  # 7x4=28 blocks vs 8x4=32
    nbr = h // bs
    nb = nbr * (w // bs)
    lay = PK.FrameLayout(h, w, bs, 2, True, True, mv8)
    jb = rng.integers(0, 256, h * w // 8).astype(np.uint8)
    jk = rng.integers(0, 256, 3 * lay.capk // 8).astype(np.uint8)
    jn = np.int32(rng.integers(0, lay.capk))
    re = rng.integers(0, 256, lay.cape).astype(np.uint8)
    rn = np.int32(42)
    meta = rng.integers(-2 ** 30, 2 ** 30, 3 + 2 * nbr).astype(np.int32)
    mv = rng.integers(-128 if mv8 else -3000, 128 if mv8 else 3000,
                      3 * nb).astype(np.int32)
    modes = rng.integers(0, 2, nb).astype(np.uint8)
    qv = rng.integers(-3000, 3000, lay.capq).astype(np.int16)
    ql = rng.integers(0, 64, nb).astype(np.int32)
    qt = np.int32(12345)
    ae = rng.integers(0, 256, lay.cape).astype(np.uint8)
    an = np.int32(-7)
    buf = np.asarray(PK.pack_row(
        (jnp.asarray(jb), jnp.asarray(jk), jnp.asarray(jn)),
        jnp.asarray(re), jnp.asarray(rn),
        jnp.asarray(meta), jnp.asarray(mv),
        jnp.asarray(modes), jnp.asarray(qv), jnp.asarray(ql), jnp.asarray(qt),
        jnp.asarray(ae), jnp.asarray(an), bs=bs, mv8=mv8))
    assert buf.shape == (lay.total,)
    f = lay.split(buf)
    assert np.array_equal(PK.joint_states_of(f), PK.host_joint_decode(jb, jk, h * w))
    assert f["jn"] == int(jn)
    assert np.array_equal(f["re"], re)
    assert f["rn"] == 42
    assert np.array_equal(f["meta"], meta)
    assert np.array_equal(f["mv"], mv)
    assert f["mv"].dtype == (np.int8 if mv8 else np.int16)
    assert np.array_equal(f["modes"], modes)
    assert np.array_equal(PK.qv_of(f), qv)
    assert np.array_equal(f["ql"], ql)  # travels u8 at bs 8 (scan <= 64)
    assert f["qt"] == 12345 and f["an"] == -7
    assert np.array_equal(f["ae"], ae)


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_recon_guess_device_host_identity(bs):
    """The integer-exact reconstruction guess must be BIT-identical between
    the device kernel and the NumPy twin — the compact transfer's recon
    correction codes depend on it."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    h, w = 4 * bs, 6 * bs
    nbr = h // bs
    max_q = 255 * bs  # worst-case quantized coefficient magnitude
    qdct = rng.integers(-max_q, max_q + 1, (h, w)).astype(np.int16)
    row_qps = rng.integers(0, int(np.log2(bs)) + 8, nbr).astype(np.int32)
    pred = rng.integers(0, 256, (h, w)).astype(np.int32)
    dev = PK.recon_guess_plane(jnp.asarray(qdct), jnp.asarray(row_qps),
                               jnp.asarray(pred), bs)
    host = PK.host_recon_guess(qdct, row_qps, pred, bs)
    assert np.array_equal(np.asarray(dev), host)


def test_recon_codes_roundtrip_inter():
    """Full-search P-frame: device recon codes + host guess reproduce the
    device reconstruction byte-for-byte."""
    import jax.numpy as jnp

    from basic_video_codec_tpu.models.pframe import pframe_encode

    rng = np.random.default_rng(12)
    bs, h, w = 8, 48, 64
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    prev = rng.integers(0, 256, (h, w)).astype(np.uint8)
    curr = np.roll(prev, (1, -2), axis=(0, 1)).astype(np.uint8)
    curr[10:20, 30:40] = rng.integers(0, 256, (10, 10))
    row_qps = np.full(nbr, 3, np.int32)
    recon, _, art, qdct, smalls = pframe_encode(
        jnp.asarray(curr), (jnp.asarray(prev),), (), jnp.asarray(row_qps),
        jnp.float32(0), jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.float32),
        jnp.int32(3), bs, 2, False, False, False, False,
    )
    mvs = np.asarray(smalls)[: 3 * nb].reshape(nbr, nbc, 3)
    pred = PK.host_pred_inter(prev, mvs.astype(np.int32), bs, False)
    guess = PK.host_recon_guess(np.asarray(qdct), row_qps, pred, bs)
    cap = PK.esc_cap(h, w)
    rc, re, rn = PK.pack_vs_base(recon, jnp.asarray(guess.astype(np.int32)), cap)
    assert int(rn) <= cap
    out = PK.unpack_vs_base(np.asarray(rc), np.asarray(re), guess)
    assert np.array_equal(out, np.asarray(recon))


def test_intra_recon_rebuild_matches_device():
    """I-frame: the sequential host rebuild (prediction chain + codes) must
    reproduce the device reconstruction byte-for-byte."""
    import jax.numpy as jnp

    from basic_video_codec_tpu.ops.intra import intra_encode_frame

    rng = np.random.default_rng(13)
    bs, h, w = 8, 48, 64
    nbr, nbc = h // bs, w // bs
    nb = nbr * nbc
    curr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    row_qps = rng.integers(1, 5, nbr).astype(np.int32)
    recon, _, _, qdct, smalls = intra_encode_frame(
        jnp.asarray(curr), jnp.asarray(row_qps), jnp.float32(0),
        jnp.zeros(1, jnp.int32), jnp.zeros(1, jnp.float32), jnp.int32(4),
        bs, False,
    )
    modes = np.asarray(smalls)[:nb].reshape(nbr, nbc)
    pred = PK.intra_pred_plane(recon, jnp.asarray(modes), bs)
    guess = PK.recon_guess_plane(qdct, jnp.asarray(row_qps), pred, bs)
    cap = PK.esc_cap(h, w)
    rc, re, rn = PK.pack_vs_base(recon, guess, cap)
    assert int(rn) <= cap
    out = PK.host_rebuild_intra_recon(
        np.asarray(qdct), modes, row_qps, np.asarray(rc), np.asarray(re), bs)
    assert np.array_equal(out, np.asarray(recon))


def test_mv_nibble_roundtrip():
    """mvn layouts pack (dx, dy) as one signed-nibble pair per block; the
    host expansion must reproduce every component in [-7, 7] exactly."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    lay = PK.FrameLayout(16, 16, 4, 1, True, True, mv8=True, mvk=2, mvn=True)
    nb = lay.nb
    mv = np.zeros((nb, 3), np.int32)
    mv[:, :2] = rng.integers(-7, 8, size=(nb, 2))
    mv[0, :2] = (-7, 7)
    mv[1, :2] = (7, -7)
    pairs = jnp.asarray(mv[:, :2].reshape(-1, 2))
    packed = np.asarray(((pairs[:, 0] & 15) | ((pairs[:, 1] & 15) << 4))
                        .astype(jnp.uint8))
    # splice the packed field into a zeroed head row and read it back
    buf = np.zeros(lay.total, np.uint8)
    s, e = lay.offsets["mv"]
    assert e - s == nb
    buf[s:e] = packed
    out = lay._mv(buf).reshape(-1, 3)
    np.testing.assert_array_equal(out[:, :2], mv[:, :2])
    assert (out[:, 2] == 0).all()


def test_mv_nibble_safe_predicate():
    """The host predicate must match the device twin's formula
    (models/chunk.py: not fast and r2 <= 7, single reference)."""
    from basic_video_codec_tpu.config import EncoderConfig

    def ec(**kw):
        base = dict(block_size=8, search_range=2, I_Period=4,
                    quantization_factor=5, resolution=(64, 48))
        base.update(kw)
        return EncoderConfig(**base)

    assert PK.mv_nibble_safe(ec())
    assert PK.mv_nibble_safe(ec(search_range=3, fracMeEnabled=True))  # r2=6
    assert not PK.mv_nibble_safe(ec(search_range=4, fracMeEnabled=True))
    assert not PK.mv_nibble_safe(ec(search_range=8))
    assert not PK.mv_nibble_safe(ec(fastME=True))
    assert not PK.mv_nibble_safe(ec(nRefFrames=2))


def test_pipeline_overflow_fallback(tmp_path, monkeypatch):
    """Force tiny caps so every frame overflows: the pipeline must fall back
    to full-plane fetches and still produce byte-identical artifacts."""
    import filecmp

    from basic_video_codec_tpu.config import EncoderConfig, InputParameters
    from basic_video_codec_tpu.io.fileio import FileIOHelper
    from basic_video_codec_tpu.models import chunk as chunk_mod
    from basic_video_codec_tpu.models.pipeline import encode_video
    from basic_video_codec_tpu.tools import ygen

    W, H, N = 64, 48, 5
    y = ygen.moving_sequence(W, H, N, seed=7)

    def run(sub):
        d = tmp_path / sub
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), y)
        ec = EncoderConfig(8, 2, 3, 2, resolution=(W, H))
        p = InputParameters(str(d / "t.y"), W, H, ec, frames_to_process=N)
        encode_video(p, results_csv_path=None)
        return FileIOHelper(p, create_dirs=False)

    io_normal = run("normal")
    # tiny caps -> every frame takes the overflow path; clear the jit caches
    # so the new cap values are actually traced in
    chunk_mod.encode_chunk.clear_cache()
    chunk_mod.encode_chunk_intra_only.clear_cache()
    monkeypatch.setattr(PK, "qdct_caps", lambda nb, bs, qfrac=None: 8)
    monkeypatch.setattr(PK, "esc_cap", lambda h, w: 8)
    try:
        io_tiny = run("tiny")
        for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                    "get_quant_dct_coff_fh_file_name",
                    "get_residual_w_mc_file_name"):
            assert filecmp.cmp(getattr(io_normal, get)(), getattr(io_tiny, get)(),
                               shallow=False), get
    finally:
        chunk_mod.encode_chunk.clear_cache()
        chunk_mod.encode_chunk_intra_only.clear_cache()


@pytest.mark.parametrize("cfg", [
    dict(),                                    # nibble qdct would need qp>=5
    dict(quantization_factor=6),               # q4 nibble stream + escapes
    dict(fracMeEnabled=True),                  # half-pel prediction planes
    dict(nRefFrames=3),                        # reference-stack indexing
    dict(block_size=16, search_range=1, fastME=True, RCflag=3,
         targetBR=240_000, quantization_factor=5),  # two_pass layout (bs 16)
], ids=["base", "q4", "frac", "nref3", "two_pass_bs16"])
def test_fused_rebuild_matches_staged(tmp_path, monkeypatch, cfg):
    """The fused native rebuild (bvc_rebuild_p) must produce byte-identical
    artifacts to the staged per-stage chain it replaces."""
    import filecmp

    from basic_video_codec_tpu.config import EncoderConfig, InputParameters
    from basic_video_codec_tpu.io.fileio import FileIOHelper
    from basic_video_codec_tpu.models import pipeline as pl
    from basic_video_codec_tpu.models.pipeline import encode_video
    from basic_video_codec_tpu.tools import ygen

    W, H, N = 64, 48, 7
    y = ygen.moving_sequence(W, H, N, seed=13)

    def run(sub):
        d = tmp_path / sub
        d.mkdir()
        ygen.write_y_file(str(d / "t.y"), y)
        base = dict(block_size=8, search_range=2, I_Period=4,
                    quantization_factor=3, resolution=(W, H))
        base.update(cfg)
        ec = EncoderConfig(**base)
        if ec.RCflag:
            from test_property_conformance import _table_for

            ec.rc_lookup_table = _table_for(ec.block_size)
        p = InputParameters(str(d / "t.y"), W, H, ec, frames_to_process=N)
        encode_video(p, results_csv_path=None)
        return FileIOHelper(p, create_dirs=False)

    io_fused = run("fused")
    monkeypatch.setattr(pl, "_can_fuse_rebuild",
                        lambda *a, **k: False)
    io_staged = run("staged")
    for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                "get_quant_dct_coff_fh_file_name",
                "get_residual_w_mc_file_name",
                "get_residual_wo_mc_file_name", "get_mv_file_name"):
        assert filecmp.cmp(getattr(io_fused, get)(), getattr(io_staged, get)(),
                           shallow=False), get


def test_qcap_fraction_classes():
    """Prefix-cap sizing classes (measured qt peaks): RC
    carries 3/8 (budget feedback bounds prefixes); fixed qp>=5 reaches
    ~49% at block 16 / r=1 (5/8); fixed qp 3-4 reach ~53% at r=4 (3/4);
    fixed qp<=2 can fill the plane (whole-plane cap — overflow
    impossible)."""
    from basic_video_codec_tpu.config import EncoderConfig

    def ec(**kw):
        base = dict(block_size=16, search_range=2, I_Period=8,
                    quantization_factor=5, resolution=(64, 48))
        base.update(kw)
        return EncoderConfig(**base)

    assert PK.qcap_fraction(ec()) == (5, 8)
    # RC classes by budget density (bits per coefficient per frame):
    # 64x48 plane at 30 fps -> b = targetBR / 92160
    assert PK.qcap_fraction(ec(RCflag=1, targetBR=40_000,
                               quantization_factor=2)) == (3, 8)  # b=0.43
    assert PK.qcap_fraction(ec(RCflag=1, targetBR=70_000,
                               quantization_factor=2)) == (3, 4)  # b=0.76
    assert PK.qcap_fraction(ec(RCflag=1, targetBR=200_000,
                               quantization_factor=2)) == (1, 1)  # b=2.2
    assert PK.qdct_nibble_safe(ec(RCflag=1, targetBR=70_000,
                                  quantization_factor=2))
    assert not PK.qdct_nibble_safe(ec(RCflag=1, targetBR=200_000,
                                      quantization_factor=2))
    assert PK.qcap_fraction(ec(quantization_factor=4)) == (3, 4)
    assert PK.qcap_fraction(ec(quantization_factor=3)) == (3, 4)
    assert PK.qcap_fraction(ec(quantization_factor=2)) == (1, 1)
    nb = (48 // 16) * (64 // 16)
    assert PK.qdct_caps(nb, 16, (1, 1)) == nb * 256  # whole plane


@pytest.mark.parametrize("q4", [False, True])
def test_tail_row_pool_roundtrip(q4):
    """Tail-mode transport: pack_row heads + pack_tail_pool must invert
    through FrameLayout.split — two-level bitmap inflation, pool field
    order [j1z, jbz, jk, re, ae, qv, qe], and used-size slicing from the
    head counts (sparse AND moderately dense bitmaps)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    h, w, bs = 32, 64, 8
    nbr = h // bs
    nb = nbr * (w // bs)
    lay = PK.FrameLayout(h, w, bs, 2, True, True, q4=q4, tail=True)
    K = 3
    heads, tails_dev = [], []
    want = []
    for k in range(K):
        # densities spanning all-zero, clustered-sparse, and ~20% bitmaps
        dens = [0.0, 0.02, 0.2][k]
        jb_bits = (rng.random(h * w) < dens)
        jb = np.packbits(jb_bits, bitorder="little")
        jn = np.int32(jb_bits.sum())
        jk = rng.integers(0, 256, 3 * lay.capk // 8).astype(np.uint8)
        rn, an = np.int32(rng.integers(0, 9)), np.int32(rng.integers(0, 9))
        re = rng.integers(0, 256, lay.cape).astype(np.uint8)
        ae = rng.integers(0, 256, lay.cape).astype(np.uint8)
        meta = rng.integers(-2 ** 30, 2 ** 30, 3 + 2 * nbr).astype(np.int32)
        mv = rng.integers(-3000, 3000, 3 * nb).astype(np.int32)
        modes = rng.integers(0, 2, nb).astype(np.uint8)
        qt = np.int32(rng.integers(0, lay.capq))
        if q4:
            qv = rng.integers(0, 256, lay.capq // 4).astype(np.uint8)
            qe4 = rng.integers(0, 256, lay.capq4 // 2).astype(np.uint8)
            qn4 = np.int32(rng.integers(0, lay.capq4))
            qe = rng.integers(-3000, 3000, lay.capqe).astype(np.int16)
            qn = np.int32(rng.integers(0, lay.capqe))
        else:
            qv = rng.integers(-3000, 3000, lay.capq).astype(np.int16)
            qe4, qn4, qe, qn = None, None, None, None
        ql = rng.integers(0, 64, nb).astype(np.int32)
        j2, j1z, j1n, jbz, jbn = (np.asarray(a) for a in PK.split_bitmap(
            jnp.asarray(jb)))
        head = PK.pack_row(
            (jnp.asarray(j2), jnp.asarray(j1n), jnp.asarray(jbn),
             jnp.asarray(jn)),
            jnp.asarray(re), jnp.asarray(rn), jnp.asarray(meta),
            jnp.asarray(mv), jnp.asarray(modes), jnp.asarray(qv),
            jnp.asarray(ql), jnp.asarray(qt),
            jnp.asarray(ae), jnp.asarray(an), bs=bs,
            qe4=jnp.asarray(qe4) if q4 else None,
            qn4=jnp.asarray(qn4) if q4 else None,
            qe=jnp.asarray(qe) if q4 else None,
            qn=jnp.asarray(qn) if q4 else None, tail=True)
        heads.append(np.asarray(head))
        tails_dev.append((jk, qv, qe, jn, qt, qn, jbz, jbn, j1z, j1n,
                          re, rn, ae, an, qe4, qn4))
        want.append(dict(jb=jb, jk=jk, jn=int(jn), re=re[: int(rn)],
                         rn=int(rn), ae=ae[: int(an)], an=int(an),
                         meta=meta, mv=mv, modes=modes, qv=qv, ql=ql,
                         qt=int(qt), qe=qe, qn=int(qn) if q4 else 0,
                         qe4=qe4, qn4=int(qn4) if q4 else 0))
    import jax
    stk = lambda i: jnp.asarray(np.stack([t[i] for t in tails_dev]))
    zk = jnp.zeros(K, jnp.int32)
    pool = np.asarray(PK.pack_tail_pool(
        lay, stk(0), stk(1), stk(2) if q4 else None, stk(3), stk(4),
        stk(5) if q4 else zk, stk(6), stk(7),
        stk(8), stk(9), res=stk(10), rns=stk(11), aes=stk(12),
        ans=stk(13), qe4s=stk(14) if q4 else None,
        qn4s=stk(15) if q4 else zk))
    pos = 0
    for k in range(K):
        head = heads[k]
        assert head.shape == (lay.total,)
        u = lay.tail_sizes(*lay.head_counts(head))
        seg = pool[pos : pos + sum(u)]
        pos += sum(u)
        f = lay.split(head, seg)
        wk = want[k]
        assert np.array_equal(f["jb"], wk["jb"])
        assert f["jn"] == wk["jn"] and f["rn"] == wk["rn"]
        assert np.array_equal(f["jk"][: 3 * ((wk["jn"] + 7) // 8)],
                              wk["jk"][: 3 * ((wk["jn"] + 7) // 8)])
        assert np.array_equal(f["re"], wk["re"])
        assert np.array_equal(f["ae"], wk["ae"])
        assert np.array_equal(f["meta"], wk["meta"])
        assert np.array_equal(f["mv"], wk["mv"])
        assert np.array_equal(f["modes"], wk["modes"])
        assert f["qt"] == wk["qt"] and f["qn"] == wk["qn"]
        assert f["qn4"] == wk["qn4"]
        if q4:
            nqv = (min(wk["qt"], lay.capq) + 3) // 4
            assert np.array_equal(f["qv_raw"][:nqv], wk["qv"][:nqv])
            nq4 = (min(wk["qn4"], lay.capq4) + 1) // 2
            assert np.array_equal(f["qe4_raw"][:nq4], wk["qe4"][:nq4])
            assert np.array_equal(
                f["qe_raw"].view(np.int16)[: wk["qn"]], wk["qe"][: wk["qn"]])
        else:
            nqv = min(wk["qt"], lay.capq)
            assert np.array_equal(f["qv_raw"].view(np.int16)[:nqv],
                                  wk["qv"][:nqv])


def test_tail_mvd_roundtrip():
    """mvd transport (nibble-safe MV + tail mode): the head's
    changed-vs-previous bitmap + pooled changed bytes must invert through
    FrameLayout.split for all-zero, piecewise-constant and dense MV
    fields (forward-fill semantics, zero before the first change)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(13)
    h, w, bs = 32, 64, 8
    nbr = h // bs
    nb = nbr * (w // bs)
    lay = PK.FrameLayout(h, w, bs, 2, True, True, tail=True, mvk=2,
                         mvn=True)
    assert lay.mvd
    K = 3
    heads, tails_dev, want = [], [], []
    for k in range(K):
        jb = np.zeros(h * w // 8, np.uint8)
        jn = np.int32(0)
        jk = np.zeros(3 * lay.capk // 8, np.uint8)
        rn = an = np.int32(0)
        re = np.zeros(lay.cape, np.uint8)
        ae = np.zeros(lay.cape, np.uint8)
        meta = rng.integers(-2 ** 30, 2 ** 30, 3 + 2 * nbr).astype(np.int32)
        if k == 0:
            mv2 = np.zeros((nb, 2), np.int32)          # intra-row zeros
        elif k == 1:                                    # piecewise-constant
            mv2 = np.repeat(rng.integers(-8, 8, (nb // 8 + 1, 2)),
                            8, axis=0)[:nb].astype(np.int32)
        else:                                           # every block changes
            mv2 = rng.integers(-8, 8, (nb, 2)).astype(np.int32)
            # alternate x between -1 and 1 so every packed byte differs
            # from its predecessor: the dense worst case (mn == nb),
            # asserted below
            mv2[:, 0] = (np.arange(nb, dtype=np.int32) % 2) * 2 - 1
        qv = rng.integers(-3000, 3000, lay.capq).astype(np.int16)
        ql = rng.integers(0, 64, nb).astype(np.int32)
        qt = np.int32(rng.integers(0, lay.capq))
        modes = rng.integers(0, 2, nb).astype(np.uint8)
        j2, j1z, j1n, jbz, jbn = (np.asarray(a) for a in PK.split_bitmap(
            jnp.asarray(jb)))
        bm, mn, mvz = (np.asarray(a) for a in PK.pack_mv_delta(
            jnp.asarray(mv2.reshape(-1))))
        if k == 2:
            assert int(mn) == nb  # the dense worst case really is dense
        head = np.asarray(PK.pack_row(
            (jnp.asarray(j2), jnp.asarray(j1n), jnp.asarray(jbn),
             jnp.asarray(jn)),
            jnp.asarray(re), jnp.asarray(rn), jnp.asarray(meta),
            (jnp.asarray(bm), jnp.asarray(mn)), jnp.asarray(modes),
            jnp.asarray(qv), jnp.asarray(ql), jnp.asarray(qt),
            jnp.asarray(ae), jnp.asarray(an), bs=bs, mvn=True, tail=True))
        heads.append(head)
        tails_dev.append((jk, qv, jn, qt, jbz, jbn, j1z, j1n, re, rn,
                          ae, an, mvz, mn))
        exp = np.zeros((nb, 3), np.int16)
        exp[:, :2] = mv2
        want.append(dict(mv=exp.reshape(-1), meta=meta, modes=modes,
                         mn=int(mn)))
    stk = lambda i: jnp.asarray(np.stack([t[i] for t in tails_dev]))
    zk = jnp.zeros(K, jnp.int32)
    pool = np.asarray(PK.pack_tail_pool(
        lay, stk(0), stk(1), None, stk(2), stk(3), zk, stk(4), stk(5),
        stk(6), stk(7), res=stk(8), rns=stk(9), aes=stk(10), ans=stk(11),
        mvzs=stk(12), mns=stk(13)))
    pos = 0
    for k in range(K):
        u = lay.tail_sizes(*lay.head_counts(heads[k]))
        seg = pool[pos : pos + sum(u)]
        pos += sum(u)
        f = lay.split(heads[k], seg)
        assert np.array_equal(f["mv"], want[k]["mv"]), k
        assert np.array_equal(f["meta"], want[k]["meta"])
        assert np.array_equal(f["modes"], want[k]["modes"])
        assert u[-1] == min(want[k]["mn"], nb)
    assert pos <= K * PK.tail_pool_cap(lay)


def test_compact_stream_sort_scatter_parity(monkeypatch):
    """The sort- and scatter-based compact_stream implementations must be
    byte-identical (the GPU backend runs sort, the CPU backend scatter —
    both feed the same host parsers and cross-backend artifact tests)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    for n, cap, dens in ((1024, 768, 0.3), (4096, 4096, 0.02),
                         (520, 64, 0.9), (256, 256, 0.0)):
        keep = jnp.asarray(rng.random(n) < dens)
        p8 = jnp.asarray(rng.integers(0, 256, n), dtype=jnp.uint8)
        p16 = jnp.asarray(rng.integers(-3000, 3000, n), dtype=jnp.int16)
        outs = {}
        for mode in ("0", "1"):
            monkeypatch.setattr(PK, "_use_sort_compaction",
                                lambda m=mode: m == "1")
            outs[mode] = PK.compact_stream(keep, (p8, p16), cap)
        for a, b in zip(outs["0"], outs["1"]):
            assert np.array_equal(np.asarray(a), np.asarray(b)), (n, cap)


def test_pack_qdct_and_joint_sort_scatter_parity(monkeypatch):
    """Whole-packer parity between the two compaction implementations:
    pack_qdct (q4 three-level split), pack_joint, split_bitmap,
    pack_mv_delta over random content."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    h, w, bs = 64, 96, 8
    nb = (h // bs) * (w // bs)
    q = _random_qdct(rng, h, w, bs, density=0.25, lo=-40, hi=40)
    capq = PK.qdct_caps(nb, bs, (3, 8))
    recon = rng.integers(0, 256, (h, w)).astype(np.uint8)
    gr = (recon.astype(np.int32)
          + rng.integers(-2, 3, (h, w))).astype(np.int32)
    art = rng.integers(0, 256, (h, w)).astype(np.uint8)
    ga = (art.astype(np.int32) + rng.integers(-2, 3, (h, w))).astype(np.int32)
    jb = (rng.integers(0, 256, h * w // 8)
          * (rng.random(h * w // 8) < 0.2)).astype(np.uint8)
    mv = rng.integers(-7, 8, 2 * nb).astype(np.int32)
    outs = {}
    for mode in ("0", "1"):
        monkeypatch.setattr(PK, "_use_sort_compaction",
                            lambda m=mode: m == "1")
        outs[mode] = (
            PK.pack_qdct(jnp.asarray(q), bs, capq, jnp.int16, True)
            + PK.pack_joint(jnp.asarray(recon), jnp.asarray(gr),
                            jnp.asarray(art), jnp.asarray(ga),
                            PK.esc_cap(h, w))
            + PK.split_bitmap(jnp.asarray(jb))
            + PK.pack_mv_delta(jnp.asarray(mv))
        )
    for i, (a, b) in enumerate(zip(outs["0"], outs["1"])):
        assert np.array_equal(np.asarray(a), np.asarray(b)), i


@pytest.mark.parametrize("backend,sort", [("cpu", False), ("gpu", True)])
def test_compaction_choice_by_backend(monkeypatch, backend, sort):
    """Sort compaction on the GPU (a dump-slot scatter is orders of
    magnitude slower there), scatter on the CPU."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert PK._use_sort_compaction() is sort
