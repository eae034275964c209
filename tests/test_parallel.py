"""Multi-chip sharding tests on the 8-device virtual CPU mesh (conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from basic_video_codec_tpu.config import EncoderConfig
from basic_video_codec_tpu.golden import me as gme
from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
from basic_video_codec_tpu.ops.me import full_search
from basic_video_codec_tpu.parallel.gop import encode_gop, encode_gops_sharded
from basic_video_codec_tpu.parallel.mesh import make_mesh
from basic_video_codec_tpu.parallel.spatial import sharded_pframe_step
from basic_video_codec_tpu.tools import ygen

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")


class TestSpatialSharding:
    def test_matches_single_chip_full_search(self):
        """The halo-exchanged sharded step must produce the same MVs, SADs,
        recon and bit totals as the single-device kernels."""
        bs, r, qp = 8, 2, 4
        W, H, B = 64, 64, 2
        base = ygen.textured_frame(W, H, seed=13)
        ref = np.stack([base, np.roll(base, 3, axis=0)])
        curr = np.stack([np.roll(base, (2, -1), (0, 1)), np.roll(base, (1, 2), (0, 1))])

        mesh = make_mesh(8, data=2, space=4)
        step = sharded_pframe_step(mesh, bs, r, qp, h_total=H)
        recon, qdct, mvs, sads, fbits = jax.block_until_ready(
            step(jnp.asarray(curr), jnp.asarray(ref))
        )

        # single-chip reference result
        for b in range(B):
            irefs = jnp.asarray(np.stack([build_pre_interpolated_buffer(ref[b])]))
            mv1, sad1, _ = full_search(
                jnp.asarray(curr[b]), jnp.asarray(ref[b][None]), irefs, bs, r, False
            )
            assert np.array_equal(np.asarray(mvs)[b], np.asarray(mv1)[..., :2]), b
            assert np.array_equal(np.asarray(sads)[b], np.asarray(sad1)), b

    @pytest.mark.parametrize("frac", [False, True])
    def test_cif_scale_band_edge_winners(self, frac):
        """CIF frame over 4 space shards with vertical motion (+-3 px,
        crossing band boundaries): MVs, SADs and recon must match the
        single-device kernel everywhere, including blocks whose winning
        candidate lives in a neighbour's halo."""
        bs, r, qp = 8, 3, 5
        W, H = 352, 288
        base = ygen.textured_frame(W, H, seed=17)
        ref = np.stack([base])
        curr = np.stack([np.roll(base, (3, -2), (0, 1))])

        mesh = make_mesh(8, data=2, space=4)
        step = sharded_pframe_step(mesh, bs, r, qp, h_total=H, frac=frac)
        recon, qdct, mvs, sads, fbits = jax.block_until_ready(
            step(jnp.asarray(np.concatenate([curr, curr])),
                 jnp.asarray(np.concatenate([ref, ref])))
        )

        irefs = jnp.asarray(np.stack([build_pre_interpolated_buffer(ref[0])]))
        mv1, sad1, _ = full_search(
            jnp.asarray(curr[0]), jnp.asarray(ref[0][None]), irefs, bs, r, frac
        )
        assert np.array_equal(np.asarray(mvs)[0], np.asarray(mv1)[..., :2])
        assert np.array_equal(np.asarray(sads)[0], np.asarray(sad1))
        # some winners must actually cross band boundaries for this to test
        # the halo path
        band_rows = H // 4 // bs
        mv_np = np.asarray(mvs)[0]
        edge_rows = [band_rows - 1, band_rows, 2 * band_rows - 1, 2 * band_rows]
        assert (np.abs(mv_np[edge_rows, :, 1]) >= 1).any(), "no cross-band motion"

    def test_halo_preconditions_raise(self):
        mesh = make_mesh(8, data=1, space=8)
        with pytest.raises(ValueError, match="search_range"):
            sharded_pframe_step(mesh, 8, 9, 4, h_total=64)  # band height 8 < r 9
        with pytest.raises(ValueError, match="split evenly"):
            sharded_pframe_step(mesh, 8, 2, 4, h_total=68)
        with pytest.raises(ValueError, match="block multiple"):
            sharded_pframe_step(mesh, 8, 2, 4, h_total=72)  # bands of 9 rows

    def test_bits_psum_consistent(self):
        bs, r, qp = 8, 2, 4
        W, H = 64, 64
        base = ygen.textured_frame(W, H, seed=14)
        curr = np.stack([np.roll(base, 1, 1)])
        ref = np.stack([base])
        mesh = make_mesh(8, data=1, space=8)
        step = sharded_pframe_step(mesh, bs, r, qp, h_total=H)
        _, qdct, _, _, fbits = step(jnp.asarray(curr), jnp.asarray(ref))
        # recompute bits from the gathered qdct plane on one device
        from basic_video_codec_tpu.entropy import rle_encode_blocks, symbols_bit_length, EOB_MARKER
        from basic_video_codec_tpu.entropy.zigzag import zigzag_indices

        q = np.asarray(qdct)[0]
        blocks = q.reshape(H // bs, bs, W // bs, bs).swapaxes(1, 2).reshape(-1, bs * bs)
        syms = rle_encode_blocks(blocks[:, zigzag_indices(bs)].astype(np.int64))
        assert int(np.asarray(fbits)[0]) == int(symbols_bit_length(syms).sum())


class TestShardedEncodeVideo:
    """The product path: encode_video with parallel_gops > 1 must emit a
    byte-identical bitstream + artifact tree to the serial run (the batched
    program IS the serial chunk program, vmapped over GOPs and sharded over
    the data axis)."""

    @pytest.mark.parametrize("cfg", [
        dict(),                                      # fixed QP
        dict(RCflag=1, targetBR=480_000),            # RC1
        dict(fastME=True, fracMeEnabled=True),       # feature combo
        dict(I_Period=1),                            # all-intra GOPs
        dict(nRefFrames=3, exact_transform=True),    # rolling-stack GOPs
        # RC 2/3: the speculative GOP pipeline (parallel/rc_gop.py) — the
        # cross-GOP average-QP chain is speculated and re-dispatched on
        # mispredictions, so the artifact tree must still be byte-identical
        dict(RCflag=2, targetBR=480_000),            # RC2 two-pass
        dict(RCflag=3, targetBR=480_000, fastME=True),  # RC3 deliverable-style
        dict(RCflag=3, targetBR=240_000, nRefFrames=2),  # RC3 + rolling stack
    ], ids=["fixed_qp", "rc1", "fastme_frac", "intra_only", "nref3",
            "rc2", "rc3_fastme", "rc3_nref2"])
    def test_byte_identical_to_serial(self, tmp_path, cfg):
        import filecmp

        from basic_video_codec_tpu.config import EncoderConfig, InputParameters
        from basic_video_codec_tpu.io.fileio import FileIOHelper
        from basic_video_codec_tpu.models.pipeline import decode_video, encode_video

        W, H, N = 176, 144, 13  # 4+ GOPs at I_Period 4, ragged tail
        y = ygen.moving_sequence(W, H, N, seed=21)
        base = dict(block_size=8, search_range=2, I_Period=4,
                    quantization_factor=4, resolution=(W, H))
        base.update(cfg)
        ios = {}
        for sub, par in (("serial", 0), ("sharded", 8)):
            d = tmp_path / sub
            d.mkdir()
            ygen.write_y_file(str(d / "t.y"), y)
            ec = EncoderConfig(**base, parallel_gops=par)
            p = InputParameters(str(d / "t.y"), W, H, ec, frames_to_process=N)
            encode_video(p, results_csv_path=None)
            ios[sub] = FileIOHelper(p, create_dirs=False)
        for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                    "get_quant_dct_coff_fh_file_name",
                    "get_residual_w_mc_file_name",
                    "get_residual_wo_mc_file_name", "get_mv_file_name"):
            assert filecmp.cmp(getattr(ios["serial"], get)(),
                               getattr(ios["sharded"], get)(), shallow=False), get
        # metrics rows: all content columns identical (timing cols differ)
        import csv as _csv

        def rows(io):
            with open(io.get_metrics_csv_file_name()) as f:
                return [r[:7] for r in _csv.reader(f)]

        assert rows(ios["serial"]) == rows(ios["sharded"])
        # and the sharded stream decodes back to the recon (codec invariant)
        p = InputParameters(str(tmp_path / "sharded" / "t.y"), W, H,
                            EncoderConfig(**base), frames_to_process=N)
        decode_video(p)
        rec = np.fromfile(ios["sharded"].get_mc_reconstructed_file_name(), np.uint8)
        dec = np.fromfile(ios["sharded"].get_mc_decoded_file_name(), np.uint8)
        assert np.array_equal(rec, dec)

    def test_rc3_long_gop_spans_chunks(self, tmp_path, monkeypatch):
        """An RC3 GOP longer than MAX_CHUNK exercises the speculative
        pipeline's continuation-chunk path (parallel/rc_gop.py: the rolling
        reference stack and prev-avg chain carry ON DEVICE between a GOP's
        chunks) — still byte-identical to serial."""
        import filecmp

        from basic_video_codec_tpu.config import InputParameters
        from basic_video_codec_tpu.io.fileio import FileIOHelper
        from basic_video_codec_tpu.models import pipeline
        from basic_video_codec_tpu.models.pipeline import encode_video

        monkeypatch.setattr(pipeline, "MAX_CHUNK", 5)
        W, H, N = 176, 144, 16  # I_Period 7 -> chunks 5+2 inside each GOP
        y = ygen.camera_sequence(W, H, N, seed=9, cut_at=9)
        base = dict(block_size=16, search_range=2, I_Period=7,
                    quantization_factor=5, RCflag=3, targetBR=480_000,
                    resolution=(W, H))
        ios = {}
        for sub, par in (("serial", 0), ("sharded", 8)):
            d = tmp_path / sub
            d.mkdir()
            ygen.write_y_file(str(d / "t.y"), y)
            ec = EncoderConfig(**base, parallel_gops=par)
            p = InputParameters(str(d / "t.y"), W, H, ec, frames_to_process=N)
            encode_video(p, results_csv_path=None)
            ios[sub] = FileIOHelper(p, create_dirs=False)
        for get in ("get_encoded_file_name", "get_mc_reconstructed_file_name",
                    "get_mv_file_name"):
            assert filecmp.cmp(getattr(ios["serial"], get)(),
                               getattr(ios["sharded"], get)(),
                               shallow=False), get


class TestGopParallel:
    def test_encode_gop_self_consistent(self):
        frames = ygen.moving_sequence(48, 32, 4, seed=15)
        recon, qdct, mvs, bits = jax.block_until_ready(
            encode_gop(jnp.asarray(frames), bs=8, search_range=2, qp=3, frac=False)
        )
        assert recon.shape == frames.shape
        assert np.asarray(bits).min() > 0
        # first frame is intra: better-than-garbage reconstruction
        err = np.abs(np.asarray(recon)[0].astype(int) - frames[0].astype(int))
        assert err.mean() < 12

    def test_gops_sharded_over_data_axis(self):
        mesh = make_mesh(8, data=8, space=1)
        gops = np.stack([ygen.moving_sequence(48, 32, 3, seed=s) for s in range(8)])
        recon, qdct, mvs, bits = jax.block_until_ready(
            encode_gops_sharded(mesh, jnp.asarray(gops), bs=8, search_range=2, qp=3)
        )
        assert recon.shape == gops.shape
        # each GOP encodes identically to its unsharded encoding
        r1, q1, m1, b1 = encode_gop(jnp.asarray(gops[3]), bs=8, search_range=2, qp=3, frac=False)
        assert np.array_equal(np.asarray(recon)[3], np.asarray(r1))
        assert np.array_equal(np.asarray(bits)[3], np.asarray(b1))


class TestSeedPredictor:
    """The speculative RC pipeline's GOP-seed predictor (parallel/rc_gop.py):
    cold start from the RC-table/budget fixed point, non-blocking polling of
    in-flight exit scalars, and dual-seed dispatch on spare devices.  Round-3
    state (last-drained-realized only) missed 4/5 GOPs on the driver dryrun
    content because every GOP dispatches before the first drain."""

    W, H, N, I = 176, 144, 15, 3  # 5 GOPs of 3 frames

    def _run(self, tmp_path, frames, **cfg):
        from basic_video_codec_tpu.config import InputParameters
        from basic_video_codec_tpu.models import pipeline as pl
        from basic_video_codec_tpu.models.pipeline import encode_video

        y = str(tmp_path / "seq.y")
        ygen.write_y_file(y, frames)
        base = dict(block_size=16, search_range=2, I_Period=self.I,
                    quantization_factor=4, RCflag=3, targetBR=480_000,
                    resolution=(self.W, self.H), parallel_gops=8)
        base.update(cfg)
        p = InputParameters(y, self.W, self.H, EncoderConfig(**base),
                            frames_to_process=self.N)
        encode_video(p, results_csv_path=None)
        return dict(pl.LAST_RUN_STATS)

    def test_steady_content_zero_misses(self, tmp_path):
        """On steady content the exit average is constant; the predictor must
        never force a re-dispatch (the whole point of speculation)."""
        frames = ygen.moving_sequence(self.W, self.H, self.N, seed=5)
        stats = self._run(tmp_path, frames)
        assert stats["gops"] == 5
        assert len(stats["rc_seed_trace"]) == 4  # GOP 0 is exact, 1-4 speculate
        assert stats["rc_seed_misses"] == 0, stats["rc_seed_trace"]

    def test_drifting_content_bounded_misses(self, tmp_path):
        """The exit carry is a function of the per-row first-pass bit SHARES
        (uniform content pins it at the table fixed point regardless of
        amplitude — measured), so drift is manufactured by concentrating the
        frame's energy into fewer block rows each GOP: starved rows fall to
        the max table QP and the row-QP mean climbs.  The predictor (polled
        in-flight exits + the ±1-step dual-seed twin) must absorb it with at
        most one re-dispatch across the run."""
        rng = np.random.default_rng(7)
        frames = np.full((self.N, self.H, self.W), 128, np.uint8)
        for i in range(self.N):
            k_rows = max(9 - 2 * (i // self.I), 1)  # 9,7,5,3,1 noisy rows
            band = k_rows * 16
            frames[i, :band] = rng.integers(
                0, 256, size=(band, self.W), dtype=np.uint8)
        stats = self._run(tmp_path, frames)
        trues = [t for _, _, t in stats["rc_seed_trace"]]
        assert len(set(trues)) > 1, f"content failed to drift: {trues}"
        assert stats["rc_seed_misses"] <= 1, stats["rc_seed_trace"]


def test_parallel_gops_beyond_devices_is_an_error(tmp_path):
    """parallel_gops asks for one GOP per device; more than JAX sees is an
    error, never a silent cap."""
    import jax

    from basic_video_codec_tpu.config import EncoderConfig, InputParameters
    from basic_video_codec_tpu.models.pipeline import encode_video

    n = len(jax.devices()) + 1
    y = tmp_path / "t.y"
    ygen.write_y_file(str(y), ygen.moving_sequence(64, 48, 4, seed=1))
    ec = EncoderConfig(8, 2, 2, 4, resolution=(64, 48), parallel_gops=n)
    with pytest.raises(ValueError, match="parallel_gops"):
        encode_video(InputParameters(str(y), 64, 48, ec, frames_to_process=4),
                     results_csv_path=None)
