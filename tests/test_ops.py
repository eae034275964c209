"""Kernel-level conformance: device ops vs the golden (reference-exact) model.

Decision-making ops (motion search, intra mode, entropy pricing, gathers,
interpolation) must match golden EXACTLY — they are integer/ordering logic.
The float DCT matches to the documented tolerance (ops/transform.py):
quantized coefficients within ±1 on a small fraction of entries, and
everything downstream of identical coefficients is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from basic_video_codec_tpu.config import EncoderConfig
from basic_video_codec_tpu.entropy import EOB_MARKER, rle_encode, symbols_bit_length
from basic_video_codec_tpu.entropy.zigzag import zigzag_indices
from basic_video_codec_tpu.golden import dct as gdct
from basic_video_codec_tpu.golden import me as gme
from basic_video_codec_tpu.golden.interp import build_pre_interpolated_buffer
from basic_video_codec_tpu.ops import bitlen as B
from basic_video_codec_tpu.ops import transform as T
from basic_video_codec_tpu.ops.fastme import fast_search_frame
from basic_video_codec_tpu.ops.interp import build_half_pel
from basic_video_codec_tpu.ops.me import full_search, gather_pred_blocks
from basic_video_codec_tpu.tools import ygen


class TestTransform:
    @pytest.mark.parametrize("bs,qp", [(8, 0), (8, 4), (16, 2), (16, 11), (4, 1)])
    def test_quantized_coeffs_tolerance(self, bs, qp):
        rng = np.random.default_rng(bs + qp)
        res = rng.integers(-255, 256, size=(100, bs, bs)).astype(np.int16)
        q, _ = T.encode_blocks(jnp.asarray(res), bs, qp)
        gq = np.stack([gdct.apply_dct_and_quantization(r, bs, qp)[0] for r in res])
        diff = np.abs(np.asarray(q) - gq)
        assert diff.max() <= 1, "device DCT may differ from scipy only at rounding edges"
        assert (diff > 0).mean() < 0.01

    @pytest.mark.parametrize("bs,qp", [(8, 0), (8, 4), (16, 5)])
    def test_reconstruct_tolerance_given_same_coeffs(self, bs, qp):
        """Reconstruction shares the float-DCT edge: the matmul IDCT and
        scipy's FFT IDCT differ by ~1e-4, so round(idct + pred) may flip by
        ±1 where the true value sits on a .5 boundary.  Within one backend the
        decoder is bit-exact (test_device_pipeline self-consistency)."""
        rng = np.random.default_rng(10 * bs + qp)
        res = rng.integers(-255, 256, size=(100, bs, bs)).astype(np.int16)
        pred = rng.integers(0, 256, size=(100, bs, bs)).astype(np.int16)
        Q = gdct.generate_quantization_matrix(bs, qp)
        gq = np.stack([gdct.apply_dct_and_quantization(r, bs, qp)[0] for r in res])
        recon, _ = T.decode_blocks(jnp.asarray(gq.astype(np.int16)), jnp.asarray(pred), bs, qp)
        grecon = np.stack([gdct.reconstruct_block(g, Q, p)[0] for g, p in zip(gq, pred)])
        diff = np.abs(np.asarray(recon).astype(int) - grecon.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.001


class TestInterp:
    def test_exact_vs_golden(self):
        rng = np.random.default_rng(3)
        f = rng.integers(0, 256, size=(24, 40)).astype(np.uint8)
        dev = np.asarray(build_half_pel(jnp.asarray(f)))
        assert np.array_equal(dev, build_pre_interpolated_buffer(f))


def _golden_full_frame(curr, refs, irefs, ec):
    bs = ec.block_size
    h, w = curr.shape
    mvs = np.zeros((h // bs, w // bs, 3), np.int32)
    for i in range(h // bs):
        for j in range(w // bs):
            block = curr[i * bs : (i + 1) * bs, j * bs : (j + 1) * bs].astype(np.int16)
            mv, _, _ = gme.full_search(block, (j * bs, i * bs), refs, irefs, ec)
            mvs[i, j] = mv
    return mvs


class TestFullSearch:
    @pytest.mark.parametrize("frac,nref", [(False, 1), (True, 1), (False, 2)])
    def test_decisions_exact(self, frac, nref):
        ec = EncoderConfig(block_size=8, search_range=2, I_Period=4,
                           quantization_factor=0, nRefFrames=nref, fracMeEnabled=frac)
        base = ygen.textured_frame(48, 40, seed=6)
        refs = [np.roll(base, s, axis=1) for s in range(nref)]
        irefs = [build_pre_interpolated_buffer(r) for r in refs]
        curr = np.roll(base, (1, -2), axis=(0, 1))
        mvs, sads, dev_preds = full_search(
            jnp.asarray(curr), jnp.asarray(np.stack(refs)),
            jnp.asarray(np.stack(irefs)), 8, 2, frac,
        )
        gmvs = _golden_full_frame(curr, refs, irefs, ec)
        assert np.array_equal(np.asarray(mvs), gmvs)

    def test_gather_matches_golden_extraction(self):
        ec = EncoderConfig(block_size=8, search_range=2, I_Period=4, quantization_factor=0)
        ref = ygen.textured_frame(48, 40, seed=7)
        irefs = [build_pre_interpolated_buffer(ref)]
        curr = np.roll(ref, 2, axis=0)
        mvs, _, dev_preds2 = full_search(jnp.asarray(curr), jnp.asarray(ref[None]),
                             jnp.asarray(np.stack(irefs)), 8, 2, False)
        preds = np.asarray(gather_pred_blocks(
            jnp.asarray(ref[None]), jnp.asarray(np.stack(irefs)), mvs, 8, False))
        # the fused select-accumulate prediction equals the explicit gather
        assert np.array_equal(np.asarray(dev_preds2), preds)
        mvs = np.asarray(mvs)
        for i in range(5):
            for j in range(5):
                g = gme.get_ref_block_at_mv(ref, irefs[0], (j * 8, i * 8),
                                            int(mvs[i, j, 0]), int(mvs[i, j, 1]), ec)
                assert np.array_equal(preds[i, j], g)


class TestFastME:
    @pytest.mark.parametrize("nref,frac", [(1, False), (2, False), (1, True)])
    def test_chained_decisions_exact(self, nref, frac):
        ec = EncoderConfig(block_size=8, search_range=4, I_Period=4,
                           quantization_factor=0, nRefFrames=nref,
                           fastME=True, fracMeEnabled=frac)
        base = ygen.textured_frame(48, 40, seed=8)
        refs = [np.roll(base, s + 1, axis=0) for s in range(nref)]
        irefs = [build_pre_interpolated_buffer(r) for r in refs]
        curr = np.roll(base, (2, 1), axis=(0, 1))

        mvs, sads, comps = fast_search_frame(
            jnp.asarray(curr), jnp.asarray(np.stack(refs)),
            jnp.asarray(np.stack(irefs)), 8, frac,
        )
        mvs, sads, comps = map(np.asarray, (mvs, sads, comps))

        mvp = (0, 0)
        for i in range(curr.shape[0] // 8):
            for j in range(curr.shape[1] // 8):
                block = curr[i * 8 : (i + 1) * 8, j * 8 : (j + 1) * 8].astype(np.int16)
                gmv, gmae, gcomp = gme.fast_search(block, (j * 8, i * 8), mvp, refs, irefs, ec, 0)
                assert tuple(mvs[i, j]) == tuple(gmv), (i, j)
                assert sads[i, j] / 64 == gmae
                assert comps[i, j] == gcomp
                mvp = gmv


class TestBitlen:
    def test_rle_block_bits_exact(self):
        rng = np.random.default_rng(9)
        zz = zigzag_indices(8)
        for density in (0.0, 0.2, 0.9):
            blocks = (rng.integers(-100, 101, size=(30, 64))
                      * (rng.random((30, 64)) < density)).astype(np.int32)
            scans = blocks[:, zz]
            dev = np.asarray(B.rle_block_bits(jnp.asarray(scans)))
            exact = np.array([
                symbols_bit_length(np.asarray(rle_encode(list(s)) + [EOB_MARKER])).sum()
                for s in scans
            ])
            assert np.array_equal(dev, exact)

    def test_golomb_len_matches_host(self):
        vals = np.arange(-9000, 9000, 7)
        dev = np.asarray(B.golomb_len(jnp.asarray(vals)))
        assert np.array_equal(dev, symbols_bit_length(vals))
