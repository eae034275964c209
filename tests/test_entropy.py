"""Symbol-level entropy codec tests (model: reference tests/test_entropy_encoder.py)."""

import numpy as np
import pytest

from basic_video_codec_tpu.entropy import (
    EOB_MARKER,
    BitWriter,
    exp_golomb_decode,
    exp_golomb_encode,
    exp_golomb_length,
    symbols_bit_length,
    symbols_to_bits,
    decode_symbols,
    rle_decode,
    rle_encode,
    rle_encode_blocks,
    zigzag_order,
    inverse_zigzag_order,
)
from basic_video_codec_tpu.entropy.zigzag import zigzag_indices


def bits_str(bits):
    return "".join(str(int(b)) for b in bits)


class TestExpGolomb:
    @pytest.mark.parametrize(
        "value,expected",
        [
            (0, "1"),       # mapped 0 -> 1
            (1, "010"),     # mapped 1 -> 2
            (-1, "011"),    # mapped 2 -> 3
            (2, "00100"),   # mapped 3 -> 4
            (-2, "00101"),
            (3, "00110"),
        ],
    )
    def test_known_codewords(self, value, expected):
        assert bits_str(exp_golomb_encode(value)) == expected
        assert exp_golomb_length(value) == len(expected)

    @pytest.mark.parametrize("value", list(range(-70, 71)) + [EOB_MARKER, -8190, 5000])
    def test_round_trip(self, value):
        bits = exp_golomb_encode(value)
        decoded, pos = exp_golomb_decode(bits, 0)
        assert decoded == value
        assert pos == bits.shape[0]

    def test_padding_tolerance(self):
        # <8 trailing zero bits are treated as byte padding -> (None, None)
        bits = np.zeros(7, dtype=np.uint8)
        assert exp_golomb_decode(bits, 0) == (None, None)

    def test_prefix_error(self):
        with pytest.raises(ValueError):
            exp_golomb_decode(np.zeros(9, dtype=np.uint8), 0)

    def test_vectorized_matches_scalar(self):
        rng = np.random.default_rng(0)
        symbols = rng.integers(-5000, 5000, size=500)
        expected = np.concatenate([exp_golomb_encode(int(s)) for s in symbols])
        got = symbols_to_bits(symbols)
        assert np.array_equal(got, expected)
        lengths = symbols_bit_length(symbols)
        assert lengths.sum() == expected.shape[0]
        assert all(exp_golomb_length(int(s)) == int(l) for s, l in zip(symbols, lengths))

    def test_stream_decode(self):
        symbols = [0, 5, -3, 8190, 1, -1, 120]
        w = BitWriter()
        w.extend(symbols_to_bits(np.asarray(symbols)))
        bits = np.unpackbits(np.frombuffer(w.tobytes(), dtype=np.uint8))
        decoded, _ = decode_symbols(bits)
        assert decoded == symbols


class TestRLE:
    def test_known_encoding(self):
        coeffs = [0, 0, 3, -2, 0, 0, 0, 1, 0, 0]
        # 2 zeros, 2 literals, 3 zeros, 1 literal, trailing zeros -> 0
        assert rle_encode(coeffs) == [2, -2, 3, -2, 3, -1, 1, 0]

    def test_all_zero(self):
        assert rle_encode([0, 0, 0, 0]) == [0]

    def test_ends_nonzero(self):
        assert rle_encode([0, 5, 7]) == [1, -2, 5, 7]

    def test_round_trip(self):
        rng = np.random.default_rng(1)
        for _ in range(50):
            coeffs = rng.integers(-4, 5, size=64) * (rng.random(64) < 0.3)
            enc = rle_encode(list(coeffs))
            dec = rle_decode(enc)
            dec = dec + [0] * (64 - len(dec))
            assert list(coeffs) == dec

    def test_vectorized_blocks_match_scalar(self):
        rng = np.random.default_rng(2)
        for density in (0.0, 0.1, 0.5, 1.0):
            blocks = (rng.integers(-30, 31, size=(20, 64))
                      * (rng.random((20, 64)) < density)).astype(np.int64)
            expected = []
            for b in blocks:
                expected.extend(rle_encode(list(b)))
                expected.append(EOB_MARKER)
            got = rle_encode_blocks(blocks)
            assert got.tolist() == expected


class TestZigzag:
    def test_4x4_order(self):
        m = np.arange(16).reshape(4, 4)
        # reference diagonal traversal: s even -> (i, s-i), s odd -> (s-i, i)
        expected = [0, 4, 1, 2, 5, 8, 12, 9, 6, 3, 7, 10, 13, 14, 11, 15]
        assert [int(v) for v in zigzag_order(m)] == expected

    @pytest.mark.parametrize("n", [2, 4, 8, 16])
    def test_round_trip(self, n):
        rng = np.random.default_rng(n)
        m = rng.integers(-100, 100, size=(n, n))
        zz = zigzag_order(m)
        back = inverse_zigzag_order(zz, n)
        assert np.array_equal(np.asarray(back), m)

    def test_indices_permutation(self):
        for n in (2, 4, 8, 16):
            idx = zigzag_indices(n)
            assert sorted(idx.tolist()) == list(range(n * n))

    @pytest.mark.parametrize("n", [8, 16])
    def test_device_zigzag_rows_match_reference(self, n):
        """ops/bitlen.zigzag_rows (the device scan order used for bit
        pricing and packing) equals the reference zigzag of every block."""
        import jax.numpy as jnp

        from basic_video_codec_tpu.ops.bitlen import zigzag_rows

        rng = np.random.default_rng(n)
        blocks = rng.integers(-2040, 2040, size=(3, 5, n, n)).astype(np.int16)
        got = np.asarray(zigzag_rows(jnp.asarray(blocks.reshape(3, 5, n * n)), n))
        want = np.array([[zigzag_order(b) for b in row] for row in blocks])
        assert got.dtype == np.int32
        assert np.array_equal(got, want)
