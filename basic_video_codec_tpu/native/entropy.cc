// Native entropy codec for basic_video_codec_tpu.
//
// Exp-Golomb bit packing/parsing and RLE block expansion are the only
// inherently-sequential, variable-length parts of the codec (reference
// encoder/entropy_encoder.py semantics); everything else runs on device.
// These run on host as tight C loops, exposed via a plain C ABI for ctypes.
//
// Bitstream format (bit-compatible with the reference):
//   signed map: v <= 0 -> -2v, v > 0 -> 2v-1; codeword for mapped m is
//   (n-1) zero bits + n-bit binary of (m+1), MSB first.
//   RLE symbols per block scan: +n = n zeros, -n = n literals follow,
//   0 = rest-of-block zeros; EOB marker terminates each block.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline void put_bits(uint8_t* buf, int64_t& pos, uint64_t value, int nbits) {
  for (int i = nbits - 1; i >= 0; --i) {
    buf[pos >> 3] |= uint8_t(((value >> i) & 1ull) << (7 - (pos & 7)));
    ++pos;
  }
}

// Streaming MSB-first bit writer: codewords accumulate left-aligned in a
// 64-bit register and flush whole bytes — ~10x fewer memory ops than the
// per-bit put_bits loop.  Codewords here are <= 33 bits (int16 coefficient
// -> mapped+1 <= 2^17 -> 2*17-1), so nacc + nbits <= 7 + 33 < 64 always.
struct BitWriter {
  uint8_t* out;
  int64_t cap_bytes;
  int64_t nbytes = 0;
  uint64_t acc = 0;
  int nacc = 0;
  inline bool put(uint64_t value, int nbits) {
    acc |= value << (64 - nacc - nbits);
    nacc += nbits;
    while (nacc >= 8) {
      if (nbytes >= cap_bytes) return false;
      out[nbytes++] = uint8_t(acc >> 56);
      acc <<= 8;
      nacc -= 8;
    }
    return true;
  }
  // zero-pads the final partial byte; returns the BIT length or -1.
  inline int64_t finish() {
    const int64_t bits = nbytes * 8 + nacc;
    if (nacc) {
      if (nbytes >= cap_bytes) return -1;
      out[nbytes++] = uint8_t(acc >> 56);
    }
    return bits;
  }
};

inline int bit_at(const uint8_t* buf, int64_t pos) {
  return (buf[pos >> 3] >> (7 - (pos & 7))) & 1;
}

// Decode one exp-Golomb symbol at `pos`; returns false on end-of-stream
// (trailing byte padding).  Advances pos past the codeword.
inline bool get_symbol(const uint8_t* buf, int64_t n_bits, int64_t& pos, int64_t& out) {
  int64_t m = 0;
  while (pos + m < n_bits && !bit_at(buf, pos + m)) ++m;
  if (pos + m >= n_bits) return false;  // padding tail
  uint64_t value = 1;
  for (int64_t i = 1; i <= m; ++i) value = (value << 1) | uint64_t(bit_at(buf, pos + m + i));
  value -= 1;
  out = (value % 2 == 0) ? -int64_t(value / 2) : int64_t((value + 1) / 2);
  pos += 2 * m + 1;
  return true;
}

}  // namespace

extern "C" {

// Encode n signed symbols; out must be zeroed, cap_bytes its capacity.
// Returns the bit length, or -1 if out of capacity.
int64_t bvc_encode_symbols(const int64_t* syms, int64_t n, uint8_t* out,
                           int64_t cap_bytes) {
  BitWriter bw{out, cap_bytes};
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = syms[i];
    uint64_t mapped = v <= 0 ? uint64_t(-2 * v) : uint64_t(2 * v - 1);
    uint64_t x = mapped + 1;
    int nbits = 64 - __builtin_clzll(x);
    // (nbits-1) leading zeros + nbits value bits
    if (!bw.put(x, 2 * nbits - 1)) return -1;
  }
  return bw.finish();
}

// Decode consecutive symbols until the stream (n_bits) is exhausted or cap
// symbols are produced.  Returns the symbol count.
int64_t bvc_decode_symbols(const uint8_t* buf, int64_t n_bits, int64_t* out,
                           int64_t cap) {
  int64_t pos = 0, count = 0, v;
  while (count < cap && get_symbol(buf, n_bits, pos, v)) out[count++] = v;
  return count;
}

// Decode a frame's DCT payload straight into zigzag scans:
// exp-Golomb symbols -> RLE expansion, blocks delimited by `eob`.
// out must be a zeroed int32 buffer of n_blocks * scan_len.
// Returns the number of completed blocks.
int64_t bvc_decode_dct_blocks(const uint8_t* buf, int64_t n_bits,
                              int32_t* out, int64_t n_blocks,
                              int64_t scan_len, int64_t eob) {
  int64_t pos = 0, blk = 0, idx = 0, v;
  while (blk < n_blocks && get_symbol(buf, n_bits, pos, v)) {
    if (v == eob) {
      ++blk;
      idx = 0;
    } else if (idx >= scan_len) {
      // malformed run past the block end; ignore until EOB
    } else if (v == 0) {
      idx = scan_len;  // rest of block is zeros
    } else if (v > 0) {
      idx += v;  // run of zeros
    } else {
      int64_t cnt = -v;
      for (int64_t k = 0; k < cnt && get_symbol(buf, n_bits, pos, v); ++k) {
        if (idx < scan_len) out[blk * scan_len + idx++] = int32_t(v);
      }
    }
  }
  return blk;
}

// Decode a frame's DCT bitstream straight into the int16 plane (RLE
// expansion + inverse zigzag in one pass): the devbits transport's host
// qdct recovery — the device ships the FINAL bitstream bytes
// (ops/bitpack.py) and the host re-derives the plane by decoding them.
// out must be zeroed.  Returns the number of completed blocks.
int64_t bvc_decode_dct_plane(const uint8_t* buf, int64_t n_bits, int64_t h,
                             int64_t w, int64_t bs, const int64_t* zz,
                             int64_t eob, int16_t* out) {
  const int64_t scan_len = bs * bs;
  int64_t zoff[64 * 64];
  for (int64_t i = 0; i < scan_len; ++i)
    zoff[i] = (zz[i] / bs) * w + (zz[i] % bs);
  const int64_t nbc = w / bs, n_blocks = (h / bs) * nbc;
  int64_t pos = 0, blk = 0, idx = 0, v;
  int16_t* base = out;
  while (blk < n_blocks && get_symbol(buf, n_bits, pos, v)) {
    if (v == eob) {
      ++blk;
      idx = 0;
      base = out + (blk / nbc) * bs * w + (blk % nbc) * bs;
    } else if (idx >= scan_len) {
      // malformed run past the block end; ignore until EOB
    } else if (v == 0) {
      idx = scan_len;  // rest of block is zeros
    } else if (v > 0) {
      idx += v;  // run of zeros
    } else {
      int64_t cnt = -v;
      for (int64_t k = 0; k < cnt && get_symbol(buf, n_bits, pos, v); ++k) {
        if (idx < scan_len) base[zoff[idx++]] = int16_t(v);
      }
    }
  }
  return blk;
}

// Encode a frame's quantized-DCT plane straight to bits:
// raster blocks -> zigzag gather -> RLE -> exp-Golomb -> EOB per block,
// all in one pass with no intermediate symbol buffer.
// qdct: int16 [h, w]; zz: zigzag flat indices [bs*bs]; out: zeroed buffer.
// Returns the bit length, or -1 if out of capacity.
int64_t bvc_encode_dct_plane(const int16_t* qdct, int64_t h, int64_t w,
                             int64_t bs, const int64_t* zz, int64_t eob,
                             uint8_t* out, int64_t cap_bytes) {
  const int64_t scan_len = bs * bs;
  BitWriter bw{out, cap_bytes};

  auto emit = [&](int64_t v) -> bool {
    uint64_t mapped = v <= 0 ? uint64_t(-2 * v) : uint64_t(2 * v - 1);
    uint64_t x = mapped + 1;
    int nbits = 64 - __builtin_clzll(x);
    return bw.put(x, 2 * nbits - 1);
  };

  // plane offsets of the zigzag scan, computed once (no div/mod per access)
  int64_t zoff[64 * 64];
  for (int64_t i = 0; i < scan_len; ++i)
    zoff[i] = (zz[i] / bs) * w + (zz[i] % bs);
  int16_t scan[64 * 64];

  for (int64_t by = 0; by < h; by += bs) {
    for (int64_t bx = 0; bx < w; bx += bs) {
      const int16_t* blk = qdct + by * w + bx;
      // gather the block's zigzag scan once, then RLE over the flat copy
      int64_t last_nz = -1;
      for (int64_t i = 0; i < scan_len; ++i) {
        scan[i] = blk[zoff[i]];
        if (scan[i]) last_nz = i;
      }
      int64_t i = 0;
      while (i < scan_len) {
        if (i > last_nz) {  // rest-of-block zeros terminator
          if (!emit(0)) return -1;
          break;
        }
        if (scan[i] == 0) {
          int64_t run = 0;
          while (scan[i] == 0) { ++run; ++i; }  // last_nz bounds the walk
          if (!emit(run)) return -1;
        } else {
          int64_t start = i;
          while (i < scan_len && scan[i] != 0) ++i;
          if (!emit(-(i - start))) return -1;
          for (int64_t k = start; k < i; ++k)
            if (!emit(scan[k])) return -1;
        }
      }
      if (!emit(eob)) return -1;
    }
  }
  return bw.finish();
}

// Render the mv.txt line for one frame: entries sorted by (x, y) — x-major —
// formatted "x,y:mvx,mvy|" (reference file_io.py:65-70), newline-terminated.
// mvs: int32 [nbr*nbc*3] raster order (mv_x, mv_y, ref).
// Returns the byte length written, or -1 if out of capacity.
int64_t bvc_format_mv_lines(const int32_t* mvs, int64_t nbr, int64_t nbc,
                            int64_t bs, char* out, int64_t cap) {
  int64_t n = 0;
  auto put_int = [&](int64_t v) {
    if (v < 0) { out[n++] = '-'; v = -v; }
    char tmp[20]; int t = 0;
    do { tmp[t++] = char('0' + v % 10); v /= 10; } while (v);
    while (t) out[n++] = tmp[--t];
  };
  for (int64_t j = 0; j < nbc; ++j) {
    for (int64_t i = 0; i < nbr; ++i) {
      if (n + 64 > cap) return -1;
      const int32_t* mv = mvs + (i * nbc + j) * 3;
      put_int(j * bs); out[n++] = ',';
      put_int(i * bs); out[n++] = ':';
      put_int(mv[0]); out[n++] = ',';
      put_int(mv[1]); out[n++] = '|';
    }
  }
  out[n++] = '\n';
  return n;
}

// ---------------------------------------------------------------------------
// Compact-transfer rebuild helpers (host side of ops/pack.py).  These are the
// hot per-frame loops of the finalize path; as C they release the GIL and run
// 5-10x faster than the NumPy fancy-indexing equivalents (which remain as
// fallbacks).  Semantics are the NumPy functions', bit for bit.
// ---------------------------------------------------------------------------

// Scatter zigzag-prefix values back into an int16 plane (inverse of
// ops/pack.pack_qdct).  out must be zeroed; vals in stream order; zz flat
// in-block indices.  Python twin: ops/pack.unpack_qdct.
void bvc_unpack_qdct(const int16_t* vals, const int32_t* lens, int64_t nbr,
                     int64_t nbc, int64_t bs, const int64_t* zz,
                     int16_t* out, int64_t w) {
  int64_t off = 0;
  for (int64_t i = 0; i < nbr; ++i) {
    for (int64_t j = 0; j < nbc; ++j) {
      int16_t* blk = out + i * bs * w + j * bs;
      const int64_t len = lens[i * nbc + j];
      for (int64_t k = 0; k < len; ++k) {
        const int64_t fi = zz[k];
        blk[(fi / bs) * w + (fi % bs)] = vals[off + k];
      }
      off += len;
    }
  }
}

// Decode the 3-bit joint state stream (ops/pack.pack_joint): 8 pixels per
// 3 little-endian bytes -> one state byte per pixel.
void bvc_joint_states(const uint8_t* jc, int64_t n_px, uint8_t* out) {
  for (int64_t g = 0; g * 8 < n_px; ++g) {
    const uint32_t w24 = uint32_t(jc[g * 3]) | (uint32_t(jc[g * 3 + 1]) << 8)
                         | (uint32_t(jc[g * 3 + 2]) << 16);
    for (int64_t k = 0; k < 8 && g * 8 + k < n_px; ++k)
      out[g * 8 + k] = uint8_t((w24 >> (3 * k)) & 7);
  }
}

// Rebuild one joint-coded plane: base u8 + {0,+1,-1} deltas + positioned
// escapes.  plus/minus/escA/escB are the state ids for this plane's half
// (ops/pack.joint_recon / joint_art).
void bvc_apply_joint(const uint8_t* states, const uint8_t* esc,
                     const uint8_t* base, uint8_t* out, int64_t n_px,
                     int64_t plus, int64_t minus, int64_t esc_a,
                     int64_t esc_b) {
  int64_t e = 0;
  for (int64_t p = 0; p < n_px; ++p) {
    const uint8_t s = states[p];
    if (s == esc_a || s == esc_b) {
      out[p] = esc[e++];
    } else {
      out[p] = uint8_t(base[p] + (s == plus) - (s == minus));
    }
  }
}

// Motion-compensated prediction plane from the host reference stack
// (Python twin: ops/pack.host_pred_inter).  planes: [R, ph, pw] u8 — the
// reference stack, or the half-pel stack (then frac=1 and block offsets /
// steps double).  mvs: int32 [nbr*nbc*3] (dx, dy, ref).
void bvc_pred_inter(const uint8_t* planes, int64_t ph, int64_t pw,
                    const int32_t* mvs, int64_t nbr, int64_t nbc, int64_t bs,
                    int64_t frac, uint8_t* out) {
  const int64_t scale = frac ? 2 : 1;
  const int64_t w = nbc * bs;
  for (int64_t i = 0; i < nbr; ++i) {
    for (int64_t j = 0; j < nbc; ++j) {
      const int32_t* mv = mvs + (i * nbc + j) * 3;
      const uint8_t* pl = planes + int64_t(mv[2]) * ph * pw;
      const int64_t oy = i * bs * scale + mv[1];
      const int64_t ox = j * bs * scale + mv[0];
      for (int64_t a = 0; a < bs; ++a) {
        const uint8_t* src = pl + (oy + a * scale) * pw + ox;
        uint8_t* dst = out + (i * bs + a) * w + j * bs;
        if (scale == 1) {
          std::memcpy(dst, src, size_t(bs));
        } else {
          for (int64_t b = 0; b < bs; ++b) dst[b] = src[2 * b];
        }
      }
    }
  }
}

// I-frame reconstruction rebuild in scan order (Python twin:
// ops/pack.host_rebuild_intra_recon).  x: int32 [nbr*nbc*bs*bs] integer
// IDCT residuals scaled by 2^shift; modes: int32 [nbr*nbc] (0 = horizontal,
// reading recon[y0+b][x0-1] — the transposed-predictor quirk — 1 = vertical
// reading recon[y0-1][x0+a]); code: int8 plane {0, +1, -1} with 3 = escape;
// esc_plane u8 positioned escapes.  out u8 [h*w].
void bvc_intra_rebuild(const int32_t* x, const int32_t* modes,
                       const int8_t* code, const uint8_t* esc_plane,
                       int64_t nbr, int64_t nbc, int64_t bs, int64_t shift,
                       uint8_t* out) {
  const int64_t w = nbc * bs;
  const int64_t half = int64_t(1) << (shift - 1);
  for (int64_t i = 0; i < nbr; ++i) {
    for (int64_t j = 0; j < nbc; ++j) {
      const int32_t* xb = x + (i * nbc + j) * bs * bs;
      const int64_t y0 = i * bs, x0 = j * bs;
      const int mode = int(modes[i * nbc + j]);
      for (int64_t a = 0; a < bs; ++a) {
        uint8_t* row = out + (y0 + a) * w + x0;
        const int8_t* crow = code + (y0 + a) * w + x0;
        const uint8_t* erow = esc_plane + (y0 + a) * w + x0;
        for (int64_t b = 0; b < bs; ++b) {
          int64_t pred;
          if (mode == 0) {
            pred = x0 > 0 ? out[(y0 + b) * w + x0 - 1] : 128;
          } else {
            pred = y0 > 0 ? out[(y0 - 1) * w + x0 + a] : 128;
          }
          if (crow[b] == 3) {
            row[b] = erow[b];
          } else {
            int64_t g = (int64_t(xb[a * bs + b]) + (pred << shift) + half)
                        >> shift;
            if (g < 0) g = 0;
            if (g > 255) g = 255;
            row[b] = uint8_t(g + crow[b]);
          }
        }
      }
    }
  }
}

// Decode the joint-state bitmap + compacted 3-bit kind list
// (ops/pack.pack_joint) -> one state byte per pixel.  Bits and kind groups
// are little-endian; kinds past capk decode as 0 (overflow is handled by
// the caller's full-plane fallback).
void bvc_joint_decode2(const uint8_t* jb, const uint8_t* jk, int64_t n_px,
                       int64_t capk, uint8_t* out) {
  int64_t k = 0;
  for (int64_t p = 0; p < n_px; ++p) {
    if ((jb[p >> 3] >> (p & 7)) & 1) {
      uint8_t kind = 0;
      if (k < capk) {
        const int64_t g = k >> 3;
        const uint32_t w24 = uint32_t(jk[g * 3])
                             | (uint32_t(jk[g * 3 + 1]) << 8)
                             | (uint32_t(jk[g * 3 + 2]) << 16);
        kind = uint8_t((w24 >> (3 * (k & 7))) & 7);
      }
      out[p] = kind;
      ++k;
    } else {
      out[p] = 0;
    }
  }
}

// I-frame res_w_mc plane: residual vs the chosen intra predictor,
// uint8-wrapped (Python twin: ops/pack.host_intra_art, reference
// IFrame.py:30,57).  Preserves the transposed-predictor quirk: within a
// block at (y0, x0), H-mode (0) pixel (a, b) predicts from
// recon[y0 + b][x0 - 1] and V-mode (1) pixel (a, b) from
// recon[y0 - 1][x0 + a]; borders predict 128.
void bvc_intra_art(const uint8_t* curr, const uint8_t* recon,
                   const int32_t* modes, int64_t nbr, int64_t nbc,
                   int64_t bs, uint8_t* out) {
  const int64_t w = nbc * bs;
  for (int64_t i = 0; i < nbr; ++i) {
    for (int64_t j = 0; j < nbc; ++j) {
      const int mode = int(modes[i * nbc + j]);
      const int64_t y0 = i * bs, x0 = j * bs;
      for (int64_t a = 0; a < bs; ++a) {
        const uint8_t* crow = curr + (y0 + a) * w + x0;
        uint8_t* orow = out + (y0 + a) * w + x0;
        for (int64_t b = 0; b < bs; ++b) {
          const int pred =
              mode == 0
                  ? (x0 > 0 ? int(recon[(y0 + b) * w + x0 - 1]) : 128)
                  : (y0 > 0 ? int(recon[(y0 - 1) * w + x0 + a]) : 128);
          orow[b] = uint8_t(int(crow[b]) - pred);
        }
      }
    }
  }
}

// res_wo_mc plane: (curr - prev) mod 256 (Python twin:
// models/pipeline._wrap_diff_u8).
void bvc_wrap_diff(const uint8_t* curr, const uint8_t* prev, uint8_t* out,
                   int64_t n_px) {
  for (int64_t p = 0; p < n_px; ++p) out[p] = uint8_t(curr[p] - prev[p]);
}

// Integer-exact IDCT of a whole frame fused with the res_w_mc truncation
// guess (twin of ops/pack._x_int_blocks_np + host_art_guess_from_x, which
// twin ops/transform.idct2_exact_core on device).  Bit-exactness relies on
// two's-complement wrap: every accumulation runs in uint32 (defined wrap)
// and is reinterpreted int32, exactly like the device's int32 einsums and
// the NumPy twin's float64->int64->int32 cast chain.  The power-of-two
// quant rescale is inlined: Q(k,l) = 2^(qp + e) with e = 0 below the
// anti-diagonal, 1 on it, 2 above (ops/transform.quant_matrices).
// d_int: int32 [bs*bs] fixed-point basis; x_out: int32 [nbr*nbc*bs*bs]
// blocked; art_out: u8 [h*w] raster (may be null).
}  // extern "C" (template cores below need C++ linkage)

namespace {

// Templated core of bvc_x_art: constant trip counts let the compiler fully
// unroll and vectorize the BSxBS int32 matmuls.
template <int BS>
void x_art_bs(const int16_t* qdct, const int32_t* row_qps,
              const int32_t* d_int, int64_t nbr, int64_t nbc, int64_t shift,
              int64_t guard, int32_t* x_out, uint8_t* art_out) {
  const int64_t w = nbc * BS;
  const int sh1 = int(shift - guard);
  const uint32_t half1 = uint32_t(1) << (sh1 - 1);
  const uint32_t halfg = uint32_t(1) << (guard - 1);
  int32_t y[BS * BS], t1[BS * BS];
  for (int64_t i = 0; i < nbr; ++i) {
    const int qp = int(row_qps[i]);
    for (int64_t j = 0; j < nbc; ++j) {
      const int16_t* blk = qdct + i * BS * w + j * BS;
      for (int k = 0; k < BS; ++k)
        for (int l = 0; l < BS; ++l) {
          const int e = k + l < BS - 1 ? 0 : (k + l == BS - 1 ? 1 : 2);
          y[k * BS + l] =
              int32_t(uint32_t(int32_t(blk[k * w + l])) << (qp + e));
        }
      // t1[m][l] = wrap32(sum_k d[k][m] * y[k][l]), then guarded shift-round
      // (reduction loop outermost so the lane loop auto-vectorizes)
      for (int m = 0; m < BS; ++m) {
        uint32_t acc[BS] = {0};
        for (int k = 0; k < BS; ++k) {
          const uint32_t dkm = uint32_t(d_int[k * BS + m]);
          for (int l = 0; l < BS; ++l)
            acc[l] += dkm * uint32_t(y[k * BS + l]);
        }
        for (int l = 0; l < BS; ++l)
          t1[m * BS + l] = int32_t(acc[l] + half1) >> sh1;
      }
      // x[m][n] = wrap32(sum_l t1[m][l] * d[l][n]) >> guard (rounded)
      int32_t* xb = x_out + (i * nbc + j) * BS * BS;
      for (int m = 0; m < BS; ++m) {
        uint32_t acc[BS] = {0};
        for (int l = 0; l < BS; ++l) {
          const uint32_t tml = uint32_t(t1[m * BS + l]);
          for (int n = 0; n < BS; ++n)
            acc[n] += tml * uint32_t(d_int[l * BS + n]);
        }
        uint8_t* arow = art_out ? art_out + (i * BS + m) * w + j * BS
                                : nullptr;
        for (int n = 0; n < BS; ++n) {
          const int32_t x = int32_t(acc[n] + halfg) >> int(guard);
          xb[m * BS + n] = x;
          if (arow) {
            const int32_t t = x >= 0 ? x >> shift : -((-x) >> shift);
            arow[n] = uint8_t(t & 255);
          }
        }
      }
    }
  }
}

// Generic fallback for unusual block sizes (identical math, runtime bs).
void x_art_any(const int16_t* qdct, const int32_t* row_qps,
               const int32_t* d_int, int64_t nbr, int64_t nbc, int64_t bs,
               int64_t shift, int64_t guard, int32_t* x_out,
               uint8_t* art_out) {
  const int64_t w = nbc * bs;
  const int sh1 = int(shift - guard);
  const uint32_t half1 = uint32_t(1) << (sh1 - 1);
  const uint32_t halfg = uint32_t(1) << (guard - 1);
  int32_t y[64 * 64], t1[64 * 64];
  for (int64_t i = 0; i < nbr; ++i) {
    const int qp = int(row_qps[i]);
    for (int64_t j = 0; j < nbc; ++j) {
      const int16_t* blk = qdct + i * bs * w + j * bs;
      for (int64_t k = 0; k < bs; ++k)
        for (int64_t l = 0; l < bs; ++l) {
          const int64_t e = k + l < bs - 1 ? 0 : (k + l == bs - 1 ? 1 : 2);
          y[k * bs + l] =
              int32_t(uint32_t(int32_t(blk[k * w + l])) << (qp + e));
        }
      for (int64_t m = 0; m < bs; ++m) {
        uint32_t acc[64] = {0};
        for (int64_t k = 0; k < bs; ++k) {
          const uint32_t dkm = uint32_t(d_int[k * bs + m]);
          for (int64_t l = 0; l < bs; ++l)
            acc[l] += dkm * uint32_t(y[k * bs + l]);
        }
        for (int64_t l = 0; l < bs; ++l)
          t1[m * bs + l] = int32_t(acc[l] + half1) >> sh1;
      }
      int32_t* xb = x_out + (i * nbc + j) * bs * bs;
      for (int64_t m = 0; m < bs; ++m) {
        uint32_t acc[64] = {0};
        for (int64_t l = 0; l < bs; ++l) {
          const uint32_t tml = uint32_t(t1[m * bs + l]);
          for (int64_t n = 0; n < bs; ++n)
            acc[n] += tml * uint32_t(d_int[l * bs + n]);
        }
        for (int64_t n = 0; n < bs; ++n) {
          const int32_t x = int32_t(acc[n] + halfg) >> int(guard);
          xb[m * bs + n] = x;
          if (art_out) {
            const int32_t t = x >= 0 ? x >> shift : -((-x) >> shift);
            art_out[(i * bs + m) * w + j * bs + n] = uint8_t(t & 255);
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

void bvc_x_art(const int16_t* qdct, const int32_t* row_qps,
               const int32_t* d_int, int64_t nbr, int64_t nbc, int64_t bs,
               int64_t shift, int64_t guard, int32_t* x_out,
               uint8_t* art_out) {
  switch (bs) {
    case 4:
      return x_art_bs<4>(qdct, row_qps, d_int, nbr, nbc, shift, guard,
                         x_out, art_out);
    case 8:
      return x_art_bs<8>(qdct, row_qps, d_int, nbr, nbc, shift, guard,
                         x_out, art_out);
    case 16:
      return x_art_bs<16>(qdct, row_qps, d_int, nbr, nbc, shift, guard,
                          x_out, art_out);
    default:
      return x_art_any(qdct, row_qps, d_int, nbr, nbc, bs, shift, guard,
                       x_out, art_out);
  }
}

// Inter reconstruction from the blocked integer residuals: recon guess
// clip((x + (pred << shift) + half) >> shift) fused with the joint
// correction codes (twin of ops/pack.host_recon_guess_from_x +
// joint_recon).  states/esc/out are raster u8 planes.
void bvc_recon_joint(const int32_t* x, const uint8_t* pred,
                     const uint8_t* states, const uint8_t* esc, int64_t nbr,
                     int64_t nbc, int64_t bs, int64_t shift, int64_t plus,
                     int64_t minus, int64_t esc_a, int64_t esc_b,
                     uint8_t* out) {
  const int64_t w = nbc * bs;
  const int64_t half = int64_t(1) << (shift - 1);
  int64_t e = 0;  // escapes are consumed in raster-pixel order
  for (int64_t yy = 0; yy < nbr * bs; ++yy) {
    const int64_t i = yy / bs, a = yy % bs;
    for (int64_t j = 0; j < nbc; ++j) {
      const int32_t* xrow = x + ((i * nbc + j) * bs + a) * bs;
      const int64_t row = yy * w + j * bs;
      for (int64_t b = 0; b < bs; ++b) {
        const int64_t p = row + b;
        const uint8_t s = states[p];
        if (s == esc_a || s == esc_b) {
          out[p] = esc[e++];
          continue;
        }
        int64_t g = (int64_t(xrow[b]) + (int64_t(pred[p]) << shift)
                     + half) >> shift;
        if (g < 0) g = 0;
        if (g > 255) g = 255;
        out[p] = uint8_t(g + (s == plus) - (s == minus));
      }
    }
  }
}

// Sum of squared differences of two u8 planes (PSNR numerator).
int64_t bvc_sse(const uint8_t* a, const uint8_t* b, int64_t n_px) {
  int64_t acc = 0;
  for (int64_t p = 0; p < n_px; ++p) {
    const int32_t d = int32_t(a[p]) - int32_t(b[p]);
    acc += d * d;
  }
  return acc;
}

// Pack one input frame for host->device upload as left-predictor deltas:
// nibble codes (two per byte, low nibble = even pixel) with sentinel -8
// for |delta| > 7, whose true int16 delta goes to esc_out in stream order.
// The device inverse (ops/pack.unpack_input_chunk) rebuilds pixels with a
// row cumsum.  Column 0 predicts from 128.  h*w must be even.
// Returns the total escape count (may exceed cap — caller then uploads the
// chunk raw; esc_out is only written up to cap).
int64_t bvc_pack_input(const uint8_t* src, int64_t h, int64_t w,
                       uint8_t* nib_out, int16_t* esc_out, int64_t cap) {
  int64_t ne = 0;
  int64_t half = 0;
  uint8_t pending = 0;
  bool have_low = false;
  for (int64_t i = 0; i < h; ++i) {
    const uint8_t* row = src + i * w;
    int prev = 128;
    for (int64_t j = 0; j < w; ++j) {
      const int d = int(row[j]) - prev;
      prev = row[j];
      uint8_t nib;
      if (d >= -7 && d <= 7) {
        nib = uint8_t(d & 15);
      } else {
        nib = 8;  // -8 sentinel
        if (ne < cap) esc_out[ne] = int16_t(d);
        ++ne;
      }
      if (have_low) {
        nib_out[half++] = uint8_t(pending | (nib << 4));
        have_low = false;
      } else {
        pending = nib;
        have_low = true;
      }
    }
  }
  return ne;
}

// Fused P-frame host rebuild (Python twin: the _rebuild_prepare +
// _rebuild_apply + joint_art chain in models/pipeline.py, composed from
// the single-stage functions above).  One call per frame replaces six
// ctypes round trips plus their NumPy temporaries:
//   1. qdct value expansion (raw int16/int8 stream, or the 4-bit nibble
//      stream with int16 escapes — ops/pack.FrameLayout._qv),
//   2. zigzag-prefix scatter into the int16 plane (bvc_unpack_qdct),
//   3. integer-exact IDCT + res_w_mc truncation guess (bvc_x_art),
//   4. joint correction-state decode (bvc_joint_decode2),
//   5. MC prediction from the reference/half-pel stack (bvc_pred_inter),
//   6. recon guess + recon codes (bvc_recon_joint) and art codes applied
//      in place over the truncation guess (bvc_apply_joint).
// qv_kind: 0 = int16 values, 1 = int8 values, 2 = nibble pairs + escapes,
// 3 = 2-bit codes (0, +1, -1, escape) + signed-nibble escapes in qe4 with
// the -8 sentinel deferring to int16 deep escapes in qe,
// 4 = devbits: qv is the frame's FINAL exp-Golomb dct bitstream
// (ops/bitpack.py), n_qe4 its BIT length; ql/qe4/qe are unused.
// ql_u8: lens as u8 (1) or int16 (0).  Escape reads are clamped to
// n_re/n_ae (overflow frames take the caller's full-plane fallback and
// never reach this function; the clamp is defensive).
// Outputs: qdct int16 [h*w] (zeroed here), recon u8 [h*w], art u8 [h*w].
void bvc_rebuild_p(const uint8_t* qv, int64_t qv_kind, const uint8_t* qe4,
                   int64_t n_qe4, const int16_t* qe,
                   int64_t n_qe, const uint8_t* ql, int64_t ql_u8,
                   const int64_t* zz, const int32_t* row_qps,
                   const int32_t* d_int, int64_t nbr, int64_t nbc,
                   int64_t bs, int64_t shift, int64_t guard,
                   const uint8_t* jb, const uint8_t* jk, int64_t capk,
                   const uint8_t* re, int64_t n_re, const uint8_t* ae,
                   int64_t n_ae, const uint8_t* planes, int64_t ph,
                   int64_t pw, int64_t frac, const int32_t* mvs,
                   int16_t* qdct_out, int32_t* x_scratch,
                   uint8_t* states_scratch, uint8_t* pred_scratch,
                   uint8_t* recon_out, uint8_t* art_out) {
  const int64_t nb = nbr * nbc, w = nbc * bs, n_px = nbr * bs * w;
  if (qv_kind == 4) {
    // devbits: steps 1+2 are one bitstream decode (EOB per reference
    // encoder/Frame.py:23); ql/qe4/qe are unused
    std::memset(qdct_out, 0, size_t(n_px) * 2);
    bvc_decode_dct_plane(qv, n_qe4, nbr * bs, w, bs, zz, 8190, qdct_out);
  } else {
  // 1. lens to int32, values to int16 (nibble expansion with escapes)
  std::vector<int32_t> lens{};
  lens.resize(size_t(nb));
  int64_t total = 0;
  for (int64_t b = 0; b < nb; ++b) {
    lens[size_t(b)] = ql_u8 ? int32_t(ql[b])
                            : int32_t(((const int16_t*)ql)[b]);
    total += lens[size_t(b)];
  }
  std::vector<int16_t> expanded;
  const int16_t* vals;
  if (qv_kind == 0) {
    vals = (const int16_t*)qv;
  } else if (qv_kind == 1) {
    expanded.resize(size_t(total));
    const int8_t* v8 = (const int8_t*)qv;
    for (int64_t k = 0; k < total; ++k) expanded[size_t(k)] = v8[k];
    vals = expanded.data();
  } else if (qv_kind == 2) {
    expanded.resize(size_t(total));
    int64_t e = 0;
    for (int64_t k = 0; k < total; ++k) {
      int v = (k & 1) ? (qv[k >> 1] >> 4) : (qv[k >> 1] & 15);
      if (v >= 8) v -= 16;
      if (v == -8) v = (e < n_qe) ? qe[e++] : 0;
      expanded[size_t(k)] = int16_t(v);
    }
    vals = expanded.data();
  } else {  // 3: 2-bit codes, nibble escapes, int16 deep escapes
    expanded.resize(size_t(total));
    static const int16_t kCode[4] = {0, 1, -1, 0};
    int64_t e4 = 0, e = 0;
    for (int64_t k = 0; k < total; ++k) {
      const int c = (qv[k >> 2] >> (2 * (k & 3))) & 3;
      int v = kCode[c];
      if (c == 3) {
        int nib = (e4 < n_qe4)
                      ? ((e4 & 1) ? (qe4[e4 >> 1] >> 4) : (qe4[e4 >> 1] & 15))
                      : 0;
        ++e4;
        if (nib >= 8) nib -= 16;
        v = (nib == -8) ? ((e < n_qe) ? qe[e++] : 0) : nib;
      }
      expanded[size_t(k)] = int16_t(v);
    }
    vals = expanded.data();
  }
  // 2. scatter into the zeroed int16 plane
  std::memset(qdct_out, 0, size_t(n_px) * 2);
  bvc_unpack_qdct(vals, lens.data(), nbr, nbc, bs, zz, qdct_out, w);
  }
  // 3. integer IDCT + truncation guess (art_out holds the guess)
  bvc_x_art(qdct_out, row_qps, d_int, nbr, nbc, bs, shift, guard, x_scratch,
            art_out);
  // 4. joint states
  bvc_joint_decode2(jb, jk, n_px, capk, states_scratch);
  // 5. MC prediction
  bvc_pred_inter(planes, ph, pw, mvs, nbr, nbc, bs, frac, pred_scratch);
  // 6. recon + art (escape reads clamped; see docstring)
  {
    const int64_t half = int64_t(1) << (shift - 1);
    int64_t er = 0, ea = 0;
    for (int64_t yy = 0; yy < nbr * bs; ++yy) {
      const int64_t i = yy / bs, a = yy % bs;
      for (int64_t j = 0; j < nbc; ++j) {
        const int32_t* xrow = x_scratch + ((i * nbc + j) * bs + a) * bs;
        const int64_t row = yy * w + j * bs;
        for (int64_t b = 0; b < bs; ++b) {
          const int64_t p = row + b;
          const uint8_t s = states_scratch[p];
          // recon half: states {1 +, 2 -, 5/7 escape}
          if (s == 5 || s == 7) {
            recon_out[p] = (er < n_re) ? re[er] : 0;
            ++er;
          } else {
            int64_t g = (int64_t(xrow[b]) + (int64_t(pred_scratch[p]) << shift)
                         + half) >> shift;
            if (g < 0) g = 0;
            if (g > 255) g = 255;
            recon_out[p] = uint8_t(g + (s == 1) - (s == 2));
          }
          // art half over the guess in place: states {3 +, 4 -, 6/7 escape}
          if (s == 6 || s == 7) {
            art_out[p] = (ea < n_ae) ? ae[ea] : 0;
            ++ea;
          } else {
            art_out[p] = uint8_t(art_out[p] + (s == 3) - (s == 4));
          }
        }
      }
    }
  }
}

int64_t bvc_version() { return 10; }

}  // extern "C"
