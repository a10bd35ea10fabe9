// Host-side entropy decoders: JPEG-Lossless (SOF3) for io/jpeg_lossless.py,
// baseline and progressive Huffman JPEG for io/jpeg.py and JPEG 2000 tier-1
// (the MQ decoder and the coding passes) for io/jpeg2000.py.
//
// The JPEG-Lossless functions are a copy of those of
// spine_vision_tpu/native/src/host_ops.cpp. Python decodes one Huffman symbol
// per interpreter step (about a second for a 512x512 slice); this does the
// same work in milliseconds. Bound with ctypes by
// spine_vision_torch/native/__init__.py, which builds it with
// g++ -O3 -fopenmp -shared -fPIC at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG-Lossless (SOF3) entropy decode — the hot loop of io/jpeg_lossless.py.
// The Python fallback decodes one Huffman symbol per interpreter iteration
// (~seconds per 512x512x16-bit slice); this does the same work in ~ms.
// ---------------------------------------------------------------------------

// Peek `count` (<= 16) bits at bit position `pos`; bits beyond the chunk end
// read as 1s (JPEG pads entropy data with 1-bits), matching the Python
// decoder's np.ones padding.
static inline uint32_t jpegls_peek_bits(const uint8_t* p, int64_t nbytes,
                                        int64_t pos, int count) {
  const int64_t byte = pos >> 3;
  const int shift = static_cast<int>(pos & 7);
  uint64_t window = 0;
  for (int i = 0; i < 5; ++i) {
    const uint64_t b = (byte + i < nbytes) ? p[byte + i] : 0xFFull;
    window = (window << 8) | b;
  }
  return static_cast<uint32_t>((window >> (40 - shift - count)) &
                               ((1ull << count) - 1));
}

// Unstuff 0xFF00 byte pairs and split at RSTn (0xFFD0..0xFFD7) markers.
// out: buffer of at least n bytes; offsets: int64 [max_chunks + 1].
// Returns the number of chunks written (offsets[0..n_chunks] filled), or
// -1 if more than max_chunks intervals are present.
int64_t jpegls_unstuff_split(const uint8_t* in, int64_t n, uint8_t* out,
                             int64_t* offsets, int64_t max_chunks) {
  int64_t n_chunks = 0;
  int64_t w = 0;
  offsets[0] = 0;
  int64_t i = 0;
  while (i < n) {
    const uint8_t b = in[i];
    if (b == 0xFF && i + 1 < n) {
      const uint8_t nxt = in[i + 1];
      if (nxt == 0x00) {
        out[w++] = 0xFF;
        i += 2;
        continue;
      }
      if (nxt >= 0xD0 && nxt <= 0xD7) {  // RST0..RST7
        if (n_chunks + 1 >= max_chunks) return -1;
        offsets[++n_chunks] = w;
        i += 2;
        continue;
      }
    }
    out[w++] = b;
    i += 1;
  }
  offsets[++n_chunks] = w;
  return n_chunks;
}

// data: concatenated unstuffed restart-interval chunks.
// offsets: int64 [n_chunks + 1] byte offsets into data.
// luts: uint16 [ncomp, 65536]; entry = (code_length << 8) | ssss.
// out: int32 [total, ncomp] difference values in MCU order.
// Returns the number of decoded MCUs (== total on success); -1 on an
// invalid Huffman code.
int64_t jpegls_decode_diffs(const uint8_t* data, const int64_t* offsets,
                            int64_t n_chunks, const uint16_t* luts,
                            int64_t ncomp, int64_t counts_per_interval,
                            int64_t total, int32_t* out) {
  int64_t mcu = 0;
  for (int64_t ch = 0; ch < n_chunks && mcu < total; ++ch) {
    const uint8_t* p = data + offsets[ch];
    const int64_t nbytes = offsets[ch + 1] - offsets[ch];
    const int64_t nbits = nbytes * 8;
    int64_t pos = 0;
    const int64_t limit =
        counts_per_interval == 0
            ? total
            : std::min(total, mcu + counts_per_interval);
    while (mcu < limit && pos < nbits) {
      for (int64_t c = 0; c < ncomp; ++c) {
        const uint32_t peek = jpegls_peek_bits(p, nbytes, pos, 16);
        const uint16_t entry = luts[c * 65536 + peek];
        const int len = entry >> 8;
        if (len == 0) return -1;
        const int ssss = entry & 0xFF;
        pos += len;
        int32_t diff;
        if (ssss == 0) {
          diff = 0;
        } else if (ssss == 16) {
          diff = 32768;
        } else {
          const uint32_t mag = jpegls_peek_bits(p, nbytes, pos, ssss);
          pos += ssss;
          diff = (mag >= (1u << (ssss - 1)))
                     ? static_cast<int32_t>(mag)
                     : static_cast<int32_t>(mag) - (1 << ssss) + 1;
        }
        out[mcu * ncomp + c] = diff;
      }
      ++mcu;
    }
    // A completed restart interval must end cleanly: fewer than 8 unread
    // bits, all of them 1s (T.81 byte-align padding). Anything else means
    // the stream is corrupt and the decoded tail pixels are garbage.
    if (mcu == limit) {
      if (pos > nbits || nbits - pos >= 8) return -2;
      for (int64_t b = pos; b < nbits; ++b) {
        if (((p[b >> 3] >> (7 - (b & 7))) & 1) == 0) return -2;
      }
    }
  }
  return mcu;
}

// ---------------------------------------------------------------------------
// Baseline JPEG (SOF0/SOF1, Huffman) entropy decode of one scan — the hot
// loop of io/jpeg.py, whose _decode_scan is its plain Python version.
// ---------------------------------------------------------------------------

// Zigzag index -> natural (row-major) index of an 8x8 block (T.81 Figure 5).
static const int kJpegNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static inline int32_t jpeg_extend(uint32_t v, int s) {
  return v < (1u << (s - 1)) ? static_cast<int32_t>(v) - (1 << s) + 1
                             : static_cast<int32_t>(v);
}

// data, offsets, n_chunks: jpegls_unstuff_split's restart-interval chunks.
// luts: uint16 [2 * ns, 65536], the DC then the AC peek table of each of the
//   scan's ns components; entry = (code_length << 8) | symbol.
// block_comp: int32 [blocks_per_mcu], the scan component of each block of an
//   MCU, in the MCU's block order.
// restart_interval: MCUs a chunk (0: one chunk); the DC predictions reset to
//   0 at each chunk.
// out: int16 [n_mcus * blocks_per_mcu, 64], each block's quantized
//   coefficients in natural order.
// Returns the number of MCUs decoded (== n_mcus on success); -1 on an
// invalid Huffman code, -2 on a run past the 63rd coefficient, -3 when a
// chunk's codes run past its last byte (a truncated scan).
int64_t jpeg_decode_scan(const uint8_t* data, const int64_t* offsets,
                         int64_t n_chunks, const uint16_t* luts,
                         const int32_t* block_comp, int64_t blocks_per_mcu,
                         int64_t restart_interval, int64_t n_mcus,
                         int16_t* out) {
  int64_t mcu = 0;
  for (int64_t ch = 0; ch < n_chunks && mcu < n_mcus; ++ch) {
    const uint8_t* p = data + offsets[ch];
    const int64_t nbytes = offsets[ch + 1] - offsets[ch];
    const int64_t nbits = nbytes * 8;
    int64_t pos = 0;
    int32_t pred[4] = {0, 0, 0, 0};
    const int64_t limit = restart_interval == 0
                              ? n_mcus
                              : std::min(n_mcus, mcu + restart_interval);
    for (; mcu < limit; ++mcu) {
      for (int64_t b = 0; b < blocks_per_mcu; ++b) {
        const int comp = block_comp[b];
        const uint16_t* dc = luts + (2 * comp) * 65536;
        const uint16_t* ac = dc + 65536;
        int16_t* blk = out + (mcu * blocks_per_mcu + b) * 64;
        std::memset(blk, 0, 64 * sizeof(int16_t));
        uint16_t entry = dc[jpegls_peek_bits(p, nbytes, pos, 16)];
        int len = entry >> 8;
        if (len == 0) return -1;
        pos += len;
        int s = entry & 0xFF;
        if (s > 16) return -1;
        if (s) {
          pred[comp] += jpeg_extend(jpegls_peek_bits(p, nbytes, pos, s), s);
          pos += s;
        }
        blk[0] = static_cast<int16_t>(pred[comp]);
        for (int k = 1; k < 64;) {
          entry = ac[jpegls_peek_bits(p, nbytes, pos, 16)];
          len = entry >> 8;
          if (len == 0) return -1;
          pos += len;
          const int r = (entry >> 4) & 15;
          s = entry & 15;
          if (s) {
            k += r;
            if (k > 63) return -2;
            blk[kJpegNatural[k]] =
                static_cast<int16_t>(jpeg_extend(jpegls_peek_bits(p, nbytes, pos, s), s));
            pos += s;
            ++k;
          } else if (r == 15) {
            k += 16;
          } else {
            break;  // EOB
          }
        }
        if (pos > nbits) return -3;
      }
    }
  }
  return mcu;
}


// Progressive JPEG (SOF2, Huffman) entropy decode of one scan into the
// coefficients decoded so far, following libjpeg's jdphuff.c: DC first and
// refinement, AC first and refinement (EOB runs, correction bits). The plain
// Python version is io/jpeg.py's _decode_progressive.
// data, offsets, n_chunks: jpegls_unstuff_split's restart-interval chunks.
// luts: uint16 [2 * ns, 65536] as jpeg_decode_scan's (a table the scan does
//   not use may be all zeros).
// block_comp, blocks_per_mcu, restart_interval, n_mcus: as jpeg_decode_scan's;
//   the DC predictions and the EOB run reset at each chunk.
// ss, se, ah, al: the scan's spectral selection and successive approximation.
// blocks: int16 [n_mcus * blocks_per_mcu, 64], natural order, updated in place.
// Returns the number of MCUs decoded (== n_mcus on success); -1 on an invalid
// Huffman code, -2 on a run past the 63rd coefficient, -3 when a chunk's codes
// run past its last byte.
int64_t jpeg_decode_progressive(const uint8_t* data, const int64_t* offsets,
                                int64_t n_chunks, const uint16_t* luts,
                                const int32_t* block_comp, int64_t blocks_per_mcu,
                                int64_t restart_interval, int64_t n_mcus, int64_t ss,
                                int64_t se, int64_t ah, int64_t al, int16_t* blocks) {
  const int32_t p1 = 1 << al, m1 = -(1 << al);
  int64_t mcu = 0;
  for (int64_t ch = 0; ch < n_chunks && mcu < n_mcus; ++ch) {
    const uint8_t* p = data + offsets[ch];
    const int64_t nbytes = offsets[ch + 1] - offsets[ch];
    const int64_t nbits = nbytes * 8;
    int64_t pos = 0;
    int32_t pred[4] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    auto bits = [&](int n) -> int32_t {
      if (n == 0) return 0;
      const int32_t v = static_cast<int32_t>(jpegls_peek_bits(p, nbytes, pos, n));
      pos += n;
      return v;
    };
    auto symbol = [&](const uint16_t* table) -> int {
      const uint16_t entry = table[jpegls_peek_bits(p, nbytes, pos, 16)];
      if ((entry >> 8) == 0) return -1;
      pos += entry >> 8;
      return entry & 0xFF;
    };
    auto correct = [&](int16_t& c) {
      if (bits(1) && (c & p1) == 0) c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
    };
    const int64_t limit = restart_interval == 0
                              ? n_mcus
                              : std::min(n_mcus, mcu + restart_interval);
    for (; mcu < limit; ++mcu) {
      for (int64_t b = 0; b < blocks_per_mcu; ++b) {
        const int comp = block_comp[b];
        const uint16_t* dc = luts + (2 * comp) * 65536;
        const uint16_t* ac = dc + 65536;
        int16_t* blk = blocks + (mcu * blocks_per_mcu + b) * 64;
        if (ss == 0 && ah == 0) {  // DC first
          const int s = symbol(dc);
          if (s < 0 || s > 16) return -1;
          if (s) pred[comp] += jpeg_extend(static_cast<uint32_t>(bits(s)), s);
          blk[0] = static_cast<int16_t>(static_cast<uint32_t>(pred[comp]) << al);
        } else if (ss == 0) {  // DC refinement
          if (bits(1)) blk[0] = static_cast<int16_t>(blk[0] | p1);
        } else if (ah == 0) {  // AC first
          if (eobrun) {
            --eobrun;
            continue;
          }
          for (int64_t k = ss; k <= se; ++k) {
            const int rs = symbol(ac);
            if (rs < 0) return -1;
            const int r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              if (k > 63) return -2;
              const int32_t v = jpeg_extend(static_cast<uint32_t>(bits(s)), s);
              blk[kJpegNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(v) << al);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = (int64_t{1} << r) + bits(r) - 1;
              break;
            }
          }
        } else {  // AC refinement
          int64_t k = ss;
          if (eobrun == 0) {
            for (; k <= se; ++k) {
              const int rs = symbol(ac);
              if (rs < 0) return -1;
              int r = rs >> 4;
              int32_t s = rs & 15;
              if (s) {
                s = bits(1) ? p1 : m1;
              } else if (r != 15) {
                eobrun = (int64_t{1} << r) + bits(r);
                break;
              }
              do {
                int16_t& c = blk[kJpegNatural[k]];
                if (c != 0) {
                  correct(c);
                } else if (--r < 0) {
                  break;
                }
                ++k;
              } while (k <= se);
              if (s) {
                if (k > 63) return -2;
                blk[kJpegNatural[k]] = static_cast<int16_t>(s);
              }
            }
          }
          if (eobrun > 0) {
            for (; k <= se; ++k) {
              int16_t& c = blk[kJpegNatural[k]];
              if (c != 0) correct(c);
            }
            --eobrun;
          }
        }
        if (pos > nbits) return -3;
      }
    }
  }
  return mcu;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JPEG 2000 tier-1 (T.800 Annex C and D, code-block style 0): the MQ decoder
// and the significance, refinement and cleanup passes of one code-block, as
// OpenJPEG's opj_t1_decode_cblk decodes them. io/jpeg2000.py's
// _t1_decode_block is its plain Python version.
// ---------------------------------------------------------------------------

namespace {

const uint16_t kMqQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
    0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
    0x3001, 0x2801, 0x2401, 0x2201, 0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
    0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
    0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kMqNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                             17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                             33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kMqNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                             15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                             30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kMqSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1};

enum { kCtxSc = 9, kCtxMag = 14, kCtxRl = 17, kCtxUni = 18 };

// Zero-coding context by orientation (0 LL, 1 HL, 2 LH, 3 HH) and the
// significant neighbours: [orient][h][v][d] (T.800 Table D.1).
struct ZcTable {
  uint8_t ctx[4][3][3][5];
  ZcTable() {
    for (int o = 0; o < 4; ++o)
      for (int h = 0; h < 3; ++h)
        for (int v = 0; v < 3; ++v)
          for (int d = 0; d < 5; ++d) {
            const int hh = o == 1 ? v : h, vv = o == 1 ? h : v;
            int c;
            if (o == 3) {
              const int hv = hh + vv;
              if (d >= 3) c = 8;
              else if (d == 2) c = hv >= 1 ? 7 : 6;
              else if (d == 1) c = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
              else c = hv >= 2 ? 2 : hv;
            } else if (hh == 2) {
              c = 8;
            } else if (hh == 1) {
              c = vv >= 1 ? 7 : d >= 1 ? 6 : 5;
            } else if (vv == 2) {
              c = 4;
            } else if (vv == 1) {
              c = 3;
            } else {
              c = d >= 2 ? 2 : d;
            }
            ctx[o][h][v][d] = static_cast<uint8_t>(c);
          }
  }
};
const ZcTable kZc;

// Sign coding (Table D.3) by (hc + 1) * 3 + (vc + 1): context and XOR bit.
const uint8_t kScCtx[9] = {13, 12, 11, 10, 9, 10, 11, 12, 13};
const uint8_t kScXor[9] = {1, 1, 1, 1, 0, 0, 0, 0, 0};

// The MQ decoder (T.800 C.3) over a buffer that ends in 0xFF 0xFF.
struct MqDecoder {
  const uint8_t* buf;
  int64_t bp = 0;
  uint32_t c = 0, a = 0x8000;
  int ct = 0;
  uint8_t state[19] = {0};
  uint8_t mps[19] = {0};

  MqDecoder(const uint8_t* b, int64_t len) : buf(b) {
    c = len ? static_cast<uint32_t>(buf[0]) << 16 : 0xFFu << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    state[0] = 4;
    state[kCtxRl] = 3;
    state[kCtxUni] = 46;
  }

  void bytein() {
    if (buf[bp] == 0xFF) {
      if (buf[bp + 1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += static_cast<uint32_t>(buf[bp]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += static_cast<uint32_t>(buf[bp]) << 8;
      ct = 8;
    }
  }

  int decode(int cx) {
    const int s = state[cx];
    const uint32_t qe = kMqQe[s];
    int d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        d = mps[cx];
        state[cx] = kMqNmps[s];
      } else {
        d = 1 - mps[cx];
        if (kMqSwitch[s]) mps[cx] = static_cast<uint8_t>(d);
        state[cx] = kMqNlps[s];
      }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) {
        d = 1 - mps[cx];
        if (kMqSwitch[s]) mps[cx] = static_cast<uint8_t>(d);
        state[cx] = kMqNlps[s];
      } else {
        d = mps[cx];
        state[cx] = kMqNmps[s];
      }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while ((a & 0x8000) == 0);
    return d;
  }
};

// Each coefficient's state, one word: the significance of its 8 neighbours
// (bits 0-7), the sign of its 4 direct neighbours where significant (8-11),
// its own significance, sign, visit in this bit-plane's significance pass
// and first refinement (12-15). A coefficient that becomes significant sets
// its bits in its neighbours' words, so a context is a table lookup.
enum : uint16_t {
  kN = 1, kS = 2, kW = 4, kE = 8, kNW = 16, kNE = 32, kSW = 64, kSE = 128,
  kNegN = 256, kNegS = 512, kNegW = 1024, kNegE = 2048,
  kSig = 4096, kNeg = 8192, kPi = 16384, kMu = 32768,
};

struct ContextTables {
  uint8_t zc[4][256];   // zero coding by orientation and neighbour significance
  uint8_t sc[4096];     // sign coding context by the low 12 bits
  uint8_t sx[4096];     // its XOR bit
  ContextTables() {
    for (int o = 0; o < 4; ++o)
      for (int f = 0; f < 256; ++f) {
        const int h = !!(f & kW) + !!(f & kE), v = !!(f & kN) + !!(f & kS);
        const int d = !!(f & kNW) + !!(f & kNE) + !!(f & kSW) + !!(f & kSE);
        zc[o][f] = kZc.ctx[o][h][v][d];
      }
    for (int f = 0; f < 4096; ++f) {
      auto contribution = [&](uint16_t sig, uint16_t neg) {
        return (f & sig) ? ((f & neg) ? -1 : 1) : 0;
      };
      int hc = contribution(kW, kNegW) + contribution(kE, kNegE);
      int vc = contribution(kN, kNegN) + contribution(kS, kNegS);
      hc = hc < -1 ? -1 : hc > 1 ? 1 : hc;
      vc = vc < -1 ? -1 : vc > 1 ? 1 : vc;
      const int k = (hc + 1) * 3 + vc + 1;
      sc[f] = kScCtx[k];
      sx[f] = kScXor[k];
    }
  }
};
const ContextTables kCtx;

void j2k_decode_block(const uint8_t* data, int64_t len, int w, int h, int orient, int nbps,
                      int passes, int32_t* out) {
  std::memset(out, 0, sizeof(int32_t) * w * h);
  if (nbps <= 0 || passes <= 0 || w == 0 || h == 0) return;
  std::vector<uint8_t> buf(len + 2, 0xFF);
  if (len) std::memcpy(buf.data(), data, len);
  MqDecoder mq(buf.data(), len);
  const int W = w + 2;  // one guard column each side, one guard row above and below
  std::vector<uint16_t> flags(W * (h + 2), 0);
  std::vector<int32_t> val(W * (h + 2), 0);
  uint16_t* f = flags.data();
  const uint8_t* zc = kCtx.zc[orient & 3];

  auto significant = [&](int i, int32_t value) {
    const int low = f[i] & 0xFFF;
    const int s = mq.decode(kCtx.sc[low]) ^ kCtx.sx[low];
    val[i] = s ? -value : value;
    f[i] |= kSig | (s ? kNeg : 0);
    f[i - W - 1] |= kSE;
    f[i - W + 1] |= kSW;
    f[i + W - 1] |= kNE;
    f[i + W + 1] |= kNW;
    f[i - W] |= kS | (s ? kNegS : 0);
    f[i + W] |= kN | (s ? kNegN : 0);
    f[i - 1] |= kE | (s ? kNegE : 0);
    f[i + 1] |= kW | (s ? kNegW : 0);
  };

  int bpno = nbps;
  int pass_type = 2;  // cleanup first
  for (int p = 0; p < passes && bpno >= 1; ++p) {
    const int32_t one = static_cast<int32_t>(1u << bpno);
    const int32_t half = one >> 1;
    const int32_t oneplushalf = one | half;
    for (int k = 0; k < h; k += 4) {
      const int kend = k + 4 < h ? k + 4 : h;
      for (int x = 0; x < w; ++x) {
        const int i0 = (k + 1) * W + x + 1;
        int y = k;
        if (pass_type == 2 && k + 4 <= h &&
            !((f[i0] | f[i0 + W] | f[i0 + 2 * W] | f[i0 + 3 * W]) & (0xFF | kSig | kPi))) {
          if (!mq.decode(kCtxRl)) continue;  // no PI flag to clear in a quiet column
          int run = mq.decode(kCtxUni) << 1;
          run |= mq.decode(kCtxUni);
          significant(i0 + run * W, oneplushalf);
          y = k + run + 1;
        }
        for (int yy = y; yy < kend; ++yy) {
          const int i = i0 + (yy - k) * W;
          const uint16_t fi = f[i];
          if (pass_type == 0) {
            if (!(fi & (kSig | kPi)) && (fi & 0xFF)) {
              if (mq.decode(zc[fi & 0xFF])) significant(i, oneplushalf);
              f[i] |= kPi;
            }
          } else if (pass_type == 1) {
            if ((fi & (kSig | kPi)) == kSig) {
              const int ctx = (fi & kMu) ? kCtxMag + 2 : kCtxMag + ((fi & 0xFF) ? 1 : 0);
              const int v = mq.decode(ctx);
              val[i] += (v ^ (val[i] < 0)) ? half : -half;
              f[i] |= kMu;
            }
          } else if (!(fi & (kSig | kPi))) {
            if (mq.decode(zc[fi & 0xFF])) significant(i, oneplushalf);
          }
        }
        if (pass_type == 2)
          for (int yy = k; yy < kend; ++yy) f[i0 + (yy - k) * W] &= ~kPi;
      }
    }
    if (++pass_type == 3) {
      pass_type = 0;
      --bpno;
    }
  }
  for (int yy = 0; yy < h; ++yy)
    std::memcpy(out + yy * w, val.data() + (yy + 1) * W + 1, sizeof(int32_t) * w);
}

}  // namespace

extern "C" {

// data: every code-block's bytes, concatenated.
// blocks: int64 [n_blocks, 8]: data offset, length, width, height,
//   orientation (0 LL, 1 HL, 2 LH, 3 HH), bit-planes (Mb less the zero
//   bit-planes; 0: not included), coding passes, output offset.
// out: int32, each block's [height, width] decoded values (the decoder's
//   doubled magnitudes, signed) at its output offset.
// Returns 0. Code-blocks are independent: OpenMP runs them in parallel.
int64_t j2k_t1_decode(const uint8_t* data, const int64_t* blocks, int64_t n_blocks,
                      int32_t* out) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t* r = blocks + 8 * b;
    j2k_decode_block(data + r[0], r[1], static_cast<int>(r[2]), static_cast<int>(r[3]),
                     static_cast<int>(r[4]), static_cast<int>(r[5]), static_cast<int>(r[6]),
                     out + r[7]);
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PDF page rasterisation for io/pdf_render.py: the scan converter (coverage
// of an edge list), the compositor, the image resamplers and the CCITT
// Group 4 decoder of io/pdf_parse.py. Integers only, in an order that does
// not matter to the result, so the plain numpy versions in io/pdf_render.py
// and io/pdf_parse.py give the same bytes on any host.
// ---------------------------------------------------------------------------

namespace {

inline int64_t floordiv(int64_t a, int64_t b) {  // b > 0
  int64_t q = a / b;
  if ((a % b) != 0 && (a < 0)) --q;
  return q;
}

struct PdfEdge {
  int64_t s0, s1, x0, y0, x1, y1, w;
};

}  // namespace

extern "C" {

// Coverage of the pixels [bx, bx + bw) x [by, by + bh) by the polygons of
// `edges` (n rows of x0, y0, x1, y1, winding in 1/256 pixel, y0 < y1):
// 16 x 16 samples a pixel at the sample centres ((16 k + 8) / 256), nonzero
// (rule 0) or even-odd (rule 1); cov = (samples * 255 + 128) >> 8.
int64_t pdf_coverage(const int32_t* edges, int64_t n, int32_t rule, int64_t bx,
                     int64_t by, int64_t bw, int64_t bh, uint8_t* cov) {
  const int64_t s_lo = by * 16, s_hi = (by + bh) * 16, k_hi = bw * 16;
  std::vector<PdfEdge> es;
  es.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* e = edges + 5 * i;
    int64_t s0 = floordiv(int64_t(e[1]) + 7, 16), s1 = floordiv(int64_t(e[3]) + 7, 16);
    s0 = std::max(s0, s_lo);
    s1 = std::min(s1, s_hi);
    if (s0 >= s1) continue;
    es.push_back({s0, s1, e[0], e[1], e[2], e[3], e[4]});
  }
  std::sort(es.begin(), es.end(),
            [](const PdfEdge& a, const PdfEdge& b) { return a.s0 < b.s0; });
  std::vector<int32_t> diff(bw + 1), extra(bw + 1);
  std::vector<std::pair<int64_t, int64_t>> xs;
  std::vector<const PdfEdge*> active;
  size_t next = 0;
  for (int64_t py = by; py < by + bh; ++py) {
    std::fill(diff.begin(), diff.end(), 0);
    std::fill(extra.begin(), extra.end(), 0);
    for (int64_t s = py * 16; s < py * 16 + 16; ++s) {
      while (next < es.size() && es[next].s0 <= s) active.push_back(&es[next++]);
      size_t keep = 0;
      for (size_t i = 0; i < active.size(); ++i)
        if (active[i]->s1 > s) active[keep++] = active[i];
      active.resize(keep);
      if (active.empty()) continue;
      const int64_t ys = s * 16 + 8;
      xs.clear();
      for (const PdfEdge* e : active) {
        const int64_t x = e->x0 + floordiv((ys - e->y0) * (e->x1 - e->x0), e->y1 - e->y0);
        int64_t k = floordiv(x + 7, 16) - bx * 16;
        k = std::min(std::max(k, int64_t(0)), k_hi);
        xs.push_back({k, e->w});
      }
      std::sort(xs.begin(), xs.end());
      int64_t wsum = 0;
      for (size_t i = 0; i + 1 < xs.size(); ++i) {
        wsum += xs[i].second;
        const bool inside = rule ? (wsum & 1) != 0 : wsum != 0;
        if (!inside) continue;
        const int64_t ka = xs[i].first, kb = xs[i + 1].first;
        if (ka == kb) continue;
        diff[kb >> 4] -= 16;
        extra[kb >> 4] += int32_t(kb & 15);
        diff[ka >> 4] += 16;
        extra[ka >> 4] -= int32_t(ka & 15);
      }
    }
    int32_t run = 0;
    uint8_t* row = cov + (py - by) * bw;
    for (int64_t p = 0; p < bw; ++p) {
      run += diff[p];
      const int32_t count = run + extra[p];
      row[p] = uint8_t((count * 255 + 128) >> 8);
    }
  }
  return 0;
}

// Composite onto the RGB page (H x W x 3) over [bx, bx + bw) x [by, by + bh):
// a = cov, times the clip mask (ch x cw at cx, cy; 0 outside it; none when
// clip is null) / 255, times alpha / 255, each rounded; the colour is src
// (bh x bw x 3) or rgb; d = (d (255 - a) + s a + 127) / 255.
int64_t pdf_composite(uint8_t* page, int64_t W, int64_t H, int64_t bx, int64_t by,
                      int64_t bw, int64_t bh, const uint8_t* cov, const uint8_t* src,
                      const uint8_t* rgb, int32_t alpha, const uint8_t* clip, int64_t cx,
                      int64_t cy, int64_t cw, int64_t ch) {
  for (int64_t y = 0; y < bh; ++y) {
    const int64_t py = by + y;
    if (py < 0 || py >= H) continue;
    for (int64_t x = 0; x < bw; ++x) {
      const int64_t px = bx + x;
      if (px < 0 || px >= W) continue;
      int32_t a = cov[y * bw + x];
      if (clip) {
        const int64_t mx = px - cx, my = py - cy;
        const int32_t m = (mx >= 0 && mx < cw && my >= 0 && my < ch) ? clip[my * cw + mx] : 0;
        a = (a * m + 127) / 255;
      }
      a = (a * alpha + 127) / 255;
      if (a == 0) continue;
      uint8_t* d = page + (py * W + px) * 3;
      const uint8_t* s = src ? src + (y * bw + x) * 3 : rgb;
      for (int c = 0; c < 3; ++c) d[c] = uint8_t((d[c] * (255 - a) + s[c] * a + 127) / 255);
    }
  }
  return 0;
}

// Separable resampling by weight tables (14-bit weights summing to 1 << 14
// a row of a table): out[i, j, c] = (sum_t yw[i, t] sum_u xw[j, u]
// src[yi[i, t], xi[j, u], c] + (1 << 27)) >> 28.
int64_t pdf_resample_axes(const uint8_t* src, int64_t sh, int64_t sw, int64_t nc,
                          const int32_t* xi, const int32_t* xw, int64_t bw, int64_t kx,
                          const int32_t* yi, const int32_t* yw, int64_t bh, int64_t ky,
                          uint8_t* out) {
  int64_t r_lo = sh, r_hi = -1;
  for (int64_t i = 0; i < bh * ky; ++i) {
    if (yw[i] == 0) continue;
    r_lo = std::min<int64_t>(r_lo, yi[i]);
    r_hi = std::max<int64_t>(r_hi, yi[i]);
  }
  if (r_hi < r_lo) {
    std::memset(out, 0, size_t(bh * bw * nc));
    return 0;
  }
  const int64_t rows = r_hi - r_lo + 1;
  std::vector<int32_t> tmp(size_t(rows * bw * nc));
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    const uint8_t* s = src + (r_lo + r) * sw * nc;
    int32_t* t = tmp.data() + r * bw * nc;
    for (int64_t j = 0; j < bw; ++j)
      for (int64_t c = 0; c < nc; ++c) {
        int32_t acc = 0;
        for (int64_t u = 0; u < kx; ++u) acc += xw[j * kx + u] * s[xi[j * kx + u] * nc + c];
        t[j * nc + c] = acc;
      }
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < bh; ++i)
    for (int64_t j = 0; j < bw; ++j)
      for (int64_t c = 0; c < nc; ++c) {
        int64_t acc = 0;
        for (int64_t t = 0; t < ky; ++t) {
          const int32_t w = yw[i * ky + t];
          if (w) acc += int64_t(w) * tmp[((yi[i * ky + t] - r_lo) * bw + j) * nc + c];
        }
        out[(i * bw + j) * nc + c] = uint8_t((acc + (int64_t(1) << 27)) >> 28);
      }
  return 0;
}

// Bilinear resampling through an affine map in 1/65536 source pixels: the
// centre of page pixel (X, Y) is at u = m0 X + m1 Y + m2, v = m3 X + m4 Y +
// m5; mask 255 where 0 <= u < sw and 0 <= v < sh, else 0 (out 0 there).
int64_t pdf_resample_affine(const uint8_t* src, int64_t sh, int64_t sw, int64_t nc,
                            const int64_t* m, int64_t bx, int64_t by, int64_t bw,
                            int64_t bh, uint8_t* out, uint8_t* mask) {
  const int64_t one = 65536;
#pragma omp parallel for schedule(static)
  for (int64_t y = 0; y < bh; ++y)
    for (int64_t x = 0; x < bw; ++x) {
      const int64_t X = bx + x, Y = by + y;
      const int64_t u = m[0] * X + m[1] * Y + m[2], v = m[3] * X + m[4] * Y + m[5];
      uint8_t* o = out + (y * bw + x) * nc;
      if (u < 0 || v < 0 || u >= sw * one || v >= sh * one) {
        mask[y * bw + x] = 0;
        for (int64_t c = 0; c < nc; ++c) o[c] = 0;
        continue;
      }
      mask[y * bw + x] = 255;
      const int64_t uu = u - one / 2, vv = v - one / 2;
      int64_t i0 = floordiv(uu, one), j0 = floordiv(vv, one);
      const int64_t fu = uu - i0 * one, fv = vv - j0 * one;
      int64_t i1 = std::min(i0 + 1, sw - 1), j1 = std::min(j0 + 1, sh - 1);
      i0 = std::max<int64_t>(i0, 0);
      j0 = std::max<int64_t>(j0, 0);
      i1 = std::max<int64_t>(i1, 0);
      j1 = std::max<int64_t>(j1, 0);
      for (int64_t c = 0; c < nc; ++c) {
        const int64_t s00 = src[(j0 * sw + i0) * nc + c], s01 = src[(j0 * sw + i1) * nc + c];
        const int64_t s10 = src[(j1 * sw + i0) * nc + c], s11 = src[(j1 * sw + i1) * nc + c];
        const int64_t top = s00 * (one - fu) + s01 * fu, bot = s10 * (one - fu) + s11 * fu;
        o[c] = uint8_t((top * (one - fv) + bot * fv + (int64_t(1) << 31)) >> 32);
      }
    }
  return 0;
}

// CCITT Group 4 (T.6) decode, the algorithm of io/pdf_parse.py's
// g4_decode_plain: out (max_rows x columns, zeroed) gets 1 where a pixel is
// black. Returns the rows decoded, -1 on a corrupt code (with the row in
// *bad_row), -2 on an extension code.
int64_t pdf_g4_decode(const uint8_t* data, int64_t n, int64_t columns, int64_t rows,
                      int32_t byte_align, const int32_t* white, const int32_t* black,
                      const int32_t* modes, uint8_t* out, int64_t max_rows,
                      int64_t* bad_row) {
  const int64_t end = n * 8;
  int64_t pos = 0;
  auto peek = [&](int count) -> uint32_t {
    uint32_t v = 0;
    for (int i = 0; i < count; ++i) {
      const int64_t p = pos + i;
      const uint32_t bit = p < end ? (data[p >> 3] >> (7 - (p & 7))) & 1 : 0;
      v = (v << 1) | bit;
    }
    return v;
  };
  std::vector<int64_t> ref = {columns, columns, columns}, cur, clean;
  int64_t done = 0;
  while (rows <= 0 || done < rows) {
    if (done >= max_rows) break;
    if (byte_align && (pos & 7)) pos += 8 - (pos & 7);
    if (pos >= end) break;
    if (peek(12) == 1) break;  // EOFB
    cur.clear();
    int64_t a0 = -1;
    int color = 0;
    size_t i = 0;
    bool bad = false;
    while (a0 < columns) {
      while (i > 0 && ref[i - 1] > a0) --i;
      while (ref[i] <= a0 || int64_t(i & 1) != color) ++i;
      const int64_t b1 = ref[i], b2 = ref[i + 1];
      const int32_t entry = modes[peek(13)];
      if (entry == 0) { bad = true; break; }
      pos += entry >> 16;
      const int mode = entry & 0xFFFF;
      if (mode == 8) {  // pass
        a0 = b2;
      } else if (mode == 9) {  // horizontal
        const int64_t start = std::max<int64_t>(a0, 0);
        int64_t run[2] = {0, 0};
        for (int h = 0; h < 2 && !bad; ++h) {
          const int32_t* table = ((h == 0 ? color : 1 - color) == 0) ? white : black;
          for (;;) {
            const int32_t e = table[peek(13)];
            if (e == 0) { bad = true; break; }
            pos += e >> 16;
            run[h] += e & 0xFFFF;
            if ((e & 0xFFFF) < 64) break;
          }
        }
        if (bad) break;
        const int64_t a1 = std::min(start + run[0], columns);
        const int64_t a2 = std::min(a1 + run[1], columns);
        cur.push_back(a1);
        cur.push_back(a2);
        a0 = a2;
      } else if (mode == 10) {
        return -2;
      } else {
        const int64_t a1 = b1 + mode - 3;
        if (a1 < 0 || a1 > columns || (!cur.empty() && a1 < cur.back())) { bad = true; break; }
        cur.push_back(a1);
        a0 = a1;
        color = 1 - color;
      }
      if (pos > end + 24) { bad = true; break; }
    }
    if (bad) {
      *bad_row = done;
      return -1;
    }
    uint8_t* row = out + done * columns;
    for (size_t k = 0; k + 1 < cur.size(); k += 2)
      for (int64_t x = cur[k]; x < cur[k + 1]; ++x) row[x] = 1;
    if (cur.size() % 2)
      for (int64_t x = cur.back(); x < columns; ++x) row[x] = 1;
    ++done;
    clean.clear();
    for (int64_t c : cur) {
      if (c >= columns) break;
      if (!clean.empty() && clean.back() == c) clean.pop_back();
      else clean.push_back(c);
    }
    ref = clean;
    ref.push_back(columns);
    ref.push_back(columns);
    ref.push_back(columns);
  }
  return done;
}

}  // extern "C"
