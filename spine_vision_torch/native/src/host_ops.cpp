// Host-side JPEG entropy decoders: JPEG-Lossless (SOF3) for
// io/jpeg_lossless.py and baseline Huffman (SOF0/SOF1) for io/jpeg.py.
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

}  // extern "C"
