// Native host-side preprocessing kernels for the Kubric data path of tcow_tpu_torch.
//
// The port's copy of tcow_tpu/native/preprocess.cpp (per-instance visible / amodal pixel
// counts and the pairwise overlap statistics of the occlusion / containment DAG, the
// fused augmentation gathers, the painter's reconstruction), plus png_unfilter, which
// undoes the PNG row filters for data/png.py.
//
// Design: per pixel, instance membership is packed into a 64-bit bitset and combined with
// the visible instance id into a single key (mask << 7 | id; valid for K <= 57, and this
// pipeline pads instances to M = 36). Per-frame statistics are then accumulated over a
// histogram of *unique* keys -- scenes contain few distinct overlap patterns, so the
// quadratic pair expansion runs over O(unique) entries instead of O(pixels).
//
// Built with g++ at first use into tcow_tpu_torch/_build/ and loaded via ctypes
// (tcow_tpu_torch/native/__init__.py).

#include <cstdint>
#include <unordered_map>

extern "C" {

// All-in-one per-frame statistics.
//   segm:    (T, H, W) int32, 1-based visible instance ids, 0 = background.
//   div:     (T, H, W, K) uint8 amodal masks ({0, 1}).
// Outputs (zero-initialized by the caller):
//   vis_cnt: (T, K) int64   -- #pixels with segm == k+1
//   tot_cnt: (T, K) int64   -- #pixels with div[..., k] == 1
//   dd:      (T, K, K) int64 -- #pixels where div[k] and div[l] are both 1
//   dv:      (T, K, K) int64 -- #pixels where div[k] == 1 and segm == l+1
// Returns 0 on success, nonzero if K is out of range.
int scene_overlap_stats(const int32_t* segm, const uint8_t* div,
                        int64_t T, int64_t H, int64_t W, int64_t K,
                        int64_t* vis_cnt, int64_t* tot_cnt,
                        int64_t* dd, int64_t* dv) {
  if (K < 1 || K > 57) return 1;
  const int64_t P = H * W;
  std::unordered_map<uint64_t, int64_t> hist;
  hist.reserve(4096);

  for (int64_t t = 0; t < T; ++t) {
    hist.clear();
    const int32_t* s = segm + t * P;
    const uint8_t* d = div + t * P * K;
    int64_t* vis = vis_cnt + t * K;

    for (int64_t p = 0; p < P; ++p) {
      uint64_t m = 0;
      const uint8_t* row = d + p * K;
      for (int64_t k = 0; k < K; ++k) m |= (uint64_t)(row[k] == 1) << k;
      const int32_t raw_id = s[p];
      const uint64_t id = (raw_id >= 1 && raw_id <= K) ? (uint64_t)raw_id : 0;
      if (id != 0) vis[id - 1]++;
      if (m != 0) hist[(m << 7) | id]++;
    }

    int64_t* tot = tot_cnt + t * K;
    int64_t* dd_t = dd + t * K * K;
    int64_t* dv_t = dv + t * K * K;
    for (const auto& kv : hist) {
      const uint64_t mask = kv.first >> 7;
      const uint64_t id = kv.first & 0x7f;
      const int64_t c = kv.second;
      // Expand set bits once.
      int nbits = 0;
      int bits[64];
      for (uint64_t mm = mask; mm; mm &= (mm - 1)) {
        bits[nbits++] = __builtin_ctzll(mm);
      }
      for (int i = 0; i < nbits; ++i) {
        const int k = bits[i];
        tot[k] += c;
        if (id != 0) dv_t[k * K + (id - 1)] += c;
        for (int j = 0; j < nbits; ++j) dd_t[k * K + bits[j]] += c;
      }
    }
  }
  return 0;
}

// Fused amodal-mask augmentation gather (the hot per-item loader path).
//
// Replaces the numpy chain unpackbits -> frame-select -> flip -> crop -> nearest-resize
// of data/kubric.py::_load_example_augmentations, which materializes a stack of
// intermediates per item. Here the composed augmentation is three per-axis
// index maps (computed numpy-side so they replicate the augmentation's exact integer
// arithmetic, incl. cv2's one-ulp INTER_NEAREST scale expression) and ONE pass over the
// bit-packed source emits every layout the rest of the pipeline consumes:
//   out_kthw:  (K, Tc, h, w) uint8   -- the item's div_segm (augmented amodal masks)
//   out_thwk:  (Tc, h, w, K) uint8   -- contiguous input for scene_overlap_stats
//   out_packw: (K, Tc, h, w/8) uint8 -- W-packed rows for the compact collate
//                                       (np.packbits(..., axis=-1) bit order)
//   packed:    (Tv, H, W, KB) uint8  -- np.packbits(div, axis=-1) (K bits, MSB first)
//   delta_cnt: (K, Tc) int64         -- column t counts pixels where frame t differs
//                                       from frame t-1 (column 0 stays 0): the mask
//                                       total-variation term of the query-desirability
//                                       score (query_sampling.py) without a second pass.
// Any of the four outputs may be null; delta_cnt requires out_kthw (it re-reads the
// previous written frame). w must be a multiple of 8 when out_packw != null.
void gather_div_bits(const uint8_t* packed,
                     int64_t Tv, int64_t H, int64_t W, int64_t KB, int64_t K,
                     const int64_t* t_map, const int64_t* y_map, const int64_t* x_map,
                     int64_t Tc, int64_t h, int64_t w,
                     uint8_t* out_kthw, uint8_t* out_thwk, uint8_t* out_packw,
                     int64_t* delta_cnt) {
  const int64_t plane = Tc * h * w;       // out_kthw per-instance plane stride
  const int64_t wb = w / 8;
  for (int64_t t = 0; t < Tc; ++t) {
    const uint8_t* src_t = packed + t_map[t] * H * W * KB;
    for (int64_t y = 0; y < h; ++y) {
      const uint8_t* src_row = src_t + y_map[y] * W * KB;
      uint8_t* thwk_row = out_thwk ? out_thwk + ((t * h + y) * w) * K : nullptr;
      const int64_t kthw_off = (t * h + y) * w;
      for (int64_t x = 0; x < w; ++x) {
        const uint8_t* src_px = src_row + x_map[x] * KB;
        for (int64_t k = 0; k < K; ++k) {
          const uint8_t v = (src_px[k >> 3] >> (7 - (k & 7))) & 1;
          if (out_kthw) {
            uint8_t* dst = out_kthw + k * plane + kthw_off + x;
            if (delta_cnt && t > 0 && v != dst[-h * w]) delta_cnt[k * Tc + t]++;
            *dst = v;
          }
          if (thwk_row) thwk_row[x * K + k] = v;
          if (out_packw && v)
            out_packw[k * Tc * h * wb + (t * h + y) * wb + (x >> 3)]
                |= (uint8_t)(1u << (7 - (x & 7)));
        }
      }
    }
  }
}

// Same composed gather for the visible-segmentation map (int16 source, int32 out).
void gather_segm_i16(const int16_t* segm, int64_t Tv, int64_t H, int64_t W,
                     const int64_t* t_map, const int64_t* y_map, const int64_t* x_map,
                     int64_t Tc, int64_t h, int64_t w, int32_t* out) {
  for (int64_t t = 0; t < Tc; ++t) {
    const int16_t* src_t = segm + t_map[t] * H * W;
    for (int64_t y = 0; y < h; ++y) {
      const int16_t* src_row = src_t + y_map[y] * W;
      int32_t* dst = out + (t * h + y) * w;
      for (int64_t x = 0; x < w; ++x) dst[x] = (int32_t)src_row[x_map[x]];
    }
  }
}

// Painter's-algorithm reconstruction of the visible segmentation from amodal masks.
//   div:   (T, H, W, K) uint8
//   order: (T, K) int32 instance indices back-to-front
//   recon: (T, H, W) int32 output (zero-initialized by the caller)
void paint_recon_segm(const uint8_t* div, const int32_t* order,
                      int64_t T, int64_t H, int64_t W, int64_t K, int32_t* recon) {
  const int64_t P = H * W;
  for (int64_t t = 0; t < T; ++t) {
    const uint8_t* d = div + t * P * K;
    const int32_t* ord = order + t * K;
    int32_t* r = recon + t * P;
    for (int64_t p = 0; p < P; ++p) {
      const uint8_t* row = d + p * K;
      // Walk front-to-back and take the first hit (equivalent to painting back-to-front).
      for (int64_t oi = K - 1; oi >= 0; --oi) {
        const int32_t k = ord[oi];
        if (row[k] == 1) {
          r[p] = k + 1;
          break;
        }
      }
    }
  }
}

// Undoes the PNG row filters (PNG spec section 9) of a decompressed IDAT stream of a
// non-interlaced image.
//   raw:       (height, 1 + row_bytes) uint8 -- per row a filter-type byte then the row
//   bpp:       bytes per complete pixel, at least 1
//   out:       (height, row_bytes) uint8 reconstructed rows
// Returns 0 on success, else 1 + the index of the first row with an unknown filter type.
// Sub and Up are independent per byte; Avg and Paeth depend on the reconstructed byte bpp
// to the left, so a row is sequential -- the reason this runs natively.
int64_t png_unfilter(const uint8_t* raw, int64_t height, int64_t row_bytes, int64_t bpp,
                     uint8_t* out) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = raw + y * (row_bytes + 1);
    const uint8_t ftype = in[0];
    ++in;
    uint8_t* cur = out + y * row_bytes;
    const uint8_t* prev = y > 0 ? out + (y - 1) * row_bytes : nullptr;
    switch (ftype) {
      case 0:
        for (int64_t i = 0; i < row_bytes; ++i) cur[i] = in[i];
        break;
      case 1:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row_bytes; ++i)
          cur[i] = (uint8_t)(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = p > a ? p - a : a - p;
          const int pb = p > b ? p - b : b - p;
          const int pc = p > c ? p - c : c - p;
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(in[i] + pred);
        }
        break;
      default:
        return 1 + y;
    }
  }
  return 0;
}

}  // extern "C"
