// The tile policies of the Hopper mainloop (hopper_attn.cuh) for the
// gather kernels K1/K1s (SparseTiles) and K2 (GroupedTiles), their launch
// parameters and the key-window mask.  block_sparse.cu launches them as K1,
// K1s and K2; variants.cu derives the S3a and S2 ablations from them (a
// library of its own, so K1/K2 compile as they do without it).  What K1 and
// K2 compute, and the degenerate rows, are in block_sparse.cu's header.
#pragma once

#include "hopper_attn.cuh"

namespace {

// ------------------------------------------------------------ K1 and K1s ---
//
// K1 (and K1s, STATS) on the Hopper mainloop of hopper_attn.cuh.  A CTA
// owns 128 query rows, so with block_m in {128, ..., 1024} it reads exactly
// one index list, once.  Its producer loads the list and issues one TMA
// box pair per listed block (gathering is the block's row coordinate); the
// consumers mask each unit branch-free: the clean prefix keeps every key,
// a later slot keeps col < visual_len or text_start <= col < text_start +
// text_len[b], by selects.
//
// Key split.  A launch of fewer 128-row tiles than the card has SMs (text
// rows, a ring step's text rows) splits each list's slots into n_split
// contiguous ranges of split_slots slots, a multiple of chunk_blocks; CTA
// (tile, split) walks its range and writes its normalised output and its
// m and l in fp32 (o_part, m_out, l_out [n_split, BH, Sq(, D)]), which
// merge_splits_kernel folds as attention/ring.py::_merge does.  Ranges
// start on chunk boundaries, so the range that holds a list's last slot
// also holds its chunk padding: a degenerate list (every gathered key
// masked, count > 0) adds the padding lanes there, and the merge of
// ranges that all scored MASK_VALUE is the JAX chunk average.  Where
// another range has a real key, a range's MASK_VALUE partial weighs
// exp(MASK_VALUE - m) = 0.

struct K1Params {
  CUtensorMap tmq, tmk, tmv;   // (D, row, bh, 1) maps of q, K and V
  void* o;                     // [BH, Sq, D] (n_split == 1)
  float* o_part;               // [n_split, BH, Sq, D] (n_split > 1)
  float* m_out;                // K1s [BH, Sq], or the split's [n_split, BH, Sq]
  float* l_out;
  const void* v;               // V (the degenerate pass reads it directly)
  const int* indices;          // [BH, n_list, nb_slots]
  const int* counts;           // [BH, n_list]
  const int* clean;            // [BH, n_list]
  const int* rowbits;          // K2: [BH, n_list, nb_slots]
  const int* text_len;         // [B]
  long long kv_bh_stride, kv_row_stride;   // elements
  int heads, sq, n_list, nb_slots, num_key_blocks, block_m, chunk_blocks;
  int visual_len, text_start, has_text;
  int n_split, split_slots;
  int group;                   // K2: row blocks per union list
  float sm_scale;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// A unit's key window, computed once: offsets (from this thread's first
// column) below `vis` or in [t_lo, t_lo + t_n) are keys, the rest score
// MASK_VALUE.  A unit in the clean prefix or wholly inside the visual
// window (`all`, the same for every thread) keeps every score.
struct KeyWindow {
  int vis, t_lo;
  unsigned t_n;
  bool all;
};

// s's lanes outside the window set to their row's `masked` value
// (MASK_VALUE for the fp32 scores; K1q mxu8 masks integer scores and
// exponents too)
template <typename V>
__device__ __forceinline__ void mask_lanes(const KeyWindow& w, V (&s)[64],
                                           const V (&masked)[2]) {
  if (w.all) return;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int off = 8 * (i >> 2) + (i & 1);
    const bool ok = (off < w.vis) | ((unsigned)(off - w.t_lo) < w.t_n);
    s[i] = ok ? s[i] : masked[(i >> 1) & 1];
  }
}

__device__ __forceinline__ void mask_window(const KeyWindow& w,
                                            float (&s)[64]) {
  const float masked[2] = {MASK_VALUE, MASK_VALUE};
  mask_lanes(w, s, masked);
}

// a key block starting at key k0 holds a key of the window
__device__ __forceinline__ bool block_has_key(int k0, int visual_len,
                                              int text_start, int has_text,
                                              int tlen) {
  return k0 < visual_len || (has_text && tlen > 0 &&
                             k0 < text_start + tlen &&
                             k0 + HA_KEYS > text_start);
}
// o / l of a thread's rows (row: the r = 0 row's index in [BH * Sq]) in
// T, and with STATS m and l, one lane of each row's quad; o holds N = D / 2
// floats a thread at head_dim D
template <typename T, bool STATS, int N>
__device__ __forceinline__ void store_rows(void* out, float* m_out,
                                           float* l_out, long long row,
                                           const float (&o)[N],
                                           const float (&m)[2],
                                           const float (&l)[2],
                                           const float (&inv)[2],
                                           const Frag& f) {
  constexpr int D = 2 * N;
  T* o0 = reinterpret_cast<T*>(out) + row * D + 2 * f.t4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(o0 + r * 8 * D + 8 * j) =
          Type<T>::pack(o[4 * j + 2 * r] * inv[r],
                        o[4 * j + 2 * r + 1] * inv[r]);
  }
  if constexpr (STATS) {
    if (f.t4 == 0) {
      m_out[row] = m[0];
      l_out[row] = l[0];
      m_out[row + 8] = m[1];
      l_out[row + 8] = l[1];
    }
  }
}

// at head_dim D (SparseTiles below is D = 128, whose kernels keep their
// names; block_sparse.cu launches SparseTilesAt<T, STATS, 64> directly)
template <typename T, bool STATS, int D>
struct SparseTilesAt : MainloopBase<D> {
  using Params = K1Params;
  using Cursor = typename MainloopBase<D>::Cursor;
  static constexpr bool SCALE_Q = true;   // q * sm_scale rounded to T
  struct Tile {
    int q_row, q_head, q_batch, kv_head, kv_batch, u0, u1;
    int bh, split, count, clean, tlen;
    const int* idx;
  };
  // one tile per CTA: blockIdx.x = row tile * n_split + split, y = bh
  static __device__ int first(const Params&) { return 0; }
  static __device__ int count(const Params&) { return 1; }
  static __device__ int stride(const Params&) { return 1; }
  static __device__ Tile tile(const Params& p, int) {
    Tile c;
    const int rt = blockIdx.x / p.n_split;
    c.split = blockIdx.x % p.n_split;
    c.bh = blockIdx.y;
    const long long lr = (long long)c.bh * p.n_list + rt * HA_ROWS / p.block_m;
    c.count = p.counts[lr];
    c.clean = p.clean[lr];
    c.idx = p.indices + lr * p.nb_slots;
    c.tlen = p.text_len[c.bh / p.heads];
    c.q_row = rt * HA_ROWS;
    c.q_head = c.kv_head = c.bh;
    c.q_batch = c.kv_batch = 0;
    c.u0 = c.split * p.split_slots;
    c.u1 = min(c.count, c.u0 + p.split_slots);
    return c;
  }
  static __device__ int block_of(const Params& p, const Tile& c, int slot) {
    const int blk = c.idx[slot];
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  }
  static __device__ int next(const Params&, const Tile&, int u) { return u; }
  static __device__ int key_row(const Params& p, const Tile& c, int u,
                                Cursor&) {
    return block_of(p, c, u) * HA_KEYS;
  }
  using Window = KeyWindow;
  static __device__ Window window(const Params& p, const Tile& c, int u,
                                  const Frag& f) {
    const int blk0 = block_of(p, c, u) * HA_KEYS;
    Window w;
    w.all = (u < c.clean) | (blk0 + HA_KEYS <= p.visual_len);
    w.vis = p.visual_len - blk0 - 2 * f.t4;
    w.t_lo = p.text_start - blk0 - 2 * f.t4;
    w.t_n = p.has_text ? (unsigned)c.tlen : 0u;
    return w;
  }
  static __device__ void mask(const Params&, const Window& w,
                              float (&s)[64]) {
    mask_window(w, s);
  }
  static __device__ void finish(const Params& p, const Tile& c,
                                float (&o)[D / 2], float (&m)[2],
                                float (&l)[2], const Frag& f, float* sums) {
    // degenerate rows (the header of this file): this warpgroup's rows
    // share the list and the window, so all of them or none are; the
    // range holding the list's last slot adds every lane of the chunk
    // padding, p = 1, from the column sums of V over the padding blocks
    // (thread wtid sums column wtid; at D = 64 half the threads)
    if (c.count > c.u0 && c.count <= c.u0 + p.split_slots &&
        m[0] <= MASK_VALUE) {
      const int g = p.chunk_blocks;
      const int npad = (c.count + g - 1) / g * g;
      const T* vb = reinterpret_cast<const T*>(p.v) +
                    (long long)c.bh * p.kv_bh_stride + f.wtid;
      float acc = 0.f;
      for (int ps = c.count; ps < npad && (D == HA_D || f.wtid < D); ++ps) {
        // past the list: the JAX wrapper's padding, block 0
        const int blk = ps < p.nb_slots ? block_of(p, c, ps) : 0;
        const T* vr = vb + (long long)blk * HA_KEYS * p.kv_row_stride;
        for (int r = 0; r < HA_KEYS; ++r)
          acc += to_float(vr[(long long)r * p.kv_row_stride]);
      }
      sums[f.wtid] = acc;
      wg_sync(f.wg);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        o[i] += sums[8 * (i >> 2) + 2 * f.t4 + (i & 1)];
      l[0] += 32.f * (npad - c.count);   // this thread's 32 of 128 lanes
      l[1] += 32.f * (npad - c.count);
      m[0] = m[1] = MASK_VALUE;
    }
    float inv[2];
    quad_sum(l, inv);
    const long long row = (long long)c.bh * p.sq + c.q_row + f.row;
    if (p.n_split == 1) {
      store_rows<T, STATS>(p.o, p.m_out, p.l_out, row, o, m, l, inv, f);
    } else {
      const long long prow = (long long)c.split * gridDim.y * p.sq + row;
      float* o0 = p.o_part + prow * D + 2 * f.t4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(o0 + r * 8 * D + 8 * j) =
              make_float2(o[4 * j + 2 * r] * inv[r],
                          o[4 * j + 2 * r + 1] * inv[r]);
      }
      if (f.t4 == 0) {
        p.m_out[prow] = m[0];
        p.l_out[prow] = l[0];
        p.m_out[prow + 8] = m[1];
        p.l_out[prow + 8] = l[1];
      }
    }
  }
};

template <typename T, bool STATS>
struct SparseTiles : SparseTilesAt<T, STATS, HA_D> {};

// ------------------------------------------------------------------- K2 ---
//
// K2 on the same mainloop.  A CTA owns 128 query rows, which lie in one
// row block (block_m a multiple of 128) and so share one membership bit of
// their union list.  Producer and consumers walk the same units, found by
// next(): the member slots (slot < clean, or the bit set in rowbits).  A
// non-member tile, whose scores the JAX kernel pushes to MASK_VALUE, is
// neither copied nor computed, so a CTA does K1's work on its own pairs.
// A degenerate CTA (count > 0 and no member slot holding a key of the
// window; decided from the list before the walk, the same way in every
// thread) walks instead every slot of ceil(count / chunk_blocks) chunks —
// own, non-member and padding (block 0 past the list) — with every score
// masked, so p = 1 on each lane: the JAX chunk average.

template <typename T, int D>
struct GroupedTilesAt : SparseTilesAt<T, false, D> {
  using Params = K1Params;
  using Window = KeyWindow;
  struct Tile {
    int q_row, q_head, q_batch, kv_head, kv_batch, u0, u1;
    int bh, count, clean, tlen, bit;
    bool degenerate;
    const int* idx;
    const int* bits;
  };
  static __device__ int block_of(const Params& p, const Tile& c, int slot) {
    if (slot >= p.nb_slots) return 0;   // chunk padding
    const int blk = c.idx[slot];
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  }
  static __device__ bool member(const Tile& c, int slot) {
    return slot < c.clean || ((c.bits[slot] >> c.bit) & 1);
  }
  // slot holds a key of the window
  static __device__ bool live(const Params& p, const Tile& c, int slot) {
    return slot < c.clean ||
           block_has_key(block_of(p, c, slot) * HA_KEYS, p.visual_len,
                         p.text_start, p.has_text, c.tlen);
  }
  static __device__ Tile tile(const Params& p, int) {
    return tile_at(p, blockIdx.x);
  }
  // row tile rt of head blockIdx.y
  static __device__ Tile tile_at(const Params& p, int rt) {
    Tile c;
    const int rb = rt * HA_ROWS / p.block_m;
    c.bh = blockIdx.y;
    c.bit = rb % p.group;
    const long long lr = (long long)c.bh * p.n_list + rb / p.group;
    c.count = p.counts[lr];
    c.clean = p.clean[lr];
    c.idx = p.indices + lr * p.nb_slots;
    c.bits = p.rowbits + lr * p.nb_slots;
    c.tlen = p.text_len[c.bh / p.heads];
    c.q_row = rt * HA_ROWS;
    c.q_head = c.kv_head = c.bh;
    c.q_batch = c.kv_batch = 0;
    c.u0 = 0;
    int s = 0;   // the first live member (slot 0 for almost every list)
    while (s < c.count && !(member(c, s) && live(p, c, s))) ++s;
    c.degenerate = c.count > 0 && s == c.count;
    const int g = p.chunk_blocks;
    c.u1 = c.degenerate ? (c.count + g - 1) / g * g : c.count;
    return c;
  }
  static __device__ int next(const Params&, const Tile& c, int u) {
    if (!c.degenerate)
      while (u < c.count && !member(c, u)) ++u;
    return u;
  }
  static __device__ int key_row(const Params& p, const Tile& c, int u,
                                typename MainloopBase<D>::Cursor&) {
    return block_of(p, c, u) * HA_KEYS;
  }
  // K1's window; a degenerate CTA's keeps no key
  static __device__ Window window(const Params& p, const Tile& c, int u,
                                  const Frag& f) {
    const int blk0 = block_of(p, c, u) * HA_KEYS;
    Window w;
    w.all = !c.degenerate & ((u < c.clean) | (blk0 + HA_KEYS <= p.visual_len));
    w.vis = c.degenerate ? -(1 << 30) : p.visual_len - blk0 - 2 * f.t4;
    w.t_lo = p.text_start - blk0 - 2 * f.t4;
    w.t_n = (p.has_text && !c.degenerate) ? (unsigned)c.tlen : 0u;
    return w;
  }
  static __device__ void finish(const Params& p, const Tile& c,
                                float (&o)[D / 2], float (&m)[2],
                                float (&l)[2], const Frag& f, float*) {
    float inv[2];
    quad_sum(l, inv);
    store_rows<T, false>(p.o, nullptr, nullptr,
                         (long long)c.bh * p.sq + c.q_row + f.row, o, m, l,
                         inv, f);
  }
};

template <typename T>
struct GroupedTiles : GroupedTilesAt<T, HA_D> {};

}  // namespace
