// Block-sparse gather attention for NVIDIA Hopper (sm_90a): kernels K1, K1s,
// K2 and K1q.
//
// Replaces the Pallas TPU kernels of rectified_spaattn_tpu/kernels/block_sparse.py:
//   K1  _sparse_attn_kernel          (launched at :746 by block_sparse_flash_attention)
//   K1s _sparse_attn_kernel with return_stats=True (:311-314): K1 that also
//       writes each row's online-softmax max m and sum l in fp32 (the ring
//       merge of attention/ring.py); a template flag, so K1 compiles to the
//       same code as without it
//   K2  _sparse_attn_kernel_grouped  (launched at :560 by block_sparse_flash_attention_grouped)
//   K1q _sparse_attn_kernel with quant="int8" / "mxu8" (:176-253): the
//       section "K1q" below gives its design
//   K1q-s K1q with return_stats (the JAX wrapper takes both, :606-781):
//       a STATS template flag of hopper_attn_q_kernel, as for K1s
//
// What K1 and K2 compute.  For each (batch*head, query row) the softmax attention
// over the key blocks listed in the first `count` slots of the row's index list
// (128 keys per block), with an online softmax in fp32 (running max m, sum l,
// accumulator acc), output acc / l (0 where l == 0).  The contract is the JAX
// kernel's:
//   * q is scaled by sm_scale in fp32 and rounded to the K/V type before QK^T;
//     P is rounded to the K/V type before PV;
//   * masked scores are the finite MASK_VALUE = -0.7 * FLT_MAX, and m starts at
//     -inf, so a count == 0 row gets exact zeros;
//   * slots before the row's `clean` prefix skip every mask; later slots mask
//     keys outside the window col < visual_len or
//     text_start <= col < text_start + text_len[b];
//   * K2 (grouped): G adjacent row blocks share one union index list; bit r
//     of rowbits says whether a slot's block is in row block r's plan.  The
//     JAX kernel adds MASK_VALUE to the scores of a non-member tile (which
//     absorbs any real score in fp32); here a CTA skips the tile (all its
//     rows are in one row block), which changes nothing for a row with one
//     unmasked key of its own;
//   * degenerate rows: the JAX kernel runs its online softmax over chunks of
//     `chunk_blocks` slots and masks every lane of a chunk past `count`
//     (pad slots past the list read block 0).  A row whose every gathered
//     key is masked (m stays MASK_VALUE, or -inf for a K2 row block with no
//     own slot) while count > 0 therefore averages V over every lane of its
//     ceil(count / chunk_blocks) chunks: its own slots, K2's non-member
//     slots and the padding.  Degeneracy depends only on the list (and
//     K2's bits) and the key window, so all rows of a CTA share it; K1's
//     CTA adds the column sums of V over the padding blocks after its walk;
//     K2's and K1q's decide it from the list before the walk and then walk
//     every slot of those chunks with every score MASK_VALUE (p = 1).
//   * K1s stats, as the JAX kernel returns them: m in score units of
//     q * sm_scale (natural exp, as __expf below), l the fp32 row sum; a
//     count == 0 row gives m = -inf and l = 0, a degenerate row m =
//     MASK_VALUE and l = the lanes it averaged.
//
// Every kernel here runs on the Hopper mainloop (hopper_attn.cuh).  One
// CTA of 384 threads owns 128 query rows, so it walks its index list once:
// a producer warp issues TMA box loads of each walked block's K and V (128
// keys) into a two-stage mbarrier ring, two consumer warpgroups run S =
// Q K^T and O += P V on wgmma.m64n128k16 under an online softmax in fp32
// registers, and the mask is applied branch-free by selects.  K1/K1s and
// K2 are policies of hopper_attn_kernel (SparseTiles and GroupedTiles in
// sparse_tiles.cuh, sections "K1 and K1s" and "K2"); K1's launches of fewer row tiles than SMs split each list into
// key ranges whose fp32 partials a second kernel merges.  K1/K1s, K2 and
// the merge are built at head_dim 128 (SparseTiles, GroupedTiles,
// merge_splits_kernel) and 64 (CogVideoX: SparseTilesAt<T, *, 64>,
// GroupedTilesAt<T, 64>, merge_splits64_kernel): at 64 a q / K / V tile is
// one 64-column half and O += P V runs m64n64k16, the head_dim being the
// policy's compile-time D; K1q stays at 128.  K1q/K1q-s
// (section "K1q") is hopper_attn_q_kernel: the same CTA, with the
// producer warpgroup converting int8 tiles and, for "mxu8", the s8 wgmma.
//
// What bounds K1 on the H100.  At the HunyuanVideo operating point
// (115,456 keys, 24 heads x 128) the sparse visual rows do 4*128^3 flops
// per (row block, key block) pair against ~64 KB of K/V per pair: ~3e13
// flops against ~1.4 GB of unique K/V, so by the roofline the operations
// bound it (989 TF/s dense bf16), not HBM (3.35 TB/s).  The previous
// design (64-row blocks of 4 warps, cp.async 16 bytes at a time, mma.sync,
// a per-element mask that compiled to a branch per score) was held by its
// loads: each 128-row list was walked by two 64-row blocks, so ~128 KB
// crossed L2 per pair, and the copies alone took 0.68 of the kernel at
// ~5.2 TB/s, the mma.sync work alone 0.61 (the S3 ablations in
// variants.cu, bench/kernelvars.py).  The redesign halves the L2 bytes per
// pair (one walk per list), moves the copies to the TMA engine and the
// products to wgmma, and makes the mask a select.  Short-row launches
// (256 text rows: 2 x 24 CTAs) underfilled the 132 SMs; the key split
// fills them.  K2 and K1q ran on that previous design until they moved to
// the mainloop too; they launch at full row counts (900 row tiles x 24
// heads at the HunyuanVideo point), so they take no key split.

#include <type_traits>

// K1/K1s's and K2's tile policies of the mainloop (SparseTiles,
// GroupedTiles), which variants.cu's ablations derive from
#include "sparse_tiles.cuh"

namespace {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ K1's split merge ---
//
// The key split's merge: row r's n_split partials (o normalised, m, l) into
// o in T (and, K1s, the merged m and l), the closed form of folding
// attention/ring.py::_merge over the ranges.  One warp per row, 4 columns
// a lane.
template <typename T, bool STATS>
__global__ void __launch_bounds__(256)
merge_splits_kernel(const float* o_part, const float* m_part,
                    const float* l_part, T* o, float* m_out, float* l_out,
                    long long rows, int n_split) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int col = (threadIdx.x & 31) * 4;
  float mx = neg_inf();
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[s * rows + row]);
  const float m_safe = isfinite(mx) ? mx : 0.f;
  float lsum = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < n_split; ++s) {
    const long long pr = s * rows + row;
    const float ls = l_part[pr];
    const float w = ls > 0.f ? __expf(m_part[pr] - m_safe) * ls : 0.f;
    const float4 x = *reinterpret_cast<const float4*>(o_part + pr * HA_D + col);
    lsum += w;
    acc[0] += x.x * w;
    acc[1] += x.y * w;
    acc[2] += x.z * w;
    acc[3] += x.w * w;
  }
  const float den = lsum > 0.f ? lsum : 1.f;
  T* out = o + row * HA_D + col;
  *reinterpret_cast<uint32_t*>(out) = Type<T>::pack(acc[0] / den, acc[1] / den);
  *reinterpret_cast<uint32_t*>(out + 2) =
      Type<T>::pack(acc[2] / den, acc[3] / den);
  if constexpr (STATS) {
    if (col == 0) {
      m_out[row] = mx;
      l_out[row] = lsum;
    }
  }
}

// The same merge at head_dim 64: 2 columns a lane.
template <typename T, bool STATS>
__global__ void __launch_bounds__(256)
merge_splits64_kernel(const float* o_part, const float* m_part,
                      const float* l_part, T* o, float* m_out, float* l_out,
                      long long rows, int n_split) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int col = (threadIdx.x & 31) * 2;
  float mx = neg_inf();
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, m_part[s * rows + row]);
  const float m_safe = isfinite(mx) ? mx : 0.f;
  float lsum = 0.f;
  float acc[2] = {0.f, 0.f};
  for (int s = 0; s < n_split; ++s) {
    const long long pr = s * rows + row;
    const float ls = l_part[pr];
    const float w = ls > 0.f ? __expf(m_part[pr] - m_safe) * ls : 0.f;
    const float2 x = *reinterpret_cast<const float2*>(o_part + pr * 64 + col);
    lsum += w;
    acc[0] += x.x * w;
    acc[1] += x.y * w;
  }
  const float den = lsum > 0.f ? lsum : 1.f;
  *reinterpret_cast<uint32_t*>(o + row * 64 + col) =
      Type<T>::pack(acc[0] / den, acc[1] / den);
  if constexpr (STATS) {
    if (col == 0) {
      m_out[row] = mx;
      l_out[row] = lsum;
    }
  }
}

template <typename T, int D>
int launch_k1(const K1Params& p, int bh, bool stats, cudaStream_t s) {
  const dim3 grid(p.sq / HA_ROWS * p.n_split, bh);
  // a split launch writes partials, whose merge gives K1s its stats: one
  // kernel for K1 and K1s, so that their outputs agree bit for bit; head_dim
  // 128 runs SparseTiles (the kernels' names of the D = 128 build), 64
  // SparseTilesAt<T, *, 64>
  using K1 = std::conditional_t<D == HA_D, SparseTiles<T, false>,
                                SparseTilesAt<T, false, D>>;
  using K1s = std::conditional_t<D == HA_D, SparseTiles<T, true>,
                                 SparseTilesAt<T, true, D>>;
  if (stats && p.n_split == 1) return launch_hopper_attn<T, K1s>(p, grid, s);
  return launch_hopper_attn<T, K1>(p, grid, s);
}

template <typename T, int D>
int launch_merge(const float* o_part, const float* m_part, const float* l_part,
                 void* o, float* m_out, float* l_out, long long rows,
                 int n_split, cudaStream_t s) {
  const dim3 grid((unsigned)((rows + 7) / 8));
  T* out = static_cast<T*>(o);
  if constexpr (D == HA_D) {
    if (m_out)
      merge_splits_kernel<T, true><<<grid, 256, 0, s>>>(
          o_part, m_part, l_part, out, m_out, l_out, rows, n_split);
    else
      merge_splits_kernel<T, false><<<grid, 256, 0, s>>>(
          o_part, m_part, l_part, out, m_out, l_out, rows, n_split);
  } else {
    if (m_out)
      merge_splits64_kernel<T, true><<<grid, 256, 0, s>>>(
          o_part, m_part, l_part, out, m_out, l_out, rows, n_split);
    else
      merge_splits64_kernel<T, false><<<grid, 256, 0, s>>>(
          o_part, m_part, l_part, out, m_out, l_out, rows, n_split);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K1q ---
//
// K1 on an int8 K|V payload (sparse/ops.py::quantize_kv_blocks): kv
// [BH, S, 2D] int8, K in bytes [0, D) of a row and V in [D, 2D); fp32
// per-slot scales ksc / vsc [BH, n_list, nb_slots], gathered to list order
// and padded to a multiple of chunk_blocks (index 0, scale 0) by the
// wrapper.  Replaces the Pallas kernel _sparse_attn_kernel with
// quant="int8" / "mxu8" (rectified_spaattn_tpu/kernels/block_sparse.py:
// 176-253); K1q-s (STATS) writes m and l as K1s does.
//
// hopper_attn_q_kernel: the mainloop's CTA of 128 rows and 384 threads,
// whose producer warpgroup also converts.  Its first thread issues every
// TMA copy: q once, and per unit the int8 tiles (128 x 128-byte boxes of
// one 2-D map of the payload) into a two-stage staging ring, one unit
// ahead.  All 128 threads convert: they wait for a staged unit and a free
// ring stage, turn the int8 tiles into 16-bit tiles in the ring's swizzled
// layout (exact, in bf16x2 / f16x2 adds), and arrive on the ring stage's
// full barrier; the dequantization stays off the consumers' path.
//   "int8": the converter writes bf16 K and V, and the consumers run K1's
// products: s = (q K^T) * ksc[slot] (q * sm_scale rounded to bf16), l sums
// p, P = bf16(p * vsc[slot]).
//   "mxu8": the consumers quantize their q rows to int8 at tile start (row
// scale qmax * sm_scale / 127) and run S = q8 K8^T on the s8 wgmma
// (m64n128k32, both operands K-major as the payload stands; K8 goes by TMA
// straight into the ring).  p is quantized per row against the max of
// exp(s - m) * vsc over a chunk of chunk_blocks slots, so each chunk takes
// two passes: pass A runs S and keeps the row max and that max; pass B
// runs S again, then p, p8 = round(p * vsc * 127 / pm) and P8 V8 on the
// fp16 wgmma (p8 and V8, converted to fp16 by the converter, are exact
// integers, and a unit's sum, at most 128 * 127 * 127 < 2^24, is exact in
// fp32).  The two passes' QK^T run at the int8 rate.  O is rescaled once
// per chunk instead of keeping a second accumulator: by alpha * 127 / pm at
// the chunk's start and pm / 127 after it; a chunk with pm < 1e-20 adds
// nothing (p8 = 0, its JAX contribution is below 1e-14 of O).
//   Degenerate lists (count > 0, no listed key in the window; decided from
// the list before the walk, the same way by every thread) walk every slot of
// ceil(count / chunk_blocks) chunks, padding included, with every score
// masked: p = 1 on each lane, the JAX chunk average.  Other lists walk
// their count slots only (a padding lane weighs exp(MASK_VALUE - m) = 0).
//
// Shared memory: q (32 KB), the ring (per stage: K as bf16 32 KB, or int8
// 16 KB for mxu8; V as 16 bits, 32 KB), the staging ring (per stage: K8 and
// V8, or V8 alone for mxu8), mxu8's q8 (16 KB) and row scales: 225.6 KB
// ("int8") and 177.6 KB ("mxu8").

constexpr int MODE_INT8 = 0, MODE_MXU8 = 1;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

struct QParams {
  CUtensorMap tmq;            // (D, row, bh, 1) map of q (bf16)
  CUtensorMap tmkv;           // the payload as [BH * S, 2D] int8
  __nv_bfloat16* o;           // [BH, Sq, D]
  float* m_out;               // K1q-s [BH, Sq]
  float* l_out;
  const int* indices;         // [BH, n_list, nb_slots]
  const int* counts;          // [BH, n_list]
  const int* clean;           // [BH, n_list]
  const float* ksc;           // [BH, n_list, nb_slots]
  const float* vsc;
  const int* text_len;        // [B]
  int heads, sq, n_list, nb_slots, num_key_blocks, block_m, chunk_blocks;
  int visual_len, text_start, has_text;
  float sm_scale, row_scale;  // row_scale = sm_scale / 127 (mxu8)
};

template <int MODE>
struct QLayout {
  static constexpr int RING_K = MODE == MODE_INT8 ? HA_TILE : HA_TILE8;
  static constexpr int RING = RING_K + HA_TILE;         // K, then V (16-bit)
  static constexpr int STAGE8 = MODE == MODE_INT8 ? 2 * HA_TILE8 : HA_TILE8;
  static constexpr int Q8 = MODE == MODE_MXU8 ? HA_TILE8 : 0;
  static constexpr int BARS = 1 + 3 * HA_STAGES;        // q, full/empty, staged
  static constexpr int BYTES = 1024 + HA_TILE + HA_STAGES * RING +
                               HA_STAGES * STAGE8 + Q8 + 8 * BARS +
                               HA_ROWS * 4;
};

// One CTA's list and walk, computed alike by every thread.  Unit n of the
// walk: "int8" and degenerate lists, slot n; "mxu8", chunk n / (2 cb) with
// its len slots, pass A (slots s0 ..) for the first len units, pass B
// after.
struct QTile {
  int bh, q_row, count, clean, tlen, n_units;
  bool degenerate;
  const int* idx;
  const float* ksc;
  const float* vsc;
};

__device__ __forceinline__ int q_block(const QParams& p, const QTile& c,
                                       int slot) {
  const int blk = c.idx[slot];
  return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
}

template <int MODE>
__device__ __forceinline__ QTile q_tile(const QParams& p) {
  QTile c;
  const int rt = blockIdx.x;
  c.bh = blockIdx.y;
  c.q_row = rt * HA_ROWS;
  const long long lr = (long long)c.bh * p.n_list + c.q_row / p.block_m;
  c.count = p.counts[lr];
  c.clean = p.clean[lr];
  c.idx = p.indices + lr * p.nb_slots;
  c.ksc = p.ksc + lr * p.nb_slots;
  c.vsc = p.vsc + lr * p.nb_slots;
  c.tlen = p.text_len[c.bh / p.heads];
  int s = 0;   // the first slot with a key of the window
  while (s < c.count && s >= c.clean &&
         !block_has_key(q_block(p, c, s) * HA_KEYS, p.visual_len,
                        p.text_start, p.has_text, c.tlen))
    ++s;
  c.degenerate = c.count > 0 && s == c.count;
  const int g = p.chunk_blocks;
  c.n_units = c.degenerate ? (c.count + g - 1) / g * g
                           : (MODE == MODE_MXU8 ? 2 * c.count : c.count);
  return c;
}

// unit n's slot; pass_b: "int8" units, degenerate units and mxu8's pass B
template <int MODE>
__device__ __forceinline__ int q_unit(const QTile& c, int cb, int n,
                                      bool& pass_b) {
  if (MODE == MODE_INT8 || c.degenerate) {
    pass_b = true;
    return n;
  }
  const int ch = n / (2 * cb), s0 = ch * cb;
  const int len = min(cb, c.count - s0), r = n - 2 * cb * ch;
  pass_b = r >= len;
  return s0 + (pass_b ? r - len : r);
}

// a unit's staged int8 tiles: K8 and V8 ("int8"), V8 ("mxu8")
template <int MODE>
__device__ __forceinline__ void stage_load(unsigned char* dst,
                                           const CUtensorMap* map, int row,
                                           uint64_t* bar) {
  if (MODE == MODE_INT8) {
    tma_load(dst, map, 0, row, bar);
    tma_load(dst + HA_TILE8, map, HA_D, row, bar);
  } else {
    tma_load(dst, map, HA_D, row, bar);
  }
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(HA_THREADS, 1)
hopper_attn_q_kernel(const __grid_constant__ QParams p) {
  using L = QLayout<MODE>;
  using V16 = typename std::conditional<MODE == MODE_INT8, __nv_bfloat16,
                                        __half>::type;
  extern __shared__ unsigned char ha_raw[];
  unsigned char* sq = ha_raw + ((1024u - (smem_addr(ha_raw) & 1023u)) & 1023u);
  unsigned char* ring = sq + HA_TILE;
  unsigned char* stg = ring + HA_STAGES * L::RING;
  unsigned char* sq8 = stg + HA_STAGES * L::STAGE8;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sq8 + L::Q8);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + HA_STAGES;
  uint64_t* sfull = empty + HA_STAGES;
  float* row_sc = reinterpret_cast<float*>(bars + L::BARS);
  const int tid = threadIdx.x;
  constexpr int CONVERTERS = HA_THREADS - HA_CONSUMERS;   // a warpgroup
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < HA_STAGES; ++s) {
      // mxu8: the issuer's K8 copy arrives too
      mbar_init(&full[s], CONVERTERS + (MODE == MODE_MXU8));
      mbar_init(&empty[s], HA_CONSUMERS);
      mbar_init(&sfull[s], 1);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  const QTile c = q_tile<MODE>(p);
  const int cb = p.chunk_blocks;
  const int key_base = c.bh * p.num_key_blocks * HA_KEYS;   // payload row

  if (tid >= HA_CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    // the producer warpgroup: all 128 threads convert, and thread 0 of it
    // also issues the copies in its own program order, so that no warp
    // diverges around a wait.  A unit's staging load is issued one unit
    // ahead; the stage it fills was last converted two staged units
    // earlier, by every thread (the barrier closing each unit).
    const int ci = tid - HA_CONSUMERS;
    const bool issuer = ci == 0;
    auto staged = [&](int n, int& row) {
      bool pass_b;
      row = key_base + q_block(p, c, q_unit<MODE>(c, cb, n, pass_b)) * HA_KEYS;
      return MODE == MODE_INT8 || pass_b;
    };
    int st = 0, ss = 0, ss_next = 0;
    uint32_t ph = 0, sph = 0;
    if (issuer) {
      mbar_expect_tx(q_full, HA_TILE);
      tma_tile(sq, &p.tmq, c.q_row, c.bh, 0, q_full);
    }
    for (int n = -1; n < c.n_units; ++n) {
      int row, row_next;
      if (issuer && n + 1 < c.n_units && staged(n + 1, row_next)) {
        mbar_expect_tx(&sfull[ss_next], L::STAGE8);
        stage_load<MODE>(stg + ss_next * L::STAGE8, &p.tmkv, row_next,
                         &sfull[ss_next]);
        ss_next ^= 1;
      }
      if (n < 0) continue;
      const bool has_v = staged(n, row);
      mbar_wait_or_trap(&empty[st], ph ^ 1);
      if (MODE == MODE_MXU8 && issuer) {
        mbar_expect_tx(&full[st], HA_TILE8);
        tma_load(ring + st * L::RING, &p.tmkv, 0, row, &full[st]);
      }
      if (has_v) {
        mbar_wait_or_trap(&sfull[ss], sph);
        unsigned char* dst = ring + st * L::RING;
        const unsigned char* src = stg + ss * L::STAGE8;
        if (MODE == MODE_INT8) convert_tile<V16>(dst, src, ci);
        convert_tile<V16>(dst + L::RING_K, src + L::STAGE8 - HA_TILE8, ci);
        if (++ss == HA_STAGES) {
          ss = 0;
          sph ^= 1;
        }
      }
      // the stage's generic writes, visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[st]);
      if (++st == HA_STAGES) {
        st = 0;
        ph ^= 1;
      }
      asm volatile("bar.sync 3, 128;\n" ::: "memory");
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    Frag f;
    f.wg = tid >> 7;
    f.wtid = tid & 127;
    f.row = 64 * f.wg + 16 * (f.wtid >> 5) + ((tid & 31) >> 2);
    f.t4 = tid & 3;
    mbar_wait_or_trap(q_full, 0);
    float rs[2] = {0.f, 0.f};   // mxu8: the rows' scales
    // this thread's 16 bytes of q in row group r4 and column half h: chunk
    // wtid % 8 of row r4 * 16 + wtid / 8 of the warpgroup's 64 rows
    auto q_chunk = [&](int r4, int h) {
      return reinterpret_cast<uint4*>(sq + h * HA_HALF + f.wg * HA_BOX) +
             r4 * 128 + f.wtid;
    };
    if constexpr (MODE == MODE_INT8) {
      // q * sm_scale in fp32, rounded to bf16, in place (as K1)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint4* v = q_chunk(i & 3, i >> 2);
        uint4 x = *v;
        uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = Type<__nv_bfloat16>::unpack(w[j]);
          w[j] = Type<__nv_bfloat16>::pack(a.x * p.sm_scale, a.y * p.sm_scale);
        }
        *v = x;
      }
    } else {
      // q per row to int8 against its absmax over D (the JAX kernel's
      // :184-189) into sq8: a row's 16 chunks lie in 8 adjacent lanes
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const uint4 x[2] = {*q_chunk(r4, 0), *q_chunk(r4, 1)};
        float amax = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* w = reinterpret_cast<const uint32_t*>(&x[h]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = Type<__nv_bfloat16>::unpack(w[j]);
            amax = fmaxf(amax, fmaxf(fabsf(a.x), fabsf(a.y)));
          }
        }
#pragma unroll
        for (int k = 1; k < 8; k <<= 1)
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, k));
        const float inv = 127.f / fmaxf(amax, 1e-30f);
        const int rr = r4 * 16 + (f.wtid >> 3), R = 64 * f.wg + rr;
        const int lc = (f.wtid & 7) ^ (rr & 7);   // logical 16-bit chunk
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* w = reinterpret_cast<const uint32_t*>(&x[h]);
          int q8[8];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 a = Type<__nv_bfloat16>::unpack(w[j]);
            q8[2 * j] = __float2int_rn(a.x * inv);
            q8[2 * j + 1] = __float2int_rn(a.y * inv);
          }
          // dims 64 h + 8 lc .. + 7: bytes of int8 chunk 4 h + lc / 2
          *reinterpret_cast<uint2*>(
              sq8 + R * 128 + (((4 * h + (lc >> 1)) ^ (rr & 7)) << 4) +
              ((lc & 1) << 3)) =
              make_uint2(pack_s8(q8[0], q8[1], q8[2], q8[3]),
                         pack_s8(q8[4], q8[5], q8[6], q8[7]));
        }
        if ((f.wtid & 7) == 0) row_sc[R] = amax * p.row_scale;
      }
    }
    // q (or q8) written by this warpgroup, visible to its wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(f.wg);
    if constexpr (MODE == MODE_MXU8) {
      rs[0] = row_sc[f.row];
      rs[1] = row_sc[f.row + 8];
    }
    const unsigned char* qw = MODE == MODE_INT8 ? sq + f.wg * HA_BOX
                                                : sq8 + f.wg * 64 * 128;
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m[2] = {neg_inf(), neg_inf()};
    float l[2] = {0.f, 0.f};   // this thread's 32 columns of each row
    // mxu8: pass A's running row max and max of exp(s - ma) * vsc; pass
    // B's p quantization (127 / pm, or 0) and O's pending factor pm / 127
    float ma[2] = {neg_inf(), neg_inf()}, pa[2] = {0.f, 0.f};
    float pinv[2] = {0.f, 0.f}, post[2] = {1.f, 1.f};
    float m2[2] = {0.f, 0.f};   // m in log2 units (MASK_VALUE kept as is)
    int st = 0;
    uint32_t ph = 0;
    for (int n = 0; n < c.n_units; ++n) {
      bool pass_b;
      const int slot = q_unit<MODE>(c, cb, n, pass_b);
      // the unit's window and scales, read before the wait hides the loads
      const int blk0 = q_block(p, c, slot) * HA_KEYS;
      KeyWindow win;
      win.all = !c.degenerate &
                ((slot < c.clean) | (blk0 + HA_KEYS <= p.visual_len));
      win.vis = c.degenerate ? -(1 << 30) : p.visual_len - blk0 - 2 * f.t4;
      win.t_lo = p.text_start - blk0 - 2 * f.t4;
      win.t_n = (p.has_text && !c.degenerate) ? (unsigned)c.tlen : 0u;
      const float ks = c.ksc[slot], vs = c.vsc[slot];
      if (MODE == MODE_MXU8 && slot % cb == 0) {
        if (!pass_b) {   // a chunk's pass A starts
          ma[0] = ma[1] = neg_inf();
          pa[0] = pa[1] = 0.f;
        } else {         // its pass B starts: m moves to the chunk's max
          float pm_d = 0.f;   // degenerate: every lane has p = 1
          if (c.degenerate)
            for (int s2 = slot; s2 < slot + cb; ++s2)
              pm_d = fmaxf(pm_d, c.vsc[s2]);
          float sc[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float m_next = c.degenerate ? MASK_VALUE : fmaxf(m[r], ma[r]);
            const float pm = c.degenerate ? pm_d : pa[r] * __expf(ma[r] - m_next);
            const float alpha = __expf(m[r] - m_next);
            const bool on = pm >= 1e-20f;
            m[r] = m_next;
            m2[r] = m_next == MASK_VALUE ? MASK_VALUE : m_next * LOG2E;
            l[r] *= alpha;
            sc[r] = post[r] * alpha * (on ? 127.f / pm : 1.f);
            pinv[r] = on ? 127.f / pm : 0.f;
            post[r] = on ? pm / 127.f : 1.f;
          }
#pragma unroll
          for (int i = 0; i < 64; ++i) o[i] *= sc[(i >> 1) & 1];
        }
      }
      // mxu8 pass B: the scores' scale in log2 units, and p's scale to p8
      const float rkl[2] = {rs[0] * ks * LOG2E, rs[1] * ks * LOG2E};
      const float wq[2] = {vs * pinv[0], vs * pinv[1]};
      mbar_wait_or_trap(&full[st], ph);
      const unsigned char* kst = ring + st * L::RING;
      const unsigned char* vst = kst + L::RING_K;
      float s[64];
      if constexpr (MODE == MODE_INT8) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const int off = (kk >> 2) * HA_HALF + (kk & 3) * 32;
          Wgmma<__nv_bfloat16>::ss(s, sw128_desc(qw + off, 16),
                                   sw128_desc(kst + off, 16), kk);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(s);
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] *= ks;
      } else {
        int si[64];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_s8(si, sw128_desc(qw + kk * 32, 16),
                   sw128_desc(kst + kk * 32, 16), kk);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(si);
        if (!pass_b) {
          // pass A: the stage is read no more; the row max of the integer
          // scores (s = (S * row scale) * ksc is monotone in S), then the
          // chunk's running max and max of exp(s - ma) * vsc
          mbar_arrive(&empty[st]);
          if (++st == HA_STAGES) {
            st = 0;
            ph ^= 1;
          }
          const int least[2] = {-2147483647 - 1, -2147483647 - 1};
          mask_lanes(win, si, least);
          int mx[2] = {si[0], si[2]};   // masked lanes: least[]
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            mx[0] = max(mx[0], max(si[4 * j], si[4 * j + 1]));
            mx[1] = max(mx[1], max(si[4 * j + 2], si[4 * j + 3]));
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = max(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float mu = mx[r] == least[r]
                                 ? MASK_VALUE
                                 : (float)mx[r] * rs[r] * ks;
            const float m_new = fmaxf(ma[r], mu);
            pa[r] = fmaxf(pa[r] * __expf(ma[r] - m_new),
                          __expf(mu - m_new) * vs);
            ma[r] = m_new;
          }
          continue;
        }
        // pass B: the exponent s - m in log2 units (int32 to fp32 by the
        // magic number 1.5 * 2^23, |S| < 2^22); a masked lane's is
        // MASK_VALUE - m (p = 1 where m is MASK_VALUE, else 0)
#pragma unroll
        for (int i = 0; i < 64; ++i)
          s[i] = fmaf(__int_as_float(si[i] + 0x4B400000) - 12582912.f,
                      rkl[(i >> 1) & 1], -m2[(i >> 1) & 1]);
        const float masked[2] = {MASK_VALUE - m2[0], MASK_VALUE - m2[1]};
        mask_lanes(win, s, masked);
      }
      if constexpr (MODE == MODE_INT8) mask_window(win, s);
      uint32_t pf[8][4];   // P as the A fragments of PV
      float ls[2] = {0.f, 0.f};
      if constexpr (MODE == MODE_INT8) {
        // K1's online softmax over the unit
        float mc[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          mc[0] = fmaxf(mc[0], fmaxf(s[4 * j], s[4 * j + 1]));
          mc[1] = fmaxf(mc[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
          mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
          const float m_new = fmaxf(m[r], mc[r]);
          alpha[r] = __expf(m[r] - m_new);
          m[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e = __expf(s[i] - m[(i >> 1) & 1]);
          ls[(i >> 1) & 1] += e;
          s[i] = e * vs;
        }
        l[0] = alpha[0] * l[0] + ls[0];
        l[1] = alpha[1] * l[1] + ls[1];
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= alpha[(i >> 1) & 1];
      } else {
        // pass B: m is the chunk's; p8 = round(p * vsc * 127 / pm): 1024 +
        // p * vsc * 127 / pm (at most 1151.5) rounds to an integer as it
        // becomes fp16, then 1024 goes (exact)
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const float e = ex2(s[i]);
          ls[(i >> 1) & 1] += e;
          s[i] = fmaf(e, wq[(i >> 1) & 1], 1024.f);
        }
        l[0] += ls[0];
        l[1] += ls[1];
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pf[kk][q] = Type<V16>::pack(s[8 * kk + 2 * q], s[8 * kk + 2 * q + 1]);
          if constexpr (MODE == MODE_MXU8)
            asm("sub.f16x2 %0, %0, %1;\n" : "+r"(pf[kk][q]) : "r"(0x64006400u));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        Wgmma<V16>::rs(o, pf[kk], sw128_desc(vst + kk * 2048, HA_HALF));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pf);
      mbar_arrive(&empty[st]);
      if (++st == HA_STAGES) {
        st = 0;
        ph ^= 1;
      }
    }
    if constexpr (MODE == MODE_MXU8) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[i] *= post[(i >> 1) & 1];
    }
    float inv[2];
    quad_sum(l, inv);
    store_rows<__nv_bfloat16, STATS>(p.o, p.m_out, p.l_out,
                                     (long long)c.bh * p.sq + c.q_row + f.row,
                                     o, m, l, inv, f);
  }
}


template <int MODE, bool STATS>
int launch_q(const QParams& p, dim3 grid, cudaStream_t s) {
  auto kern = hopper_attn_q_kernel<MODE, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, QLayout<MODE>::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, HA_THREADS, QLayout<MODE>::BYTES, s>>>(p);
  return (int)cudaGetLastError();
}

// The kernels of one head_dim, D = 128 or 64: q [BH, Sq, D] dense, K and V
// rows of D elements `kv_row_stride` apart (D, or 2D for the packed K|V
// stream), maps of D columns.
template <int D>
int encode_k1_maps(K1Params& p, int dtype, const void* q, const void* k,
                   const void* v, int bh, int sq, long long s,
                   long long kv_bh_stride, long long kv_row_stride) {
  if (encode_rows_map(&p.tmq, dtype, q, sq, bh, 1, D, (long long)sq * D,
                      (long long)bh * sq * D, 64, D) ||
      encode_rows_map(&p.tmk, dtype, k, s, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride, 64, D) ||
      encode_rows_map(&p.tmv, dtype, v, s, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride, 64, D))
    return -2;
  return 0;
}

// head_dim 128 or 64 with K and V rows D or 2D (packed) apart
bool k1_shape_ok(int head_dim, long long kv_row_stride) {
  return (head_dim == HA_D || head_dim == 64) &&
         (kv_row_stride == head_dim || kv_row_stride == 2 * head_dim);
}

}  // namespace

extern "C" {

// K1: one index list per block_m query rows (block_m a multiple of 128);
// K1s when `stats`.  n_split == 1: o [BH, Sq, D] in the K/V type, and K1s's
// m_out / l_out [BH, Sq].  n_split > 1: the ranges' partials into o_part
// [n_split, BH, Sq, D] and m_out / l_out [n_split, BH, Sq], all fp32, for
// rsa_k1_merge_launch.  head_dim 128 or 64.  Returns a cudaError_t value (0
// on success), -1 for an unsupported (dtype, head_dim, row stride), -2 if
// a tensor map cannot be encoded.
int rsa_k1_launch(const void* q, const void* k, const void* v, void* o,
                  float* o_part, float* m_out, float* l_out,
                  const int* indices, const int* counts, const int* clean,
                  const int* text_len, long long kv_bh_stride,
                  long long kv_row_stride, int bh, int heads, int sq,
                  int n_list, int nb_slots, int num_key_blocks, int block_m,
                  int chunk_blocks, int visual_len, int text_start,
                  int has_text, int n_split, int split_slots, float sm_scale,
                  int head_dim, int dtype, int stats, void* stream) {
  if (!k1_shape_ok(head_dim, kv_row_stride) || (dtype != 0 && dtype != 1))
    return -1;
  K1Params p{};
  const long long s = (long long)num_key_blocks * HA_KEYS;
  if (head_dim == HA_D ? encode_k1_maps<HA_D>(p, dtype, q, k, v, bh, sq, s,
                                              kv_bh_stride, kv_row_stride)
                       : encode_k1_maps<64>(p, dtype, q, k, v, bh, sq, s,
                                            kv_bh_stride, kv_row_stride))
    return -2;
  p.o = o; p.o_part = o_part; p.m_out = m_out; p.l_out = l_out; p.v = v;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.text_len = text_len;
  p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.block_m = block_m;
  p.chunk_blocks = chunk_blocks;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.n_split = n_split; p.split_slots = split_slots;
  p.sm_scale = sm_scale;
  cudaStream_t st = (cudaStream_t)stream;
  const bool sts = stats != 0;
  if (head_dim == HA_D)
    return dtype == 0 ? launch_k1<__nv_bfloat16, HA_D>(p, bh, sts, st)
                      : launch_k1<__half, HA_D>(p, bh, sts, st);
  return dtype == 0 ? launch_k1<__nv_bfloat16, 64>(p, bh, sts, st)
                    : launch_k1<__half, 64>(p, bh, sts, st);
}

// The key split's merge: `rows` = BH * Sq rows of n_split partials into o
// [rows, D] in the K/V type (D = head_dim, 128 or 64); K1s when m_out and
// l_out ([rows] fp32) are given.
int rsa_k1_merge_launch(const float* o_part, const float* m_part,
                        const float* l_part, void* o, float* m_out,
                        float* l_out, long long rows, int n_split,
                        int head_dim, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((m_out == nullptr) != (l_out == nullptr) ||
      (head_dim != HA_D && head_dim != 64) || (dtype != 0 && dtype != 1))
    return -1;
  if (head_dim == HA_D)
    return dtype == 0
               ? launch_merge<__nv_bfloat16, HA_D>(o_part, m_part, l_part, o,
                                                   m_out, l_out, rows,
                                                   n_split, st)
               : launch_merge<__half, HA_D>(o_part, m_part, l_part, o, m_out,
                                            l_out, rows, n_split, st);
  return dtype == 0
             ? launch_merge<__nv_bfloat16, 64>(o_part, m_part, l_part, o,
                                               m_out, l_out, rows, n_split,
                                               st)
             : launch_merge<__half, 64>(o_part, m_part, l_part, o, m_out,
                                        l_out, rows, n_split, st);
}

// K2: one union list per group * block_m query rows (block_m a multiple
// of 128), membership in rowbits; head_dim 128 or 64.  Returns as
// rsa_k1_launch.
int rsa_k2_launch(const void* q, const void* k, const void* v, void* o,
                  const int* indices, const int* counts, const int* clean,
                  const int* rowbits, const int* text_len,
                  long long kv_bh_stride, long long kv_row_stride, int bh,
                  int heads, int sq, int n_list, int nb_slots,
                  int num_key_blocks, int block_m, int group,
                  int chunk_blocks, int visual_len, int text_start,
                  int has_text, float sm_scale, int head_dim, int dtype,
                  void* stream) {
  if (!k1_shape_ok(head_dim, kv_row_stride) || (dtype != 0 && dtype != 1) ||
      block_m % HA_ROWS || sq % HA_ROWS)
    return -1;
  K1Params p{};
  const long long s = (long long)num_key_blocks * HA_KEYS;
  if (head_dim == HA_D ? encode_k1_maps<HA_D>(p, dtype, q, k, v, bh, sq, s,
                                              kv_bh_stride, kv_row_stride)
                       : encode_k1_maps<64>(p, dtype, q, k, v, bh, sq, s,
                                            kv_bh_stride, kv_row_stride))
    return -2;
  p.o = o; p.v = v;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.rowbits = rowbits; p.text_len = text_len;
  p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.block_m = block_m;
  p.chunk_blocks = chunk_blocks; p.group = group;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.n_split = 1; p.split_slots = nb_slots;
  p.sm_scale = sm_scale;
  const dim3 grid(sq / HA_ROWS, bh);
  cudaStream_t st = (cudaStream_t)stream;
  if (head_dim == HA_D)
    return dtype == 0
               ? launch_hopper_attn<__nv_bfloat16,
                                    GroupedTiles<__nv_bfloat16>>(p, grid, st)
               : launch_hopper_attn<__half, GroupedTiles<__half>>(p, grid,
                                                                  st);
  return dtype == 0
             ? launch_hopper_attn<__nv_bfloat16,
                                  GroupedTilesAt<__nv_bfloat16, 64>>(p, grid,
                                                                     st)
             : launch_hopper_attn<__half, GroupedTilesAt<__half, 64>>(p, grid,
                                                                      st);
}

// K1q: K1 on an int8 K|V payload kv [BH, S, 2D] (kv_bh_stride = S * 2D
// bytes); mode 0 = "int8", 1 = "mxu8"; K1q-s when m_out and l_out are
// given ([BH, Sq] fp32 each; both null for K1q).  indices, ksc and vsc hold
// nb_slots slots, a multiple of chunk_blocks.  Returns as rsa_k1_launch.
int rsa_k1q_launch(const void* q, const void* kv, void* o, const int* indices,
                   const int* counts, const int* clean, const float* ksc,
                   const float* vsc, const int* text_len, float* m_out,
                   float* l_out, long long kv_bh_stride, int bh, int heads,
                   int sq, int n_list, int nb_slots, int num_key_blocks,
                   int block_m, int chunk_blocks, int visual_len,
                   int text_start, int has_text, float sm_scale,
                   float row_scale, int head_dim, int mode, void* stream) {
  if (head_dim != HA_D || block_m % HA_ROWS || sq % HA_ROWS ||
      nb_slots % chunk_blocks ||
      kv_bh_stride != (long long)num_key_blocks * HA_KEYS * 2 * HA_D ||
      (m_out == nullptr) != (l_out == nullptr) ||
      (mode != MODE_INT8 && mode != MODE_MXU8))
    return -1;
  QParams p{};
  if (encode_rows_map(&p.tmq, 0, q, sq, bh, 1, HA_D, (long long)sq * HA_D,
                      (long long)bh * sq * HA_D) ||
      encode_rows8_map(&p.tmkv, kv, (long long)bh * num_key_blocks * HA_KEYS,
                       256))
    return -2;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.m_out = m_out; p.l_out = l_out;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.ksc = ksc; p.vsc = vsc; p.text_len = text_len;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.block_m = block_m;
  p.chunk_blocks = chunk_blocks;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.sm_scale = sm_scale; p.row_scale = row_scale;
  const dim3 grid(sq / HA_ROWS, bh);
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_INT8)
    return m_out ? launch_q<MODE_INT8, true>(p, grid, s)
                 : launch_q<MODE_INT8, false>(p, grid, s);
  return m_out ? launch_q<MODE_MXU8, true>(p, grid, s)
               : launch_q<MODE_MXU8, false>(p, grid, s);
}

const char* rsa_error_string(int code) {
  if (code == -2) return "cuTensorMapEncodeTiled failed (the kernels' tensor maps)";
  return code < 0 ? "unsupported dtype, head_dim or mode"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
