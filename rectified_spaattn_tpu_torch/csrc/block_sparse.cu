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
//   K1q _sparse_attn_kernel with quant="int8" / "mxu8" (:176-253), below
//       sparse_attn_kernel: its own header comment gives its design
//   K1q-s K1q with return_stats (the JAX wrapper takes both, :606-781):
//       a STATS template flag of sparse_attn_q_kernel, as for K1s
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
//     absorbs any real score in fp32); here a thread block skips the tile
//     (all its rows are in one row block), which changes nothing for a row
//     with one unmasked key of its own;
//   * degenerate rows: the JAX kernel runs its online softmax over chunks of
//     `chunk_blocks` slots and masks every lane of a chunk past `count`
//     (pad slots past the list read block 0).  A row whose every gathered
//     key is masked (m stays MASK_VALUE, or -inf for a K2 row block with no
//     own slot) while count > 0 therefore averages V over every lane of its
//     ceil(count / chunk_blocks) chunks: its own slots, K2's non-member
//     slots and the padding.  Degeneracy depends only on the list and the
//     key window, so all rows of a thread block share it; K2's block makes
//     a second pass over the slots the first one skipped, with every score
//     MASK_VALUE (p = 1); K1's adds the column sums of V over the padding
//     blocks.  Other blocks pay one comparison.
//   * K1s stats, as the JAX kernel returns them: m in score units of
//     q * sm_scale (natural exp, as __expf below), l the fp32 row sum; a
//     count == 0 row gives m = -inf and l = 0, a degenerate row m =
//     MASK_VALUE and l = the lanes it averaged.
//
// K1 and K1s: the Hopper mainloop (hopper_attn.cuh; the section "K1 and
// K1s" below).  One CTA of 384 threads owns 128 query rows, so it walks its
// index list once: a producer warp issues TMA box loads of each listed
// block's K and V (128 keys, 64 KB) into a two-stage mbarrier ring, two
// consumer warpgroups run S = Q K^T and O += P V on wgmma.m64n128k16 under
// an online softmax in fp32 registers, the mask is applied branch-free by
// selects, and a launch of fewer row tiles than SMs splits each list into
// key ranges whose fp32 partials a second kernel merges.
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
// fills them.
//
// K2 and K1q keep the previous design: sparse_attn_kernel (GROUPED, with
// the design described next) and sparse_attn_q_kernel.  K2: one thread
// block (4 warps, 128 threads) owns 64 query rows of one (batch*head) and
// its union list; it walks the member key blocks in units of 64 keys:
// cp.async stages a unit's K and V rows (gathered by block index, 16 bytes
// per copy) into a two-stage ring in shared memory while the previous unit
// computes.  Each warp holds its 16 query rows of q*sm_scale as mma.sync A
// fragments in registers, computes S = Q K^T and O += P V with
// mma.sync.m16n8k16 (bf16 or fp16 inputs, fp32 accumulation; operands from
// ldmatrix, V transposed by ldmatrix.trans), and keeps m, l and O in
// registers.  87 KB of shared memory per block lets two blocks share an SM.

#include "hopper_attn.cuh"

namespace {

constexpr int BLOCK_N = 128;    // keys per index-list block (mask granularity)
constexpr int UNIT = 64;        // keys per pipeline stage
constexpr int TILE_M = 64;      // query rows per thread block (4 warps x 16)
constexpr int NTHREADS = 128;

struct Params {
  const void* q;          // [BH, Sq, D]
  const void* k;          // K row t of head bh at k + bh*kv_bh_stride + t*kv_row_stride
  const void* v;          // V likewise
  void* o;                // [BH, Sq, D]
  const int* indices;     // [BH, n_list, nb_slots]
  const int* counts;      // [BH, n_list]
  const int* clean;       // [BH, n_list]
  const int* rowbits;     // [BH, n_list, nb_slots] (K2 only)
  const int* text_len;    // [B]
  float* m_out;           // [BH, Sq] (K1s only)
  float* l_out;           // [BH, Sq] (K1s only)
  long long kv_bh_stride; // elements
  long long kv_row_stride;
  int heads, sq, n_list, nb_slots, num_key_blocks, block_m, group;
  int chunk_blocks;       // the JAX kernel's slots per online-softmax chunk
  int visual_len, text_start, has_text;
  float sm_scale;
};

template <typename T, int D, bool GROUPED, bool STATS>
__global__ void __launch_bounds__(NTHREADS, 2)
sparse_attn_kernel(const Params p) {
  constexpr int LD = D + 8;          // padded smem row (elements): no ldmatrix bank conflicts
  constexpr int KT = D / 16;         // k-steps of QK^T over the head dim
  constexpr int NT = D / 8;          // n-tiles of the output over the head dim
  constexpr int CPR = D / 8;         // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [TILE_M][LD]
  T* sK = sQ + TILE_M * LD;                     // [2][UNIT][LD]
  T* sV = sK + 2 * UNIT * LD;                   // [2][UNIT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * TILE_M;
  const int b = bh / p.heads;

  int list_row = row0 / p.block_m;
  int member_bit = 0;
  if (GROUPED) {
    member_bit = list_row % p.group;
    list_row /= p.group;
  }
  const long long lr = (long long)bh * p.n_list + list_row;
  const int count = p.counts[lr];
  const int clean = p.clean[lr];
  const int* idx = p.indices + lr * p.nb_slots;
  const int* bits = GROUPED ? p.rowbits + lr * p.nb_slots : nullptr;
  const int tlen = p.text_len[b];

  const T* qg = reinterpret_cast<const T*>(p.q) + ((long long)bh * p.sq + row0) * D;
  T* og = reinterpret_cast<T*>(p.o) + ((long long)bh * p.sq + row0) * D;
  const T* kg = reinterpret_cast<const T*>(p.k) + (long long)bh * p.kv_bh_stride;
  const T* vg = reinterpret_cast<const T*>(p.v) + (long long)bh * p.kv_bh_stride;

  // q * sm_scale in fp32, rounded to T (the JAX kernel's q handling)
  for (int i = tid; i < TILE_M * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const uint4 raw = *reinterpret_cast<const uint4*>(qg + (long long)r * D + c);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
    uint4 out;
    uint32_t* wo = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = Type<T>::unpack(w[j]);
      wo[j] = Type<T>::pack(f.x * p.sm_scale, f.y * p.sm_scale);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = out;
  }

  auto block_of = [&](int slot) {
    const int blk = idx[slot];
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  };
  // K2: this block's 64 rows lie in one row block r of the group; a union
  // slot it is not a member of is skipped (its scores would all be masked)
  auto member = [&](int slot) {
    return !GROUPED || slot < clean || ((bits[slot] >> member_bit) & 1);
  };
  auto next_slot = [&](int slot) {
    while (slot < count && !member(slot)) ++slot;
    return slot;
  };
  // one unit = 64 keys (half h of the slot's block) of K and V into ring
  // stage st
  auto load_unit = [&](int st, int slot, int h) {
    const long long tok0 = (long long)block_of(slot) * BLOCK_N + h * UNIT;
    const T* ks = kg + tok0 * p.kv_row_stride;
    const T* vs = vg + tok0 * p.kv_row_stride;
    T* kd = sK + st * UNIT * LD;
    T* vd = sV + st * UNIT * LD;
    for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      cp_async16(kd + r * LD + c, ks + r * p.kv_row_stride + c);
      cp_async16(vd + r * LD + c, vs + r * p.kv_row_stride + c);
    }
  };

  int slot = next_slot(0), half = 0, st = 0;
  if (slot < count) {
    load_unit(0, slot, 0);
    cp_async_commit();
  }
  __syncthreads();   // sQ written

  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float o_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()};   // rows g and g+8 of this warp
  float l_r[2] = {0.f, 0.f};               // thread-partial row sums
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix id / row within it

  while (slot < count) {
    // prefetch the next unit into the other stage while this one computes
    const int next = half ? next_slot(slot + 1) : slot;
    if (next < count) {
      load_unit(st ^ 1, next, half ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* kb = sK + st * UNIT * LD;
    const T* vb = sV + st * UNIT * LD;

    // S = (q*scale) K^T for this warp's 16 rows x 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kb + (np * 16 + (mi >> 1) * 8 + r8) * LD + kk * 16 + (mi & 1) * 8);
        Type<T>::mma(s[2 * np], qf[kk], kf[0], kf[1]);
        Type<T>::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // past the clean prefix the key window applies; a unit wholly inside
    // the visual window is unaffected by it, so only the others pay for
    // the per-element test (in K2 most member slots lie past the union's
    // clean prefix)
    const int col0 = block_of(slot) * BLOCK_N + half * UNIT;
    if (slot >= clean && col0 + UNIT > p.visual_len) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + n * 8 + 2 * t4 + (e & 1);
          const bool valid = col < p.visual_len ||
              (p.has_text && col >= p.text_start && col < p.text_start + tlen);
          s[n][e] = valid ? s[n][e] : MASK_VALUE;
        }
      }
    }

    // online softmax (row max over the 4 threads that share a row)
    float mc[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mc[0] = fmaxf(mc[0], fmaxf(s[n][0], s[n][1]));
      mc[1] = fmaxf(mc[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 1));
      mc[i] = fmaxf(mc[i], __shfl_xor_sync(0xffffffffu, mc[i], 2));
      const float m_new = fmaxf(m_r[i], mc[i]);
      alpha[i] = __expf(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[n][e] - m_r[e >> 1]);
        s[n][e] = pe;
        ls[e >> 1] += pe;
      }
    }
    l_r[0] = alpha[0] * l_r[0] + ls[0];
    l_r[1] = alpha[1] * l_r[1] + ls[1];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o_acc[n][0] *= alpha[0];
      o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1];
      o_acc[n][3] *= alpha[1];
    }

    // O += P V, P rounded to T (the C fragments of two key n-tiles are the
    // A fragment of one 16-key k-step)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      a[0] = Type<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Type<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Type<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Type<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + (kk * 16 + (mi & 1) * 8 + r8) * LD + dp * 16 + (mi >> 1) * 8);
        Type<T>::mma(o_acc[2 * dp], a, vf[0], vf[1]);
        Type<T>::mma(o_acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
    __syncthreads();   // stage st is refilled by the next iteration's load
    slot = next;
    half ^= 1;
    st ^= 1;
  }

  // degenerate rows (see the header): count > 0 and no unmasked own key, so
  // m is still MASK_VALUE (or -inf where no own slot was walked, with o and
  // l still 0).  Every other lane of the row's chunks then weighs p = 1;
  // the branch is uniform over the block and other blocks skip it.
  if (count > 0 && m_r[0] <= MASK_VALUE) {
    const int npad = (count + p.chunk_blocks - 1) / p.chunk_blocks * p.chunk_blocks;
    m_r[0] = m_r[1] = MASK_VALUE;
    uint32_t ones[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ones[i] = Type<T>::pack(1.f, 1.f);
    for (int pslot = 0; pslot < npad; ++pslot) {
      if (pslot < count && member(pslot)) continue;
      for (int h = 0; h < 2; ++h) {
        // a slot past the list is chunk padding: block 0, as the JAX
        // wrapper pads; stage 0 is free (every reader passed a barrier)
        const long long tok0 = (long long)(pslot < p.nb_slots ? block_of(pslot) : 0) * BLOCK_N + h * UNIT;
        const T* vs = vg + tok0 * p.kv_row_stride;
        for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
          const int r = i / CPR, c = (i % CPR) * 8;
          cp_async16(sV + r * LD + c, vs + r * p.kv_row_stride + c);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
        l_r[0] += 16.f;   // this thread's 16 of the unit's 64 lanes
        l_r[1] += 16.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int dp = 0; dp < D / 16; ++dp) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, sV + (kk * 16 + (mi & 1) * 8 + r8) * LD + dp * 16 + (mi >> 1) * 8);
            Type<T>::mma(o_acc[2 * dp], ones, vf[0], vf[1]);
            Type<T>::mma(o_acc[2 * dp + 1], ones, vf[2], vf[3]);
          }
        }
        __syncthreads();
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] == 0.f ? 1.f : 1.f / l_r[i];
  }
  if constexpr (STATS) {
    // one lane of each row's quad writes its reduced stats
    if (t4 == 0) {
      const long long r0 = (long long)bh * p.sq + row0 + warp * 16 + g;
      p.m_out[r0] = m_r[0];
      p.l_out[r0] = l_r[0];
      p.m_out[r0 + 8] = m_r[1];
      p.l_out[r0 + 8] = l_r[1];
    }
  }
  T* o0 = og + (long long)(warp * 16 + g) * D + 2 * t4;
  T* o1 = o0 + 8 * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + n * 8) =
        Type<T>::pack(o_acc[n][0] * inv[0], o_acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o1 + n * 8) =
        Type<T>::pack(o_acc[n][2] * inv[1], o_acc[n][3] * inv[1]);
  }
}

template <typename T, int D, bool GROUPED, bool STATS>
int launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr int smem = (TILE_M + 4 * UNIT) * (D + 8) * (int)sizeof(T);
  auto kern = sparse_attn_kernel<T, D, GROUPED, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.sq / TILE_M, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool GROUPED, bool STATS>
int dispatch(const Params& p, int bh, int head_dim, int dtype, cudaStream_t s) {
  // head_dim 128 only: HunyuanVideo's; other widths come with their models
  if (head_dim != 128) return -1;
  if (dtype == 0) return launch<__nv_bfloat16, 128, GROUPED, STATS>(p, bh, s);
  if (dtype == 1) return launch<__half, 128, GROUPED, STATS>(p, bh, s);
  return -1;
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const int* indices, const int* counts, const int* clean,
                   const int* rowbits, const int* text_len, float* m_out,
                   float* l_out, long long kv_bh_stride,
                   long long kv_row_stride, int heads,
                   int sq, int n_list, int nb_slots, int num_key_blocks,
                   int block_m, int group, int chunk_blocks, int visual_len,
                   int text_start, int has_text, float sm_scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.rowbits = rowbits; p.text_len = text_len;
  p.m_out = m_out; p.l_out = l_out;
  p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.block_m = block_m; p.group = group;
  p.chunk_blocks = chunk_blocks;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.sm_scale = sm_scale;
  return p;
}

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
  const int* text_len;         // [B]
  long long kv_bh_stride, kv_row_stride;   // elements
  int heads, sq, n_list, nb_slots, num_key_blocks, block_m, chunk_blocks;
  int visual_len, text_start, has_text;
  int n_split, split_slots;
  float sm_scale;
};

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T, bool STATS>
struct SparseTiles {
  using Params = K1Params;
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
  static __device__ int key_row(const Params& p, const Tile& c, int u) {
    return block_of(p, c, u) * HA_KEYS;
  }
  // the unit's key window, once: offsets (from this thread's first
  // column) below `vis` or in [t_lo, t_lo + t_n); the rest score
  // MASK_VALUE.  A unit in the clean prefix or wholly inside the visual
  // window (`all`, the same for every thread) keeps every score.
  struct Window {
    int vis, t_lo;
    unsigned t_n;
    bool all;
  };
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
    if (w.all) return;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int off = 8 * (i >> 2) + (i & 1);
      const bool ok = (off < w.vis) | ((unsigned)(off - w.t_lo) < w.t_n);
      s[i] = ok ? s[i] : MASK_VALUE;
    }
  }
  static __device__ void finish(const Params& p, const Tile& c,
                                float (&o)[64], float (&m)[2], float (&l)[2],
                                const Frag& f, float* sums) {
    // degenerate rows (the header of this file): this warpgroup's rows
    // share the list and the window, so all of them or none are; the
    // range holding the list's last slot adds every lane of the chunk
    // padding, p = 1, from the column sums of V over the padding blocks
    if (c.count > c.u0 && c.count <= c.u0 + p.split_slots &&
        m[0] <= MASK_VALUE) {
      const int g = p.chunk_blocks;
      const int npad = (c.count + g - 1) / g * g;
      const T* vb = reinterpret_cast<const T*>(p.v) +
                    (long long)c.bh * p.kv_bh_stride + f.wtid;
      float acc = 0.f;
      for (int ps = c.count; ps < npad; ++ps) {
        // past the list: the JAX wrapper's padding, block 0
        const int blk = ps < p.nb_slots ? block_of(p, c, ps) : 0;
        const T* vr = vb + (long long)blk * HA_KEYS * p.kv_row_stride;
        for (int r = 0; r < HA_KEYS; ++r)
          acc += to_float(vr[(long long)r * p.kv_row_stride]);
      }
      sums[f.wtid] = acc;
      wg_sync(f.wg);
#pragma unroll
      for (int i = 0; i < 64; ++i)
        o[i] += sums[8 * (i >> 2) + 2 * f.t4 + (i & 1)];
      l[0] += 32.f * (npad - c.count);   // this thread's 32 of 128 lanes
      l[1] += 32.f * (npad - c.count);
      m[0] = m[1] = MASK_VALUE;
    }
    float inv[2];
    quad_sum(l, inv);
    const long long row = (long long)c.bh * p.sq + c.q_row + f.row;
    if (p.n_split == 1) {
      T* o0 = reinterpret_cast<T*>(p.o) + row * HA_D + 2 * f.t4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(o0 + r * 8 * HA_D + 8 * j) =
              Type<T>::pack(o[4 * j + 2 * r] * inv[r],
                            o[4 * j + 2 * r + 1] * inv[r]);
      }
      if constexpr (STATS) {
        if (f.t4 == 0) {
          p.m_out[row] = m[0];
          p.l_out[row] = l[0];
          p.m_out[row + 8] = m[1];
          p.l_out[row + 8] = l[1];
        }
      }
    } else {
      const long long prow = (long long)c.split * gridDim.y * p.sq + row;
      float* o0 = p.o_part + prow * HA_D + 2 * f.t4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(o0 + r * 8 * HA_D + 8 * j) =
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

template <typename T>
int launch_k1(const K1Params& p, int bh, bool stats, cudaStream_t s) {
  const dim3 grid(p.sq / HA_ROWS * p.n_split, bh);
  // a split launch writes partials, whose merge gives K1s its stats: one
  // kernel for K1 and K1s, so that their outputs agree bit for bit
  if (stats && p.n_split == 1)
    return launch_hopper_attn<T, SparseTiles<T, true>>(p, grid, s);
  return launch_hopper_attn<T, SparseTiles<T, false>>(p, grid, s);
}

template <typename T>
int launch_merge(const float* o_part, const float* m_part, const float* l_part,
                 void* o, float* m_out, float* l_out, long long rows,
                 int n_split, cudaStream_t s) {
  const dim3 grid((unsigned)((rows + 7) / 8));
  T* out = static_cast<T*>(o);
  if (m_out)
    merge_splits_kernel<T, true><<<grid, 256, 0, s>>>(
        o_part, m_part, l_part, out, m_out, l_out, rows, n_split);
  else
    merge_splits_kernel<T, false><<<grid, 256, 0, s>>>(
        o_part, m_part, l_part, out, m_out, l_out, rows, n_split);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K1q ---
//
// K1 on an int8 K|V payload (sparse/ops.py::quantize_kv_blocks): kv
// [BH, S, 2D] int8, K in bytes [0, D) of a row and V in [D, 2D); fp32
// per-slot scales ksc/vsc [BH, n_list, nb_slots], gathered to list order and
// padded to a multiple of chunk_blocks (index 0, scale 0) by the wrapper.
// Replaces the Pallas kernel _sparse_attn_kernel with quant="int8" / "mxu8"
// (rectified_spaattn_tpu/kernels/block_sparse.py:176-253).
//
// "int8": q*sm_scale rounded to bf16; a unit's int8 K and V become bf16 in
// shared memory (exact) and run K1's bf16 dots; s = (q K^T) * ksc[slot]; l
// sums p; P = bf16(p * vsc[slot]).  The online softmax walks 64-key units as
// K1 does, and a degenerate row adds its chunk padding in a second pass.
// It halves K1's K/V bytes, which buys nothing where K1 is bound by
// tensor-core operations (the H100 at the operating point).
//
// "mxu8": q per row to int8 against its absmax over D (row scale qmax *
// sm_scale / 127); s = int32(q8 K8^T) * row_scale * ksc[slot].  p is
// quantized per row against the max of p * vsc over one chunk of
// chunk_blocks slots, so each chunk takes two passes over its units: pass A
// runs the int8 QK^T and keeps the row max m and the max of exp(s - m) *
// vsc, rescaled as m moves; pass B recomputes s, p = exp(s - m_next),
// p8 = round(p * vsc * 127 / pm), and adds int32(p8 V8) * pm / 127 to the
// fp32 accumulator.  That is 1.5x K1's tensor-core work at int8's
// twice-bf16 rate (1,979 against 989 dense TOP/s on the H100).
//   The int8 mma wants its B operand "col" (k contiguous).  For QK^T that is
// K's rows as they stand; for P V it is V^T, and ldmatrix.trans moves 16-bit
// elements only, so each unit's V tile is transposed in shared memory with
// byte permutes.  The k order of P's A fragment is permuted so that it is
// the score mma's C fragment as it stands (k position 16h + 4t + 2j + e
// holds key 16h + 8j + 2t + e of a 32-key step), and V^T is stored in the
// same order.

constexpr int MODE_INT8 = 0, MODE_MXU8 = 1;

struct QParams {
  const __nv_bfloat16* q;  // [BH, Sq, D]
  const int8_t* kv;        // [BH, S, 2D]
  __nv_bfloat16* o;        // [BH, Sq, D]
  const int* indices;      // [BH, n_list, nb_slots]
  const int* counts;       // [BH, n_list]
  const int* clean;        // [BH, n_list]
  const float* ksc;        // [BH, n_list, nb_slots]
  const float* vsc;
  const int* text_len;     // [B]
  long long kv_bh_stride;  // bytes
  int heads, sq, n_list, nb_slots, num_key_blocks, block_m, chunk_blocks;
  int visual_len, text_start, has_text;
  float sm_scale, row_scale;   // row_scale = sm_scale / 127 (mxu8)
};

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// 16 int8 values -> 16 bf16 values (exact)
__device__ __forceinline__ void int8_to_bf16_16(__nv_bfloat16* dst,
                                                const int8_t* src) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
  uint4 o0, o1;
  uint32_t* w0 = reinterpret_cast<uint32_t*>(&o0);
  uint32_t* w1 = reinterpret_cast<uint32_t*>(&o1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w0[j] = Type<__nv_bfloat16>::pack((float)v[2 * j], (float)v[2 * j + 1]);
    w1[j] = Type<__nv_bfloat16>::pack((float)v[8 + 2 * j], (float)v[9 + 2 * j]);
  }
  *reinterpret_cast<uint4*>(dst) = o0;
  *reinterpret_cast<uint4*>(dst + 8) = o1;
}

template <int MODE>
constexpr int q_smem_bytes(int d) {
  return 4 * UNIT * (d + 16) +
         (MODE == MODE_INT8 ? (TILE_M + 2 * UNIT) * (d + 8) * 2
                            : TILE_M * (d + 16) + d * (UNIT + 16) + TILE_M * 4);
}

// m_out / l_out ([BH, Sq] fp32) are K1q-s's: parameters of their own, so
// that K1q's QParams is laid out as it was before the stats
template <int MODE, int D, bool STATS>
__global__ void __launch_bounds__(NTHREADS, 2)
sparse_attn_q_kernel(const QParams p, float* m_out, float* l_out) {
  using T = __nv_bfloat16;
  constexpr int LB = D + 16;      // int8 smem row (bytes): no ldmatrix conflicts
  constexpr int LH = D + 8;       // bf16 smem row (elements)
  constexpr int LT = UNIT + 16;   // V^T smem row (bytes), UNIT keys
  constexpr int CPR8 = D / 16;    // 16-byte copies per int8 row
  constexpr int NT = D / 8;
  constexpr int KQ = MODE == MODE_INT8 ? D / 16 : D / 32;   // QK^T k-steps
  static_assert(2 * TILE_M == NTHREADS, "two threads per q row");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int8_t* sK8 = reinterpret_cast<int8_t*>(smem_raw);        // [2][UNIT][LB]
  int8_t* sV8 = sK8 + 2 * UNIT * LB;                         // [2][UNIT][LB]
  unsigned char* rest = smem_raw + 4 * UNIT * LB;
  T* sQ = reinterpret_cast<T*>(rest);                        // int8: [TILE_M][LH]
  T* sKb = sQ + TILE_M * LH;                                 //       [UNIT][LH]
  T* sVb = sKb + UNIT * LH;                                  //       [UNIT][LH]
  int8_t* sQ8 = reinterpret_cast<int8_t*>(rest);             // mxu8: [TILE_M][LB]
  int8_t* sVt = sQ8 + TILE_M * LB;                           //       [D][LT]
  float* sRow = reinterpret_cast<float*>(sVt + D * LT);      //       [TILE_M]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int row0 = blockIdx.x * TILE_M;
  const int b = bh / p.heads;
  const long long lr = (long long)bh * p.n_list + row0 / p.block_m;
  const int count = p.counts[lr];
  const int clean = p.clean[lr];
  const int* idx = p.indices + lr * p.nb_slots;
  const float* ksc = p.ksc + lr * p.nb_slots;
  const float* vsc = p.vsc + lr * p.nb_slots;
  const int tlen = p.text_len[b];
  const int cb = p.chunk_blocks;
  const T* qg = p.q + ((long long)bh * p.sq + row0) * D;
  T* og = p.o + ((long long)bh * p.sq + row0) * D;
  const int8_t* kvg = p.kv + (long long)bh * p.kv_bh_stride;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;  // ldmatrix: matrix id / row within it

  if constexpr (MODE == MODE_INT8) {
    // q * sm_scale in fp32, rounded to bf16
    for (int i = tid; i < TILE_M * (D / 8); i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const uint4 raw = *reinterpret_cast<const uint4*>(qg + (long long)r * D + c);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
      uint4 out;
      uint32_t* wo = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = Type<T>::unpack(w[j]);
        wo[j] = Type<T>::pack(f.x * p.sm_scale, f.y * p.sm_scale);
      }
      *reinterpret_cast<uint4*>(sQ + r * LH + c) = out;
    }
  } else {
    // q to int8 per row: thread pairs (tid, tid ^ 1) hold the two halves
    // of row tid / 2
    const int r = tid >> 1, h0 = (tid & 1) * (D / 2);
    const T* qr = qg + (long long)r * D + h0;
    float amax = 0.f;
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qr + c);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = Type<T>::unpack(w[j]);
        amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
    }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    const float inv = 127.f / fmaxf(amax, 1e-30f);
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(qr + c);
      const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
      int v8[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = Type<T>::unpack(w[j]);
        v8[2 * j] = __float2int_rn(f.x * inv);
        v8[2 * j + 1] = __float2int_rn(f.y * inv);
      }
      *reinterpret_cast<uint2*>(sQ8 + r * LB + h0 + c) =
          make_uint2(pack_s8(v8[0], v8[1], v8[2], v8[3]),
                     pack_s8(v8[4], v8[5], v8[6], v8[7]));
    }
    if ((tid & 1) == 0) sRow[r] = amax * p.row_scale;
  }
  __syncthreads();

  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    if constexpr (MODE == MODE_INT8)
      ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LH + kk * 16 + (lane >> 4) * 8);
    else
      ldmatrix_x4(qf[kk], sQ8 + (warp * 16 + (lane & 15)) * LB + kk * 32 + (lane >> 4) * 16);
  }

  float o_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    o_acc[n][0] = o_acc[n][1] = o_acc[n][2] = o_acc[n][3] = 0.f;
  float m_r[2] = {neg_inf(), neg_inf()};   // rows g and g+8 of this warp
  float l_r[2] = {0.f, 0.f};               // thread-partial row sums

  auto block_of = [&](int slot) {
    const int blk = idx[slot];
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  };
  // one unit = 64 keys (half h of the slot's block): int8 K (and V) rows
  // into ring stage st
  auto load_unit = [&](int st, int slot, int h, bool with_v) {
    const int8_t* src = kvg + ((long long)block_of(slot) * BLOCK_N + h * UNIT) * (2 * D);
    int8_t* kd = sK8 + st * UNIT * LB;
    int8_t* vd = sV8 + st * UNIT * LB;
    for (int i = tid; i < UNIT * CPR8; i += NTHREADS) {
      const int r = i / CPR8, c = (i % CPR8) * 16;
      cp_async16(kd + r * LB + c, src + r * 2 * D + c);
      if (with_v) cp_async16(vd + r * LB + c, src + r * 2 * D + D + c);
    }
  };
  // run body(stage, slot, half) on every unit of slots [s0, s1), the next
  // unit's copy in flight while one computes
  int st = 0;
  auto walk = [&](int s0, int s1, bool with_v, auto&& body) {
    int slot = s0, half = 0;
    if (slot < s1) {
      load_unit(st, slot, 0, with_v);
      cp_async_commit();
    }
    while (slot < s1) {
      const int next = half ? slot + 1 : slot;
      if (next < s1) {
        load_unit(st ^ 1, next, half ^ 1, with_v);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      body(st, slot, half);
      __syncthreads();   // stage st is refilled by the next unit's load
      slot = next;
      half ^= 1;
      st ^= 1;
    }
  };
  // slots past count (chunk padding) mask every key; past the clean prefix
  // the key window applies
  auto mask_unit = [&](float (&s)[8][4], int slot, int half) {
    const int col0 = block_of(slot) * BLOCK_N + half * UNIT;
    const bool pad = slot >= count;
    if (pad || (slot >= clean && col0 + UNIT > p.visual_len)) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + n * 8 + 2 * t4 + (e & 1);
          const bool valid = !pad && (col < p.visual_len ||
              (p.has_text && col >= p.text_start && col < p.text_start + tlen));
          s[n][e] = valid ? s[n][e] : MASK_VALUE;
        }
      }
    }
  };
  auto quad_max = [&](const float (&s)[8][4], float (&mx)[2]) {
    mx[0] = mx[1] = neg_inf();
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
  };
  auto rescale = [&](const float (&alpha)[2]) {
    l_r[0] *= alpha[0];
    l_r[1] *= alpha[1];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o_acc[n][0] *= alpha[0];
      o_acc[n][1] *= alpha[0];
      o_acc[n][2] *= alpha[1];
      o_acc[n][3] *= alpha[1];
    }
  };

  if constexpr (MODE == MODE_INT8) {
    auto body = [&](int stage, int slot, int half) {
      const bool live = slot < count;
      const int8_t* k8 = sK8 + stage * UNIT * LB;
      const int8_t* v8 = sV8 + stage * UNIT * LB;
      for (int i = tid; i < UNIT * CPR8; i += NTHREADS) {
        const int r = i / CPR8, c = (i % CPR8) * 16;
        if (live) int8_to_bf16_16(sKb + r * LH + c, k8 + r * LB + c);
        int8_to_bf16_16(sVb + r * LH + c, v8 + r * LB + c);
      }
      __syncthreads();
      float s[8][4];
      const float ks = live ? ksc[slot] : 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if (live) {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t kf[4];
            ldmatrix_x4(kf, sKb + (np * 16 + (mi >> 1) * 8 + r8) * LH + kk * 16 + (mi & 1) * 8);
            Type<T>::mma(s[2 * np], qf[kk], kf[0], kf[1]);
            Type<T>::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] *= ks;
      }
      mask_unit(s, slot, half);
      float mc[2], alpha[2];
      quad_max(s, mc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m_r[i], mc[i]);
        alpha[i] = __expf(m_r[i] - m_new);
        m_r[i] = m_new;
      }
      rescale(alpha);
      const float vs = vsc[slot];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = __expf(s[n][e] - m_r[e >> 1]);
          l_r[e >> 1] += pe;
          s[n][e] = pe * vs;
        }
      }
      // O += bf16(p * vsc) V (as K1: two key n-tiles' C fragments are the
      // A fragment of one 16-key k-step)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t a[4];
        a[0] = Type<T>::pack(s[2 * kk][0], s[2 * kk][1]);
        a[1] = Type<T>::pack(s[2 * kk][2], s[2 * kk][3]);
        a[2] = Type<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = Type<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, sVb + (kk * 16 + (mi & 1) * 8 + r8) * LH + dp * 16 + (mi >> 1) * 8);
          Type<T>::mma(o_acc[2 * dp], a, vf[0], vf[1]);
          Type<T>::mma(o_acc[2 * dp + 1], a, vf[2], vf[3]);
        }
      }
    };
    walk(0, count, true, body);
    // degenerate rows (every own key masked, uniform over the block): the
    // chunk padding lanes, p = 1
    if (count > 0 && m_r[0] <= MASK_VALUE)
      walk(count, (count + cb - 1) / cb * cb, true, body);
  } else {
    const float rs[2] = {sRow[warp * 16 + g], sRow[warp * 16 + g + 8]};
    // S = int32(q8 K8^T) * row_scale * ksc for this warp's 16 rows x 64 keys
    auto scores = [&](float (&s)[8][4], int stage, int slot) {
      int sc[8][4] = {};
      const int8_t* kb = sK8 + stage * UNIT * LB;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kb + (np * 16 + (mi >> 1) * 8 + r8) * LB + kk * 32 + (mi & 1) * 16);
          mma_s8(sc[2 * np], qf[kk], kf[0], kf[1]);
          mma_s8(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }
      const float ks = ksc[slot];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = (float)sc[n][e] * rs[e >> 1] * ks;
    };
    // V8 [UNIT][D] of a stage -> sVt [D][UNIT] in the permuted key order:
    // 4 keys x 4 dims per item, 4x4 byte transposes with byte_perm
    auto transpose_v = [&](int stage) {
      const int8_t* v8 = sV8 + stage * UNIT * LB;
      for (int i = tid; i < 2 * 2 * 4 * (D / 4); i += NTHREADS) {
        const int t = i & 3, h = (i >> 2) & 1, kk = (i >> 3) & 1, dq = i >> 4;
        const int key = 32 * kk + 16 * h + 2 * t;
        const int8_t* src = v8 + key * LB + 4 * dq;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + LB);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 8 * LB);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 9 * LB);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t hi23 = __byte_perm(w2, w3, 0x7362);
        int8_t* dst = sVt + 4 * dq * LT + 32 * kk + 16 * h + 4 * t;
        *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + LT) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + 2 * LT) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 3 * LT) = __byte_perm(hi01, hi23, 0x7632);
      }
    };

    const int nch = (count + cb - 1) / cb;
    for (int c = 0; c < nch; ++c) {
      const int s0 = c * cb, s1 = min(s0 + cb, count);
      // pass A: the chunk's row max and max of exp(s - m) * vsc (the max of
      // a unit's lanes is at its max score: vsc is constant over a slot)
      float ma[2] = {neg_inf(), neg_inf()}, pa[2] = {0.f, 0.f};
      walk(s0, s1, false, [&](int stage, int slot, int half) {
        float s[8][4], mu[2];
        scores(s, stage, slot);
        mask_unit(s, slot, half);
        quad_max(s, mu);
        const float vs = vsc[slot];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(ma[i], mu[i]);
          pa[i] = fmaxf(pa[i] * __expf(ma[i] - m_new), __expf(mu[i] - m_new) * vs);
          ma[i] = m_new;
        }
      });
      float alpha[2], pm[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_next = fmaxf(m_r[i], ma[i]);
        pm[i] = pa[i] * __expf(ma[i] - m_next);
        alpha[i] = __expf(m_r[i] - m_next);
        m_r[i] = m_next;
      }
      rescale(alpha);
      // a degenerate row (every key so far masked) also weighs the last
      // chunk's padding lanes, p = 1
      int s2 = s1;
      if (m_r[0] <= MASK_VALUE && c == nch - 1) {
        s2 = s0 + cb;
        for (int slot = s1; slot < s2; ++slot) {
          pm[0] = fmaxf(pm[0], vsc[slot]);
          pm[1] = fmaxf(pm[1], vsc[slot]);
        }
      }
      const float inv_pm[2] = {127.f / fmaxf(pm[0], 1e-30f),
                               127.f / fmaxf(pm[1], 1e-30f)};
      const float ps[2] = {pm[0] / 127.f, pm[1] / 127.f};
      // pass B: p8 V8 in int8, scaled into the fp32 accumulator
      walk(s0, s2, true, [&](int stage, int slot, int half) {
        transpose_v(stage);
        __syncthreads();
        float s[8][4];
        if (slot < count) {
          scores(s, stage, slot);
        } else {
#pragma unroll
          for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = MASK_VALUE;
        }
        mask_unit(s, slot, half);
        const float vs = vsc[slot];
        int p8[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = __expf(s[n][e] - m_r[e >> 1]);
            l_r[e >> 1] += pe;
            p8[n][e] = min(__float2int_rn(pe * vs * inv_pm[e >> 1]), 127);
          }
        }
        uint32_t a[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          a[kk][0] = pack_s8(p8[4 * kk][0], p8[4 * kk][1], p8[4 * kk + 1][0], p8[4 * kk + 1][1]);
          a[kk][1] = pack_s8(p8[4 * kk][2], p8[4 * kk][3], p8[4 * kk + 1][2], p8[4 * kk + 1][3]);
          a[kk][2] = pack_s8(p8[4 * kk + 2][0], p8[4 * kk + 2][1], p8[4 * kk + 3][0], p8[4 * kk + 3][1]);
          a[kk][3] = pack_s8(p8[4 * kk + 2][2], p8[4 * kk + 2][3], p8[4 * kk + 3][2], p8[4 * kk + 3][3]);
        }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          int c0[4] = {}, c1[4] = {};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t vf[4];
            ldmatrix_x4(vf, sVt + (dp * 16 + (mi >> 1) * 8 + r8) * LT + kk * 32 + (mi & 1) * 16);
            mma_s8(c0, a[kk], vf[0], vf[1]);
            mma_s8(c1, a[kk], vf[2], vf[3]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o_acc[2 * dp][e] += (float)c0[e] * ps[e >> 1];
            o_acc[2 * dp + 1][e] += (float)c1[e] * ps[e >> 1];
          }
        }
      });
    }
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] == 0.f ? 1.f : 1.f / l_r[i];
  }
  if constexpr (STATS) {
    // K1q-s: m in score units after every scale is folded (the score the
    // exp saw), l the sum of the unquantized p (the JAX kernel's :206)
    if (t4 == 0) {
      const long long r0 = (long long)bh * p.sq + row0 + warp * 16 + g;
      m_out[r0] = m_r[0];
      l_out[r0] = l_r[0];
      m_out[r0 + 8] = m_r[1];
      l_out[r0 + 8] = l_r[1];
    }
  }
  T* o0 = og + (long long)(warp * 16 + g) * D + 2 * t4;
  T* o1 = o0 + 8 * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(o0 + n * 8) =
        Type<T>::pack(o_acc[n][0] * inv[0], o_acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(o1 + n * 8) =
        Type<T>::pack(o_acc[n][2] * inv[1], o_acc[n][3] * inv[1]);
  }
}

template <int MODE, bool STATS>
int launch_q(const QParams& p, float* m_out, float* l_out, int bh,
             cudaStream_t stream) {
  constexpr int smem = q_smem_bytes<MODE>(128);
  auto kern = sparse_attn_q_kernel<MODE, 128, STATS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.sq / TILE_M, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p, m_out, l_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: one index list per block_m query rows (block_m a multiple of 128);
// K1s when `stats`.  n_split == 1: o [BH, Sq, D] in the K/V type, and K1s's
// m_out / l_out [BH, Sq].  n_split > 1: the ranges' partials into o_part
// [n_split, BH, Sq, D] and m_out / l_out [n_split, BH, Sq], all fp32, for
// rsa_k1_merge_launch.  Returns a cudaError_t value (0 on success), -1 for
// an unsupported (dtype, head_dim), -2 if a tensor map cannot be encoded.
int rsa_k1_launch(const void* q, const void* k, const void* v, void* o,
                  float* o_part, float* m_out, float* l_out,
                  const int* indices, const int* counts, const int* clean,
                  const int* text_len, long long kv_bh_stride,
                  long long kv_row_stride, int bh, int heads, int sq,
                  int n_list, int nb_slots, int num_key_blocks, int block_m,
                  int chunk_blocks, int visual_len, int text_start,
                  int has_text, int n_split, int split_slots, float sm_scale,
                  int head_dim, int dtype, int stats, void* stream) {
  if (head_dim != HA_D || (dtype != 0 && dtype != 1)) return -1;
  K1Params p{};
  const long long s = (long long)num_key_blocks * HA_KEYS;
  if (encode_rows_map(&p.tmq, dtype, q, sq, bh, 1, HA_D, (long long)sq * HA_D,
                      (long long)bh * sq * HA_D) ||
      encode_rows_map(&p.tmk, dtype, k, s, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride) ||
      encode_rows_map(&p.tmv, dtype, v, s, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride))
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
  if (dtype == 0) return launch_k1<__nv_bfloat16>(p, bh, stats != 0, st);
  return launch_k1<__half>(p, bh, stats != 0, st);
}

// The key split's merge: `rows` = BH * Sq rows of n_split partials into o
// [rows, D] in the K/V type; K1s when m_out and l_out ([rows] fp32) are
// given.
int rsa_k1_merge_launch(const float* o_part, const float* m_part,
                        const float* l_part, void* o, float* m_out,
                        float* l_out, long long rows, int n_split, int dtype,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if ((m_out == nullptr) != (l_out == nullptr)) return -1;
  if (dtype == 0)
    return launch_merge<__nv_bfloat16>(o_part, m_part, l_part, o, m_out,
                                       l_out, rows, n_split, st);
  if (dtype == 1)
    return launch_merge<__half>(o_part, m_part, l_part, o, m_out, l_out,
                                rows, n_split, st);
  return -1;
}

// K2: one union list per group*block_m query rows, membership in rowbits.
int rsa_k2_launch(const void* q, const void* k, const void* v, void* o,
                  const int* indices, const int* counts, const int* clean,
                  const int* rowbits, const int* text_len,
                  long long kv_bh_stride, long long kv_row_stride, int bh,
                  int heads, int sq, int n_list, int nb_slots,
                  int num_key_blocks, int block_m, int group,
                  int chunk_blocks, int visual_len, int text_start,
                  int has_text, float sm_scale, int head_dim, int dtype,
                  void* stream) {
  Params p = make_params(q, k, v, o, indices, counts, clean, rowbits, text_len,
                         nullptr, nullptr, kv_bh_stride, kv_row_stride, heads,
                         sq, n_list, nb_slots, num_key_blocks, block_m, group,
                         chunk_blocks, visual_len, text_start, has_text,
                         sm_scale);
  return dispatch<true, false>(p, bh, head_dim, dtype, (cudaStream_t)stream);
}

// K1q: K1 on an int8 K|V payload; mode 0 = "int8", 1 = "mxu8"; K1q-s
// when m_out and l_out are given ([BH, Sq] fp32 each; both null for K1q).
int rsa_k1q_launch(const void* q, const void* kv, void* o, const int* indices,
                   const int* counts, const int* clean, const float* ksc,
                   const float* vsc, const int* text_len, float* m_out,
                   float* l_out, long long kv_bh_stride, int bh, int heads,
                   int sq,
                   int n_list, int nb_slots, int num_key_blocks, int block_m,
                   int chunk_blocks, int visual_len, int text_start,
                   int has_text, float sm_scale, float row_scale,
                   int head_dim, int mode, void* stream) {
  if (head_dim != 128) return -1;
  QParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kv = static_cast<const int8_t*>(kv);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.ksc = ksc; p.vsc = vsc; p.text_len = text_len;
  p.kv_bh_stride = kv_bh_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.block_m = block_m;
  p.chunk_blocks = chunk_blocks;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.sm_scale = sm_scale; p.row_scale = row_scale;
  if ((m_out == nullptr) != (l_out == nullptr)) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == MODE_INT8)
    return m_out ? launch_q<MODE_INT8, true>(p, m_out, l_out, bh, s)
                 : launch_q<MODE_INT8, false>(p, m_out, l_out, bh, s);
  if (mode == MODE_MXU8)
    return m_out ? launch_q<MODE_MXU8, true>(p, m_out, l_out, bh, s)
                 : launch_q<MODE_MXU8, false>(p, m_out, l_out, bh, s);
  return -1;
}

const char* rsa_error_string(int code) {
  if (code == -2) return "cuTensorMapEncodeTiled failed (K1's tensor maps)";
  return code < 0 ? "unsupported dtype, head_dim or mode"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
