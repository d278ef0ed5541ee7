// Block-sparse gather attention for NVIDIA Hopper (sm_90a): kernels K1 and K2.
//
// Replaces the Pallas TPU kernels of rectified_spaattn_tpu/kernels/block_sparse.py:
//   K1  _sparse_attn_kernel          (launched at :746 by block_sparse_flash_attention)
//   K2  _sparse_attn_kernel_grouped  (launched at :560 by block_sparse_flash_attention_grouped)
//
// What both compute.  For each (batch*head, query row) the softmax attention
// over the key blocks listed in the first `count` slots of the row's index list
// (128 keys per block), with an online softmax in fp32 (running max m, sum l,
// accumulator acc), output acc / l (0 where l == 0).  The contract is the JAX
// kernel's:
//   * q is scaled by sm_scale in fp32 and rounded to the K/V type before QK^T;
//     P is rounded to the K/V type before PV;
//   * masked scores are the finite MASK_VALUE = -0.7 * FLT_MAX, and m starts at
//     -inf, so a row whose every gathered key is masked but whose count > 0
//     gets a uniform average of its gathered values, and a count == 0 row gets
//     exact zeros;
//   * slots before the row's `clean` prefix skip every mask; later slots mask
//     keys outside the window col < visual_len or
//     text_start <= col < text_start + text_len[b];
//   * K2 (grouped): G adjacent row blocks share one union index list; bit r
//     of rowbits says whether a slot's block is in row block r's plan.  The
//     JAX kernel adds MASK_VALUE to the scores of a non-member tile; here a
//     thread block skips the tile (all its rows are in one row block), which
//     gives the same output whenever a row has one unmasked key, and makes
//     K2 equal K1 on the same plan row by row in every case.
//
// Design.  One thread block (4 warps, 128 threads) owns 64 query rows of one
// (batch*head) — 64 divides every mask row height (block_m = 128..1024), so a
// block reads exactly one index list (K1) or one union list (K2) and loads it
// itself.  It walks the listed key blocks (K2: those of its row block) in
// units of 64 keys: cp.async stages the unit's K and V rows (gathered by block
// index, 16 bytes per copy) into a two-stage ring in shared memory while the
// previous unit computes.
// Each warp holds its 16 query rows of q*sm_scale as mma.sync A fragments in
// registers, computes S = Q K^T and O += P V with mma.sync.m16n8k16 (bf16 or
// fp16 inputs, fp32 accumulation; operands from ldmatrix, V transposed by
// ldmatrix.trans), and keeps m, l and O in registers.  87 KB of shared memory
// per block lets two blocks share an SM.
//
// What bounds it on the H100.  At the HunyuanVideo operating point (115,456
// keys, 24 heads x 128) the sparse visual rows do 4*128^3 flops per
// (row block, key block) pair against ~64 KB of K/V per pair, most of it
// re-read from L2: ~3e13 flops against ~1.4 GB of unique K/V, so the kernel is
// bound by tensor-core operations (989 TF/s dense bf16), not by HBM bytes
// (3.35 TB/s).  mma.sync reaches a fraction of that peak; wgmma, TMA and warp
// specialisation are the levers of a later change.

#include "attn_common.cuh"

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
  long long kv_bh_stride; // elements
  long long kv_row_stride;
  int heads, sq, n_list, nb_slots, num_key_blocks, block_m, group;
  int visual_len, text_start, has_text;
  float sm_scale;
};

template <typename T, int D, bool GROUPED>
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

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = l_r[i] == 0.f ? 1.f : 1.f / l_r[i];
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

template <typename T, int D, bool GROUPED>
int launch(const Params& p, int bh, cudaStream_t stream) {
  constexpr int smem = (TILE_M + 4 * UNIT) * (D + 8) * (int)sizeof(T);
  auto kern = sparse_attn_kernel<T, D, GROUPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(p.sq / TILE_M, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool GROUPED>
int dispatch(const Params& p, int bh, int head_dim, int dtype, cudaStream_t s) {
  // head_dim 128 only: HunyuanVideo's; other widths come with their models
  if (head_dim != 128) return -1;
  if (dtype == 0) return launch<__nv_bfloat16, 128, GROUPED>(p, bh, s);
  if (dtype == 1) return launch<__half, 128, GROUPED>(p, bh, s);
  return -1;
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const int* indices, const int* counts, const int* clean,
                   const int* rowbits, const int* text_len,
                   long long kv_bh_stride, long long kv_row_stride, int heads,
                   int sq, int n_list, int nb_slots, int num_key_blocks,
                   int block_m, int group, int visual_len, int text_start,
                   int has_text, float sm_scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.rowbits = rowbits; p.text_len = text_len;
  p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.block_m = block_m; p.group = group;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.sm_scale = sm_scale;
  return p;
}

}  // namespace

extern "C" {

// K1: one index list per block_m query rows.  Returns a cudaError_t value
// (0 on success) or -1 for an unsupported (dtype, head_dim).
int rsa_k1_launch(const void* q, const void* k, const void* v, void* o,
                  const int* indices, const int* counts, const int* clean,
                  const int* text_len, long long kv_bh_stride,
                  long long kv_row_stride, int bh, int heads, int sq, int n_list,
                  int nb_slots, int num_key_blocks, int block_m, int visual_len,
                  int text_start, int has_text, float sm_scale, int head_dim,
                  int dtype, void* stream) {
  Params p = make_params(q, k, v, o, indices, counts, clean, nullptr, text_len,
                         kv_bh_stride, kv_row_stride, heads, sq, n_list,
                         nb_slots, num_key_blocks, block_m, 1, visual_len,
                         text_start, has_text, sm_scale);
  return dispatch<false>(p, bh, head_dim, dtype, (cudaStream_t)stream);
}

// K2: one union list per group*block_m query rows, membership in rowbits.
int rsa_k2_launch(const void* q, const void* k, const void* v, void* o,
                  const int* indices, const int* counts, const int* clean,
                  const int* rowbits, const int* text_len,
                  long long kv_bh_stride, long long kv_row_stride, int bh,
                  int heads, int sq, int n_list, int nb_slots,
                  int num_key_blocks, int block_m, int group, int visual_len,
                  int text_start, int has_text, float sm_scale, int head_dim,
                  int dtype, void* stream) {
  Params p = make_params(q, k, v, o, indices, counts, clean, rowbits, text_len,
                         kv_bh_stride, kv_row_stride, heads, sq, n_list,
                         nb_slots, num_key_blocks, block_m, group, visual_len,
                         text_start, has_text, sm_scale);
  return dispatch<true>(p, bh, head_dim, dtype, (cudaStream_t)stream);
}

const char* rsa_error_string(int code) {
  return code < 0 ? "unsupported dtype or head_dim"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
