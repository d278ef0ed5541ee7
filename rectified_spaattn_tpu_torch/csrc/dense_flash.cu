// Dense flash attention for NVIDIA Hopper (sm_90a): kernel K3.
//
// Replaces the TPU kernel that rectified_spaattn_tpu/kernels/flash.py:49-102
// (dense_attention, mode "flash") reaches: JAX's stock Pallas TPU flash
// attention, with key validity as segment ids and q/k padded to 128.
//
// What it computes.  For each (batch*head, query row) the exact softmax
// attention over every key, as kernels/flash.py::_vanilla_attention does:
// scores (q . k) * sm_scale in fp32; keys with kv_valid[b, key] false score
// the finite MASK_VALUE = -0.7 * FLT_MAX, so a row with no valid key averages
// V uniformly over all Sk keys.  Sq and Sk are arbitrary: rows past Sq are
// neither read nor written, keys past Sk are zero-filled in shared memory and
// score -inf (they are not keys), so the caller's tensors are never padded.
// P is rounded to the K/V type before PV; m, l and O stay in fp32.
//
// Design.  One thread block (4 warps, 16 query rows each) owns 64 query rows
// of one (batch, head), as in K1; 87 KB of shared memory per block lets two
// blocks share an SM.  Each warp holds its rows of q as mma.sync A fragments
// in registers for the whole key loop (q is read once).  The block walks the
// keys in units of 64: cp.async stages a unit's K and V rows into a two-stage
// ring in shared memory while the previous unit computes S = Q K^T and
// O += P V with mma.sync.m16n8k16 (fp32 accumulation; operands by ldmatrix, V
// transposed by ldmatrix.trans) under an online softmax.  blockIdx.x walks
// the row tiles of one head, so the blocks resident at one time share that
// head's K/V in L2.  q, k, v and out are addressed through (batch, head, row)
// strides, so a [B, S, H, D] projection is read, and the output written, in
// place without a transposing copy.
//
// What bounds it on the H100.  Wan2.1-14B text cross-attention: q
// [1,40,75648,128] against 512 keys is 7.93e11 flops (0.80 ms at 989 TF/s
// dense bf16) against 1.55 GB of q and out (0.46 ms at 3.35 TB/s): bound by
// tensor-core operations.  With the 257-key CLIP image context the bytes bound
// it (0.46 ms).  Every block re-reads its head's K/V (256 KB at 512 keys) from
// L2.  mma.sync reaches a fraction of the peak; wgmma and TMA are the levers
// of a later change.

#include "attn_common.cuh"

namespace {

constexpr int UNIT = 64;        // keys per pipeline stage
constexpr int TILE_M = 64;      // query rows per thread block (4 warps x 16)
constexpr int NTHREADS = 128;

struct DenseParams {
  const void* q;                 // element (b, h, row, d) at
  const void* k;                 //   b*s_b + h*s_h + row*s_r + d
  const void* v;
  void* o;
  const unsigned char* kv_valid; // [B, sk] bool, or null (every key valid)
  long long q_b, q_h, q_r;       // strides in elements
  long long k_b, k_h, k_r;
  long long v_b, v_h, v_r;
  long long o_b, o_h, o_r;
  int heads, sq, sk;
  float sm_scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
dense_attn_kernel(const DenseParams p) {
  constexpr int LD = D + 8;          // padded smem row: no ldmatrix bank conflicts
  constexpr int KT = D / 16;         // k-steps of QK^T over the head dim
  constexpr int NT = D / 8;          // n-tiles of the output over the head dim
  constexpr int CPR = D / 8;         // 16-byte copies per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [TILE_M][LD]
  T* sK = sQ + TILE_M * LD;                     // [2][UNIT][LD]
  T* sV = sK + 2 * UNIT * LD;                   // [2][UNIT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / p.heads, h = blockIdx.y % p.heads;
  const int row0 = blockIdx.x * TILE_M;
  const T* qg = reinterpret_cast<const T*>(p.q) + b * p.q_b + h * p.q_h;
  const T* kg = reinterpret_cast<const T*>(p.k) + b * p.k_b + h * p.k_h;
  const T* vg = reinterpret_cast<const T*>(p.v) + b * p.v_b + h * p.v_h;
  T* og = reinterpret_cast<T*>(p.o) + b * p.o_b + h * p.o_h;
  const unsigned char* valid =
      p.kv_valid ? p.kv_valid + (long long)b * p.sk : nullptr;

  // q rows of this tile (zeros past sq: their outputs are not stored)
  for (int i = tid; i < TILE_M * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < p.sq)
      raw = *reinterpret_cast<const uint4*>(qg + (long long)(row0 + r) * p.q_r + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = raw;
  }

  // one unit = keys [u*64, u*64+64) of K and V into ring stage st; rows past
  // sk are zero-filled
  auto load_unit = [&](int st, int u) {
    T* kd = sK + st * UNIT * LD;
    T* vd = sV + st * UNIT * LD;
    for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
      const int r = i / CPR, c = (i % CPR) * 8;
      const int t = u * UNIT + r;
      const bool in = t < p.sk;
      const long long tt = in ? t : 0;
      cp_async16_zfill(kd + r * LD + c, kg + tt * p.k_r + c, in);
      cp_async16_zfill(vd + r * LD + c, vg + tt * p.v_r + c, in);
    }
  };

  const int n_units = (p.sk + UNIT - 1) / UNIT;
  load_unit(0, 0);
  cp_async_commit();
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

  for (int u = 0; u < n_units; ++u) {
    const int st = u & 1;
    // prefetch the next unit into the other stage while this one computes
    if (u + 1 < n_units) {
      load_unit(st ^ 1, u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const T* kb = sK + st * UNIT * LD;
    const T* vb = sV + st * UNIT * LD;

    // S = Q K^T for this warp's 16 rows x 64 keys
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

    // scale in fp32; invalid keys MASK_VALUE; keys past sk are no keys
    const int col0 = u * UNIT;
    if (valid != nullptr || col0 + UNIT > p.sk) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + n * 8 + 2 * t4 + (e & 1);
          float x = s[n][e] * p.sm_scale;
          if (valid != nullptr && col < p.sk && !valid[col]) x = MASK_VALUE;
          s[n][e] = col < p.sk ? x : neg_inf();
        }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= p.sm_scale;
      }
    }

    // online softmax (row max over the 4 threads that share a row); every
    // unit holds at least one key, so the new max is finite
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
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    inv[i] = 1.f / l_r[i];   // l >= 1: the row max itself contributes exp(0)
  }
  const int r0 = row0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= p.sq) continue;
    T* orow = og + (long long)row * p.o_r + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) = Type<T>::pack(
          o_acc[n][2 * half] * inv[half], o_acc[n][2 * half + 1] * inv[half]);
  }
}

template <typename T, int D>
int launch(const DenseParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = (TILE_M + 4 * UNIT) * (D + 8) * (int)sizeof(T);
  auto kern = dense_attn_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.sq + TILE_M - 1) / TILE_M, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3.  Pointers to q/k/v/out (element (b, h, row, d) at b*s_b + h*s_h +
// row*s_r + d, d contiguous), kv_valid [B, sk] bool or null.  Returns a
// cudaError_t value (0 on success) or -1 for an unsupported (dtype, head_dim).
int rsa_k3_launch(const void* q, const void* k, const void* v, void* o,
                  const void* kv_valid, long long q_b, long long q_h,
                  long long q_r, long long k_b, long long k_h, long long k_r,
                  long long v_b, long long v_h, long long v_r, long long o_b,
                  long long o_h, long long o_r, int bh, int heads, int sq,
                  int sk, float sm_scale, int head_dim, int dtype,
                  void* stream) {
  DenseParams p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.kv_valid = static_cast<const unsigned char*>(kv_valid);
  p.q_b = q_b; p.q_h = q_h; p.q_r = q_r;
  p.k_b = k_b; p.k_h = k_h; p.k_r = k_r;
  p.v_b = v_b; p.v_h = v_h; p.v_r = v_r;
  p.o_b = o_b; p.o_h = o_h; p.o_r = o_r;
  p.heads = heads; p.sq = sq; p.sk = sk; p.sm_scale = sm_scale;
  // head_dim 128 only: the width of every model this port runs
  if (head_dim != 128) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<__nv_bfloat16, 128>(p, bh, s);
  if (dtype == 1) return launch<__half, 128>(p, bh, s);
  return -1;
}

const char* rsa_error_string(int code) {
  return code < 0 ? "unsupported dtype or head_dim"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
