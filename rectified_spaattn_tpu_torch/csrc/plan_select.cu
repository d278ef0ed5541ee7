// Top-p / top-k threshold selection of the sparse plan, for NVIDIA Hopper
// (sm_90a): kernel P1, one launch a plan.
//
// Replaces no TPU kernel: the JAX package selects with XLA operations
// (rectified_spaattn_tpu/sparse/ops.py, topp_threshold_onehot_bisect), and
// the port ran them as a chain of plain PyTorch operations, ~13 launches
// a round over the whole [B, H, NQ, NP] fp32 probs tensor for 32 rounds.
// Each row's rounds need nothing from any other row, so one kernel does
// them all with the row in registers.
//
// What it computes, per row p of NP floats with 0 <= p <= 1 (the plan's
// softmax probabilities; kernels/plan_select.py's _simulate models it in
// plain PyTorch):
//   lo = bits(max(min(p), 0)), hi = bits(max(p)) + 1 on the fp32 bit
//   pattern (lo + hi <= 2 bits(1.0) + 1 < 2^31: no int32 wraps); 32 rounds
//   of mid = (lo + hi) >> 1, t = float(mid), mass = sum p[p >= t],
//   cnt = #(p >= t), ok = mass > p_remain && cnt >= min_count,
//   (lo, hi) = ok ? (mid, hi) : (lo, mid); out = p >= float(lo).
// cnt is exact.  mass is an fp32 sum in a fixed order: each thread adds
// its own values in sequence (j = l, l + LANES, ...), then a xor-shuffle
// butterfly adds a warp's 32 sums (every lane ends with the same bits,
// fp32 addition being commutative) and, with several warps a row, each
// thread adds the warps' sums from shared memory in one fixed halving
// tree.  So a run repeats itself bit for bit, and ok is uniform across the
// threads of a row: no divergence.  The search reaches the 32 rounds' lo
// in fewer rounds by snapping its bounds to the row's values (the kernel's
// loop gives why that is exact): ~10 rounds at 901 columns.
//
// Layouts (the wrapper picks one from NP alone: plan_select.py::layout):
//   warp: one warp a row, 8 rows a CTA, VPL >= ceil(NP / 32) values a
//     lane in registers (VPL up to 64: NP <= 2,048; CogVideoX's 352
//     columns at VPL 12, Flux's 513 and Wan's ~591 at 20, HunyuanVideo's
//     901 at 32, the long-context point's ~1,803 at 64);
//   cta: one CTA of 16 warps a row, VPL >= ceil(NP / 512) a thread (NP
//     2,049 to 32,768), the warps' sums through shared memory,
//     double-buffered by round parity so one barrier a round suffices.
// A VPL above ceil(NP / lanes) only holds more -inf slots: the sums and
// the mask do not depend on it.
// Loads are 4-byte and coalesced across the row (rows of 901 floats do not
// start on 16-byte boundaries); slots past NP hold -inf, which no
// threshold selects.
//
// What bounds it on the H100.  HunyuanVideo's plan: probs [1, 24, 900,
// 901] fp32 read once (77.9 MB) and the bool mask written once (19.5 MB):
// 0.029 ms at 3.35 TB/s.  A round costs ~5 instructions a value held
// (compare, two adds, a min or a max) and 4 reductions a row; 32 rounds
// as written took 0.17-0.19 ms there on the H100, the snapped search
// ~0.08 ms (chip_smoke.py's plan_select leg), instruction-bound at ~2.8x the
// byte bound.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int ROUNDS = 32;
constexpr int WARP_ROWS = 8;    // warp layout: rows (warps) a CTA
constexpr int CTA_WARPS = 16;   // cta layout: warps a row (and a CTA)

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fminf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

// RW warps a row: 1 (the warp layout) or CTA_WARPS (the cta layout)
template <int VPL, int RW>
__global__ void __launch_bounds__(RW == 1 ? 32 * WARP_ROWS : 32 * RW)
    topp_select_kernel(const float* __restrict__ probs, bool* __restrict__ out,
                       long long rows, int np, float p_remain,
                       int min_count) {
  constexpr int LANES = 32 * RW;
  // the warps' partial results, double-buffered by round parity
  __shared__ float s_mass[2][RW];
  __shared__ int s_cnt[2][RW], s_bmin[2][RW], s_bmax[2][RW];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row =
      RW == 1 ? (long long)blockIdx.x * WARP_ROWS + warp : blockIdx.x;
  const int l = RW == 1 ? lane : (int)threadIdx.x;
  if (row >= rows) return;   // a whole warp (a whole CTA in the cta layout)
  const float* __restrict__ p = probs + row * np + l;

  float v[VPL];
  float mn = INFINITY, mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    v[i] = l + i * LANES < np ? p[i * LANES] : -INFINITY;
    if (l + i * LANES < np) {
      mn = fminf(mn, v[i]);
      mx = fmaxf(mx, v[i]);
    }
  }
  mn = warp_min(mn);
  mx = warp_max(mx);
  if (RW > 1) {
    if (lane == 0) {
      s_mass[0][warp] = mn;
      s_mass[1][warp] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < RW; ++w) {
      mn = fminf(mn, s_mass[0][w]);
      mx = fmaxf(mx, s_mass[1][w]);
    }
    __syncthreads();   // the rounds reuse s_mass
  }

  int lo = __float_as_int(fmaxf(mn, 0.f));
  int hi = __float_as_int(mx) + 1;
  // Every threshold float(mid) is a finite value >= 0 and the kept values
  // are >= 0, so mass and cnt only grow as the threshold falls (each
  // partial sum of the fixed order is monotone in the set): ok(b) is
  // monotone in b, and the 32 rounds end on the largest b in [lo, hi)
  // with ok(b), or on lo if none passes.  A round may then snap its bound
  // to the row's values: after a pass lo moves up to the least kept value
  // (it keeps the same set, so it passes), after a failure hi moves down
  // past the largest value not kept (every threshold above it keeps the
  // failed set).  The search ends when hi == lo + 1: ~10 rounds at 901
  // columns, the same lo as all 32.
  for (int r = 0; r < ROUNDS && hi - lo > 1; ++r) {
    const int mid = (lo + hi) >> 1;
    const float t = __int_as_float(mid);
    float mass = 0.f, cntf = 0.f;
    int bmin = INT_MAX, bmax = INT_MIN;   // bits of the least kept value,
#pragma unroll                          // of the largest value not kept
    for (int i = 0; i < VPL; ++i) {
      const int b = __float_as_int(v[i]);
      if (v[i] >= t) {
        mass += v[i];
        cntf += 1.f;
        bmin = min(bmin, b);
      } else {
        bmax = max(bmax, b);
      }
    }
    mass = warp_sum(mass);
    int cnt = __reduce_add_sync(FULL, (int)cntf);
    bmin = __reduce_min_sync(FULL, bmin);
    bmax = __reduce_max_sync(FULL, bmax);
    if (RW > 1) {
      const int k = r & 1;
      if (lane == 0) {
        s_mass[k][warp] = mass;
        s_cnt[k][warp] = cnt;
        s_bmin[k][warp] = bmin;
        s_bmax[k][warp] = bmax;
      }
      __syncthreads();
      float w[RW];
      cnt = 0;
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        w[i] = s_mass[k][i];
        cnt += s_cnt[k][i];
        bmin = min(bmin, s_bmin[k][i]);
        bmax = max(bmax, s_bmax[k][i]);
      }
#pragma unroll
      for (int off = RW / 2; off; off >>= 1)
#pragma unroll
        for (int i = 0; i < off; ++i) w[i] += w[i + off];
      mass = w[0];
    }
    const bool ok = mass > p_remain && cnt >= min_count;
    if (ok) {
      lo = bmin;       // a pass keeps at least min_count >= 1 values
    } else {
      // no value left out (bmax INT_MIN) or only pads (-inf, negative as
      // int32): nothing in (lo, mid) changes the set
      hi = max(bmax, lo) + 1;
    }
  }

  const float cut = __int_as_float(lo);
  bool* o = out + row * np + l;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
    if (l + i * LANES < np) o[i * LANES] = v[i] >= cut;
}

template <int VPL, int RW>
int launch(const float* probs, bool* out, long long rows, int np,
           float p_remain, int min_count, cudaStream_t s) {
  const long long ctas = RW == 1 ? (rows + WARP_ROWS - 1) / WARP_ROWS : rows;
  const int threads = RW == 1 ? 32 * WARP_ROWS : 32 * RW;
  topp_select_kernel<VPL, RW><<<(unsigned)ctas, threads, 0, s>>>(
      probs, out, rows, np, p_remain, min_count);
  return (int)cudaGetLastError();
}

}  // namespace

// the values a thread holds, by layout (plan_select.py's WARP_VPL and
// CTA_VPL name the same lists)
#define RSA_WARP_VPLS(X) X(1) X(2) X(4) X(8) X(12) X(16) X(20) X(32) X(64)
#define RSA_CTA_VPLS(X) X(8) X(16) X(32) X(64)

extern "C" {

// P1.  probs: [rows, np] fp32, contiguous; out: [rows, np] bool.
// row_warps 1 (the warp layout) or 16 (the cta layout), vpl one of that
// layout's list above, with 32 * row_warps * vpl >= np.  Returns a
// cudaError_t value (0 on success) or -1 for a layout not built.
int rsa_topp_select_launch(const void* probs, void* out, long long rows,
                           int np, float p_remain, int min_count, int vpl,
                           int row_warps, void* stream) {
  const float* p = static_cast<const float*>(probs);
  bool* o = static_cast<bool*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || np <= 0 || vpl * 32 * row_warps < np) return -1;
#define RSA_WARP_CASE(n) \
  case n: return launch<n, 1>(p, o, rows, np, p_remain, min_count, s);
#define RSA_CTA_CASE(n) \
  case n: return launch<n, CTA_WARPS>(p, o, rows, np, p_remain, min_count, s);
  if (row_warps == 1) {
    switch (vpl) { RSA_WARP_VPLS(RSA_WARP_CASE) }
  } else if (row_warps == CTA_WARPS) {
    switch (vpl) { RSA_CTA_VPLS(RSA_CTA_CASE) }
  }
#undef RSA_WARP_CASE
#undef RSA_CTA_CASE
  return -1;
}

const char* rsa_error_string(int code) {
  return code < 0 ? "no plan_select layout for these row_warps / vpl"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
