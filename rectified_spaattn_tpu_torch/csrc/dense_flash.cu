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
// neither read nor written, keys past Sk are zero-filled by the copy engine
// and score -inf (they are not keys), so the caller's tensors are never
// padded.  P is rounded to the K/V type before PV; m, l and O stay in fp32.
//
// Design.  The Hopper mainloop of hopper_attn.cuh: a CTA of 384 threads
// owns 128 query rows of one (batch, head); a producer warp copies the q
// tile and each 128-key unit of K and V by TMA (4-D tensor maps over (D,
// row, head, batch) with the caller's strides, so a [B, S, H, D]
// projection is read in place; zero fill past Sk), two consumer warpgroups
// run wgmma.m64n128k16 for S = Q K^T and O += P V.  The CTAs are
// persistent, one per SM, and walk (head, row tile) pairs in head-major
// order: the next tile's q load overlaps this tile's last unit and
// epilogue, and the CTAs resident at one time share a head's K/V in L2.
// The mask is branch-free: per unit, the key window (col < Sk) and the
// kv_valid bits (packed 32 keys a word by the wrapper) are selected into
// the scores.  The output is written from registers through its strides.
//
// What bounds it on the H100.  Wan2.1-14B text cross-attention: q
// [1,40,75648,128] against 512 keys is 7.93e11 flops (0.80 ms at 989 TF/s
// dense bf16) against 1.55 GB of q and out (0.46 ms at 3.35 TB/s): bound by
// tensor-core operations.  With the 257-key CLIP image context the bytes bound
// it (0.46 ms).  A 512-key tile is four units between a q prologue and an
// o epilogue, so the persistent walk matters there; each tile still reads
// its head's K/V (256 KB at 512 keys) from L2, ~8x the q and o bytes.

#include "hopper_attn.cuh"

namespace {

struct K3Params {
  CUtensorMap tmq, tmk, tmv;   // (D, row, head, batch) maps of q, k and v
  void* o;                     // element (b, h, row, d) at
  long long o_b, o_h, o_r;     //   b*o_b + h*o_h + row*o_r + d
  const unsigned* kv_bits;     // [B, words]: bit k%32 of word k/32 = key k valid; or null
  int heads, sq, sk, row_tiles, tiles, words;
  float sm_scale;
};

template <typename T>
struct DenseTiles : MainloopDefaults {
  using Params = K3Params;
  static constexpr bool SCALE_Q = false;   // the scores are scaled in fp32
  struct Tile {
    int q_row, q_head, q_batch, kv_head, kv_batch, u0, u1;
  };
  // persistent: tiles blockIdx.x, + gridDim.x, ... in head-major order
  static __device__ int first(const Params&) { return blockIdx.x; }
  static __device__ int count(const Params& p) { return p.tiles; }
  static __device__ int stride(const Params&) { return gridDim.x; }
  static __device__ Tile tile(const Params& p, int t) {
    Tile c;
    const int bh = t / p.row_tiles;
    c.q_row = (t % p.row_tiles) * HA_ROWS;
    c.q_head = c.kv_head = bh % p.heads;
    c.q_batch = c.kv_batch = bh / p.heads;
    c.u0 = 0;
    c.u1 = (p.sk + HA_KEYS - 1) / HA_KEYS;
    return c;
  }
  static __device__ int next(const Params&, const Tile&, int u) { return u; }
  static __device__ int key_row(const Params&, const Tile&, int u,
                                Cursor&) {
    return u * HA_KEYS;
  }
  // the unit's key window, once: offsets (from this thread's first
  // column) below `lim` are keys; a key whose kv_valid bit (bits >> 2 t4:
  // this thread's columns at bit 8 j' + e of word j / 4) is clear scores
  // MASK_VALUE, a non-key -inf.  Without kv_valid a unit of 128 keys
  // (`all`, the same for every thread) is only scaled.
  struct Window {
    int lim;
    uint32_t bits[4];
    bool all;
  };
  static __device__ Window window(const Params& p, const Tile& c, int u,
                                  const Frag& f) {
    Window w;
    w.all = (p.kv_bits == nullptr) & ((u + 1) * HA_KEYS <= p.sk);
    w.lim = p.sk - u * HA_KEYS - 2 * f.t4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w.bits[i] = (p.kv_bits ? p.kv_bits[(long long)c.q_batch * p.words +
                                         4 * u + i]
                             : 0xffffffffu) >> (2 * f.t4);
    return w;
  }
  static __device__ void mask(const Params& p, const Window& w,
                              float (&s)[64]) {
    if (w.all) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] *= p.sm_scale;
      return;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int j = i >> 2, off = 8 * j + (i & 1);
      const bool key = off < w.lim;
      const bool ok = key & (((w.bits[j >> 2] >> (8 * (j & 3) + (i & 1))) & 1u) != 0u);
      s[i] = ok ? s[i] * p.sm_scale : (key ? MASK_VALUE : neg_inf());
    }
  }
  static __device__ void finish(const Params& p, const Tile& c,
                                float (&o)[64], float (&)[2], float (&l)[2],
                                const Frag& f, float*) {
    float inv[2];
    quad_sum(l, inv);   // l >= 1: the row max itself contributes exp(0)
    T* og = reinterpret_cast<T*>(p.o) + c.q_batch * p.o_b + c.q_head * p.o_h +
            2 * f.t4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c.q_row + f.row + 8 * r;
      if (row >= p.sq) continue;
      T* orow = og + (long long)row * p.o_r;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) = Type<T>::pack(
            o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
    }
  }
};

}  // namespace

extern "C" {

// K3.  Pointers to q/k/v/out (element (b, h, row, d) at b*s_b + h*s_h +
// row*s_r + d, d contiguous; strides in elements, multiples of 8),
// kv_bits [B, words] (words = 4 * ceil(sk / 128)) or null.  Returns a
// cudaError_t value (0 on success), -1 for an unsupported (dtype,
// head_dim), -2 if a tensor map cannot be encoded.
int rsa_k3_launch(const void* q, const void* k, const void* v, void* o,
                  const void* kv_bits, long long q_b, long long q_h,
                  long long q_r, long long k_b, long long k_h, long long k_r,
                  long long v_b, long long v_h, long long v_r, long long o_b,
                  long long o_h, long long o_r, int batch, int heads, int sq,
                  int sk, float sm_scale, int head_dim, int dtype,
                  void* stream) {
  // head_dim 128 only: the width of every model this port runs
  if (head_dim != HA_D || (dtype != 0 && dtype != 1)) return -1;
  K3Params p{};
  if (encode_rows_map(&p.tmq, dtype, q, sq, heads, batch, q_r, q_h, q_b) ||
      encode_rows_map(&p.tmk, dtype, k, sk, heads, batch, k_r, k_h, k_b) ||
      encode_rows_map(&p.tmv, dtype, v, sk, heads, batch, v_r, v_h, v_b))
    return -2;
  p.o = o; p.o_b = o_b; p.o_h = o_h; p.o_r = o_r;
  p.kv_bits = static_cast<const unsigned*>(kv_bits);
  p.heads = heads; p.sq = sq; p.sk = sk;
  p.row_tiles = (sq + HA_ROWS - 1) / HA_ROWS;
  p.tiles = batch * heads * p.row_tiles;
  p.words = 4 * ((sk + HA_KEYS - 1) / HA_KEYS);
  p.sm_scale = sm_scale;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.tiles < sms ? p.tiles : sms);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_hopper_attn<__nv_bfloat16, DenseTiles<__nv_bfloat16>>(p, grid, s);
  return launch_hopper_attn<__half, DenseTiles<__half>>(p, grid, s);
}

const char* rsa_error_string(int code) {
  if (code == -2) return "cuTensorMapEncodeTiled failed (K3's tensor maps)";
  return code < 0 ? "unsupported dtype or head_dim"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
