// Ablation variants of the gather kernels K1 and K2 for NVIDIA Hopper
// (sm_90a): the diagnostic kernels S3 (K1) and S2 (K2).
//
// Replaces the Pallas TPU kernels of the repository's kernel benchmarks:
//   S3a scripts/bench_kernelvars.py:56  build_variant_kernel  (launched :587)
//   S3b scripts/bench_kernelvars.py:205 build_twophase_kernel (launched :442)
//   S3c scripts/bench_kernelvars.py:316 build_runs_kernel     (launched :517)
//   S2  scripts/bench_groupedvars.py:39 build_grouped_variant (launched :224)
//
// S3a and S2 are policies of the Hopper mainloop that K1 and K2 run
// (hopper_attn_kernel, hopper_attn.cuh): each variant is K1's SparseTiles
// or K2's GroupedTiles (sparse_tiles.cuh) with one part taken out or
// changed through the mainloop's hooks (MainloopDefaults: the ring depth,
// the unit's copy, no copies, a load-only consumer, the linear exp), so
// that its time attributes K1's or K2's own kernel: 128-row CTAs of 384
// threads, TMA copies of 128-key units into an mbarrier ring, wgmma, the
// branch-free mask.  A variant is a template parameter, not a runtime
// branch; this file is built apart from block_sparse.cu, so K1/K2/K1q
// compile exactly as they do without it.
//
// S3b and S3c still run on the previous design (variant_kernel below, to
// be redesigned): one thread block (4 warps) owns 64 query rows of one
// index list, walks its key blocks in 64-key units through a two-stage
// ring in shared memory and runs S = Q K^T and O += P V with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulation) and an online softmax in
// registers.
//
// What each variant computes (the JAX scripts' semantics; the plain
// versions in kernels/variants.py repeat them).  The mainloop's unit is
// one 128-key block; where a variant is defined in 64-key units it keeps
// that meaning.
//   S3a (one list per 128 rows; the scripts' lists are not padded, so a
//   slot past the list reads indices[min(s, nb-1)])
//     base        K1 with every unit masked element by element (no clean
//                 prefix, no unit-level window test)
//     base3, *3   the same on a three-stage ring (226 KB of shared memory)
//     dma         the copies and waits of base, no products: per chunk of
//                 chunk_blocks slots it adds row 0 of the chunk's first K
//                 tile, read from the ring, into every output row (l = 0)
//     dmahalf     dma copying the first 64 keys of each block only
//     dmabig      per chunk, chunk_blocks contiguous blocks (2 x
//                 chunk_blocks 64-key units) from block min(idx[c*g],
//                 NBtot - g), no index lookup per unit; adds that block's
//                 row 0
//     compute*    no copies in the walk: each ring stage is filled once,
//                 at its first use, with keys 0-63 of the head's K and V
//                 in both of its 64-row halves, so every walked unit is
//                 that real tile and the output is a nonzero attention
//                 (computenoexp: NaN, as noexp)
//     nomask      no count or window mask over the JAX chunk extent
//                 ceil(count/g)*g slots (so it walks up to g-1 slots more
//                 than base)
//     noexp       exp replaced by the script's linear form (alpha = m_prev
//                 - m_next + 1, p = s - m_next): NaN on every row with
//                 count > 0, by construction (m starts at -inf)
//   S3b twophase  the clean chunks (clean // g of them, clean counted by
//                 the wrapper) unmasked, the tail masked element by element
//   S3c runs      K1 whose K and V units arrive by the copy engine (TMA:
//                 cp.async.bulk.tensor, one mbarrier per ring stage, one
//                 issuing thread) instead of 16-byte cp.asyncs from every
//                 thread; the walk follows the run pieces of
//                 piece_lengths, one index lookup per piece
//   S2 (one union list per group * 128 rows, membership in rowbits)
//     full        K2 (GroupedTiles itself)
//     dma         K2's member walk plus each chunk's first slot, load only
//                 as S3a dma
//     compute     K2 without copies, as S3a compute
//     computeclean  compute without the key window (a row block with no
//                 member slot still averages V over its chunks: K2's
//                 degenerate walk)
//     nobias      every union slot, no membership test, K1's masks:
//                 K1's SparseTiles over the union lists with block_m =
//                 group * 128 (attention over the union)
//     prefetch    K2 where a CTA walks SPAN = 4 consecutive row tiles of
//                 its head through the mainloop's tile loop, so the
//                 producer loads the next tile's q and units while the
//                 consumers finish the last; output equals full
//
// S3c's copies.  A 128-key block of bf16 K|V at D = 128 is 64 KB.  Two ring
// stages holding a whole piece of max_run blocks fit the 227 KB of shared
// memory only at max_run = 1, so the ring keeps 64-key stages and a piece
// streams through them: a piece saves index lookups, and each unit is 4
// copies (K and V, two 64-column halves each: a 128-byte-swizzled box of
// 64 x 64).  The tensor copy's 128-byte swizzle (chunk c of row r at chunk
// c ^ (r & 7)) keeps ldmatrix conflict-free.
//
// What bounds them on the H100: the load-only variants by HBM and L2
// bytes (each unit gathers 64 KB of K|V, dmahalf 32 KB), the compute-only
// ones by tensor-core and exp work; the rest as K1 (operations).  The
// variants exist to measure that split.

#include "sparse_tiles.cuh"

namespace {

enum Variant : int {
  BASE = 0, DMA, DMAHALF, DMABIG, COMPUTE, COMPUTECLEAN, COMPUTENOMASK,
  COMPUTENOEXP, NOMASK, NOEXP,                      // S3a
  TWOPHASE,                                         // S3b
  RUNS,                                             // S3c
  G_FULL, G_DMA, G_COMPUTE, G_COMPUTECLEAN, G_NOBIAS, G_PREFETCH,  // S2
};

constexpr int SPAN = 4;   // S2 prefetch: consecutive row tiles per CTA

// ------------------------------------------------ S3a and S2 on the mainloop

// The load-only body: row 0 of a ring stage's K tile (in the 128-byte
// swizzle row 0's 16-byte chunk c sits at c) added into every row of this
// thread's accumulator, in fp32
template <typename T>
__device__ __forceinline__ void add_k_row0(const unsigned char* ks,
                                           float (&o)[64], const Frag& f) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 x = Type<T>::unpack(*reinterpret_cast<const uint32_t*>(
        ks + (j >> 3) * HA_HALF + (j & 7) * 16 + 4 * f.t4));
    o[4 * j] += x.x;
    o[4 * j + 1] += x.y;
    o[4 * j + 2] += x.x;
    o[4 * j + 3] += x.y;
  }
}

// S3a: K1's SparseTiles with variant V on a ring of NS stages
template <typename T, int V, int NS>
struct KernelVariant : SparseTiles<T, false> {
  using Base = SparseTiles<T, false>;
  using Params = K1Params;
  using Tile = typename Base::Tile;
  using Window = KeyWindow;
  static constexpr int STAGES = NS;
  static constexpr bool LOAD_ONLY = V == DMA || V == DMAHALF || V == DMABIG;
  static constexpr bool COPIES = !(V == COMPUTE || V == COMPUTECLEAN ||
                                   V == COMPUTENOMASK || V == COMPUTENOEXP);
  static constexpr bool LINEAR = V == NOEXP || V == COMPUTENOEXP;
  // base's mask on every unit, or (nomask, computeclean, computenomask)
  // none at all
  static constexpr bool MASKED = !LOAD_ONLY && V != NOMASK &&
                                 V != COMPUTECLEAN && V != COMPUTENOMASK;
  // the JAX chunk extent ceil(count / g) * g (dmabig: of whole blocks)
  static constexpr bool EXTENT = V == NOMASK || V == COMPUTENOMASK ||
                                 V == DMABIG;
  // rows whose every walked key is masked average V over their chunks'
  // other lanes after the walk (K1's pass); without exp or masks there is
  // no such row
  static constexpr bool DEGEN = MASKED && !LINEAR;

  static __device__ Tile tile(const Params& p, int t) {
    Tile c = Base::tile(p, t);
    if (EXTENT) {
      const int g = p.chunk_blocks;
      c.u1 = (c.count + g - 1) / g * g;
    }
    return c;
  }
  // the scripts' lists are not padded: slot s >= nb_slots reads nb_slots - 1
  static __device__ int block_of(const Params& p, const Tile& c, int slot) {
    const int blk = c.idx[min(slot, p.nb_slots - 1)];
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  }
  static __device__ int key_row(const Params& p, const Tile& c, int u) {
    if constexpr (V == DMABIG) {
      const int g = p.chunk_blocks, r = u % g;
      return (min(block_of(p, c, u - r), p.num_key_blocks - g) + r) * HA_KEYS;
    } else {
      return block_of(p, c, u) * HA_KEYS;
    }
  }
  static __device__ Window window(const Params& p, const Tile& c, int u,
                                  const Frag& f) {
    Window w{};
    w.all = true;
    if constexpr (MASKED) {
      const int blk0 = block_of(p, c, u) * HA_KEYS;
      w.all = false;
      w.vis = p.visual_len - blk0 - 2 * f.t4;
      w.t_lo = p.text_start - blk0 - 2 * f.t4;
      w.t_n = p.has_text ? (unsigned)c.tlen : 0u;
    }
    return w;
  }
  // dmahalf: the first 64 keys of each block (32 KB)
  static constexpr int COPY_BYTES = V == DMAHALF ? HA_STAGE / 2 : HA_STAGE;
  static __device__ void copy(const Params& p, const Tile& c, int row,
                              unsigned char* dst, uint64_t* full) {
    if constexpr (V == DMAHALF) {
      tma_rows64(dst, &p.tmk, row, c.kv_head, c.kv_batch, full);
      tma_rows64(dst + HA_TILE, &p.tmv, row, c.kv_head, c.kv_batch, full);
    } else {
      MainloopDefaults::copy(p, c, row, dst, full);
    }
  }
  // per chunk, row 0 of its first unit's K, in chunk order
  static __device__ void load_only(const Params& p, const Tile&, int u,
                                   const unsigned char* ks, float (&o)[64],
                                   const Frag& f) {
    if (u % p.chunk_blocks == 0) add_k_row0<T>(ks, o, f);
  }
  static __device__ void finish(const Params& p, const Tile& c,
                                float (&o)[64], float (&m)[2], float (&l)[2],
                                const Frag& f, float* sums) {
    if constexpr (DEGEN) {
      // degenerate rows (K1's pass): every lane of the chunk padding with
      // p = 1, from the column sums of V over the padding blocks (the
      // compute-only variants: of the ring's tile, keys 0-63 twice)
      if (c.count > 0 && m[0] <= MASK_VALUE) {
        const int g = p.chunk_blocks;
        const int npad = (c.count + g - 1) / g * g;
        const T* vb = reinterpret_cast<const T*>(p.v) +
                      (long long)c.bh * p.kv_bh_stride + f.wtid;
        float acc = 0.f;
        for (int ps = c.count; ps < npad; ++ps) {
          const T* vr = vb + (COPIES ? (long long)block_of(p, c, ps) *
                                           HA_KEYS * p.kv_row_stride
                                     : 0ll);
          for (int r = 0; r < HA_KEYS; ++r)
            acc += to_float(vr[(long long)(COPIES ? r : r & 63) *
                               p.kv_row_stride]);
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
    }
    float inv[2];
    quad_sum(l, inv);
    store_rows<T, false>(p.o, nullptr, nullptr,
                         (long long)c.bh * p.sq + c.q_row + f.row, o, m, l,
                         inv, f);
  }
};

// S2 (but full, which is GroupedTiles, and nobias, which is SparseTiles
// over the union lists): K2's GroupedTiles with variant V
template <typename T, int V>
struct GroupedVariant : GroupedTiles<T> {
  using Base = GroupedTiles<T>;
  using Params = K1Params;
  using Tile = typename Base::Tile;
  using Window = KeyWindow;
  static constexpr bool LOAD_ONLY = V == G_DMA;
  static constexpr bool COPIES = V != G_COMPUTE && V != G_COMPUTECLEAN;
  static constexpr bool WINDOW = V != G_COMPUTECLEAN;   // K1's key window
  static constexpr bool SPANS = V == G_PREFETCH;        // SPAN row tiles a CTA

  static __device__ int first(const Params&) {
    return SPANS ? SPAN * (int)blockIdx.x : 0;
  }
  static __device__ int count(const Params& p) {
    return SPANS ? min(SPAN * (int)blockIdx.x + SPAN, p.sq / HA_ROWS) : 1;
  }
  static __device__ int stride(const Params&) { return 1; }
  static __device__ Tile tile(const Params& p, int t) {
    Tile c = Base::tile_at(p, SPANS ? t : (int)blockIdx.x);
    if constexpr (!WINDOW) {
      // every key counts: degenerate when no slot is a member
      int s = 0;
      while (s < c.count && !Base::member(c, s)) ++s;
      const int g = p.chunk_blocks;
      c.degenerate = c.count > 0 && s == c.count;
      c.u1 = c.degenerate ? (c.count + g - 1) / g * g : c.count;
    }
    if constexpr (LOAD_ONLY) {
      c.degenerate = false;
      c.u1 = c.count;
    }
    return c;
  }
  // dma also walks each chunk's first slot, whose K row 0 it adds
  static __device__ int next(const Params& p, const Tile& c, int u) {
    if constexpr (LOAD_ONLY) {
      while (u < c.count && !Base::member(c, u) && u % p.chunk_blocks) ++u;
      return u;
    } else {
      return Base::next(p, c, u);
    }
  }
  static __device__ Window window(const Params& p, const Tile& c, int u,
                                  const Frag& f) {
    if constexpr (WINDOW && !LOAD_ONLY) return Base::window(p, c, u, f);
    Window w{};
    w.all = !c.degenerate;   // a degenerate CTA keeps no key
    w.vis = -(1 << 30);
    return w;
  }
  static __device__ void load_only(const Params& p, const Tile&, int u,
                                   const unsigned char* ks, float (&o)[64],
                                   const Frag& f) {
    if (u % p.chunk_blocks == 0) add_k_row0<T>(ks, o, f);
  }
};

template <int V>
int launch_s3a(const K1Params& p, dim3 grid, int stages, cudaStream_t s) {
  using T = __nv_bfloat16;
  if (stages == 2)
    return launch_hopper_attn<T, KernelVariant<T, V, 2>>(p, grid, s);
  if (stages == 3)
    return launch_hopper_attn<T, KernelVariant<T, V, 3>>(p, grid, s);
  return -1;
}

// ------------------------------------- S3b and S3c on the previous design

constexpr int BLOCK_N = 128;    // keys per index-list block
constexpr int BLOCK_M = 128;    // query rows per list row block
constexpr int UNIT = 64;        // keys per ring stage
constexpr int TILE_M = 64;      // query rows per thread block
constexpr int NTHREADS = 128;
constexpr int NS = 2;           // ring stages
constexpr int D = 128;          // head_dim
constexpr int LD = D + 8;       // padded smem row (elements)

template <int V> struct Traits {
  static constexpr bool BULK = V == RUNS;           // TMA tensor copies
  // twophase masks the slots past its whole clean chunks; runs K1's tail
  static constexpr bool TAIL = V == TWOPHASE;
  // the scripts' S3 lists are not padded: slot s >= nb reads nb - 1
  static constexpr bool PAD_LAST = !BULK;
};

struct VParams {
  CUtensorMap tmk, tmv;   // runs: K and V as [BH*S rows, D] for the copy engine
  const void* q;          // [BH, Sq, D] bf16
  const void* k;          // K row t of head bh at k + bh*kv_bh_stride + t*kv_row_stride
  const void* v;
  void* o;                // [BH, Sq, D]
  const int* indices;     // [BH, n_list, nb_slots]
  const int* counts;      // [BH, n_list]
  const int* clean;       // [BH, n_list]
  const int* text_len;    // [B]
  const int* plen;        // [BH, n_list, nb_slots] (runs)
  long long kv_bh_stride, kv_row_stride;   // elements
  int heads, sq, n_list, nb_slots, num_key_blocks, chunk_blocks;
  int visual_len, text_start, has_text, seq_rows;
  float sm_scale;
};

// runs' ring stage: K then V, each two 64-column halves of [64 rows][128 B]
// in the 128-byte swizzle (1024-byte aligned)
constexpr int HALF_TILE = UNIT * 64 * 2;          // 8 KB
constexpr int SWZ_STAGE = 4 * HALF_TILE;          // 32 KB

template <bool BULK>
constexpr int smem_bytes() {
  return BULK ? TILE_M * LD * 2 + 1024 + NS * SWZ_STAGE + NS * 8
              : (TILE_M + 2 * NS * UNIT) * LD * 2;
}

template <int V>
__global__ void __launch_bounds__(NTHREADS, 2)
variant_kernel(const __grid_constant__ VParams p) {
  using T = __nv_bfloat16;
  using X = Traits<V>;
  constexpr int KT = D / 16, NT = D / 8, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [TILE_M][LD]
  // twophase's ring: [NS][UNIT][LD] for K, then for V; runs: the swizzled
  // ring, its start rounded up to 1024 bytes in the shared address space
  T* sK = sQ + TILE_M * LD;
  T* sV = sK + NS * UNIT * LD;
  unsigned char* ring = smem_raw + TILE_M * LD * 2;
  if constexpr (X::BULK)
    ring += (1024u - (smem_addr(ring) & 1023u)) & 1023u;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + NS * SWZ_STAGE);  // BULK
  auto k_stage = [&](int st) -> T* {
    return X::BULK ? reinterpret_cast<T*>(ring + st * SWZ_STAGE) : sK + st * UNIT * LD;
  };
  auto v_stage = [&](int st) -> T* {
    return X::BULK ? reinterpret_cast<T*>(ring + st * SWZ_STAGE + 2 * HALF_TILE)
                   : sV + st * UNIT * LD;
  };
  // element (row, col) of a stage's K or V tile (col a multiple of 8)
  auto at = [&](T* tile, int row, int col) -> T* {
    if constexpr (X::BULK)
      return reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(tile) +
                                  (col >> 6) * HALF_TILE + row * 128 +
                                  ((((col & 63) >> 3) ^ (row & 7)) << 4));
    else
      return tile + row * LD + col;
  };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int mi = lane >> 3, r8 = lane & 7;   // ldmatrix: matrix id / row within it
  const int bh = blockIdx.y;
  const int b = bh / p.heads;
  const int tlen = p.text_len[b];
  const int cb = p.chunk_blocks;
  const T* kg = reinterpret_cast<const T*>(p.k) + (long long)bh * p.kv_bh_stride;
  const T* vg = reinterpret_cast<const T*>(p.v) + (long long)bh * p.kv_bh_stride;

  if constexpr (X::BULK) {
    if (tid < NS) mbar_init(&bars[tid], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
  }
  uint32_t phase = 0;   // BULK: the parity each stage's barrier waits for

  // this block's list and its 64-row tile
  const int list = blockIdx.x >> 1, tile = blockIdx.x & 1;
  const int row0 = list * BLOCK_M + tile * TILE_M;
  const long long lr = (long long)bh * p.n_list + list;
  const int count = p.counts[lr];
  const int clean = p.clean[lr];
  const int clean_slots = clean / cb * cb;   // twophase: whole clean chunks
  const int* idx = p.indices + lr * p.nb_slots;
  const int* plen = X::BULK ? p.plen + lr * p.nb_slots : nullptr;
  const int nch = (count + cb - 1) / cb;
  const T* qg = reinterpret_cast<const T*>(p.q) + ((long long)bh * p.sq + row0) * D;
  T* og = reinterpret_cast<T*>(p.o) + ((long long)bh * p.sq + row0) * D;

  auto clamp_block = [&](int blk) {
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  };
  auto block_of = [&](int slot) {
    return clamp_block(idx[X::PAD_LAST ? min(slot, p.nb_slots - 1) : slot]);
  };

  // a cursor over the list's units: (slot, half) and the unit's first key
  // token; runs: the piece
  struct Cursor { int slot, half, tok, pstart, pend, pblk; };
  auto set_tok = [&](Cursor& c) {   // c.slot < count, c.half == 0
    if (X::BULK) {
      if (c.slot >= c.pend) {        // a new piece: one index lookup
        c.pstart = c.slot;
        c.pend = c.slot + plen[c.slot];
        c.pblk = block_of(c.slot);
      }
      c.tok = (c.pblk + c.slot - c.pstart) * BLOCK_N;
    } else {
      c.tok = block_of(c.slot) * BLOCK_N;
    }
  };
  auto valid = [&](const Cursor& c) { return c.slot < count; };
  auto init = [&](Cursor& c) {
    c.slot = 0; c.half = 0; c.pstart = 0; c.pend = -1; c.pblk = 0; c.tok = 0;
    if (valid(c)) set_tok(c);
  };
  auto advance = [&](Cursor& c) {
    if (c.half == 0) { c.half = 1; c.tok += UNIT; return; }
    c.half = 0;
    ++c.slot;
    if (valid(c)) set_tok(c);
  };
  // one unit (64 keys from token tok) of K and V into ring stage st
  auto load_unit = [&](int st, int tok) {
    const T* ks = kg + (long long)tok * p.kv_row_stride;
    const T* vs = vg + (long long)tok * p.kv_row_stride;
    T* kd = k_stage(st);
    T* vd = v_stage(st);
    if constexpr (X::BULK) {
      if (tid == 0) {
        const int row = bh * p.seq_rows + tok;
        mbar_expect_tx(&bars[st], SWZ_STAGE);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        tma_load(kd, &p.tmk, 0, row, &bars[st]);
        tma_load(reinterpret_cast<unsigned char*>(kd) + HALF_TILE, &p.tmk, 64, row, &bars[st]);
        tma_load(vd, &p.tmv, 0, row, &bars[st]);
        tma_load(reinterpret_cast<unsigned char*>(vd) + HALF_TILE, &p.tmv, 64, row, &bars[st]);
      }
    } else {
      for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
        const int r = i / CPR, c = (i % CPR) * 8;
        cp_async16(kd + r * LD + c, ks + r * p.kv_row_stride + c);
        cp_async16(vd + r * LD + c, vs + r * p.kv_row_stride + c);
      }
    }
  };

  // q * sm_scale in fp32, rounded to bf16 (the JAX kernel's q handling)
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

  // prologue: NS - 1 units in flight
  Cursor prod, cons;
  init(prod);
  cons = prod;
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (valid(prod)) load_unit(i, prod.tok);
    cp_async_commit();
    if (valid(prod)) advance(prod);
  }
  __syncthreads();   // sQ (and the barriers) written

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

  // S = (q*scale) K^T, the mask, the online softmax and O += P V for one
  // unit in stage st
  auto compute_unit = [&](int st, int slot, int col0) {
    T* kb = k_stage(st);
    T* vb = v_stage(st);
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, at(kb, np * 16 + (mi >> 1) * 8 + r8, kk * 16 + (mi & 1) * 8));
        Type<T>::mma(s[2 * np], qf[kk], kf[0], kf[1]);
        Type<T>::mma(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }
    const bool masked = X::TAIL ? slot >= clean_slots
                                : slot >= clean && col0 + UNIT > p.visual_len;
    if (masked) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = col0 + n * 8 + 2 * t4 + (e & 1);
          const bool ok = col < p.visual_len ||
              (p.has_text && col >= p.text_start && col < p.text_start + tlen);
          s[n][e] = ok ? s[n][e] : MASK_VALUE;
        }
      }
    }
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
        ldmatrix_x4_trans(vf, at(vb, kk * 16 + (mi & 1) * 8 + r8, dp * 16 + (mi >> 1) * 8));
        Type<T>::mma(o_acc[2 * dp], a, vf[0], vf[1]);
        Type<T>::mma(o_acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  };

  int st = 0;
  while (valid(cons)) {
    // the unit NS - 1 ahead goes into the stage computed last iteration
    const int pst = st == 0 ? NS - 1 : st - 1;
    if (valid(prod)) load_unit(pst, prod.tok);
    cp_async_commit();
    if (valid(prod)) advance(prod);
    if constexpr (X::BULK) {
      mbar_wait(&bars[st], (phase >> st) & 1u);
      phase ^= 1u << st;
    } else {
      cp_async_wait<NS - 1>();
    }
    __syncthreads();
    compute_unit(st, cons.slot, cons.tok);
    __syncthreads();   // stage st is refilled NS - 1 iterations on
    advance(cons);
    st = st + 1 == NS ? 0 : st + 1;
  }

  // degenerate rows (block_sparse.cu's header): count > 0 and no unmasked
  // walked key; every other lane of the row's chunks weighs p = 1.
  // Uniform over the block; other blocks skip it.
  if (count > 0 && m_r[0] <= MASK_VALUE) {
    const int npad = nch * cb;
    m_r[0] = m_r[1] = MASK_VALUE;
    uint32_t ones[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ones[i] = Type<T>::pack(1.f, 1.f);
    for (int pslot = count; pslot < npad; ++pslot) {
      // past the list: the scripts' S3 read nb - 1, K1 pads with 0
      const int blk = (X::PAD_LAST || pslot < p.nb_slots) ? block_of(pslot) : 0;
      for (int h = 0; h < 2; ++h) {
        T* v0 = v_stage(0);
        const T* vs = vg + ((long long)blk * BLOCK_N + h * UNIT) * p.kv_row_stride;
        for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
          const int r = i / CPR, c = (i % CPR) * 8;
          cp_async16(at(v0, r, c), vs + r * p.kv_row_stride + c);
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
            ldmatrix_x4_trans(vf, at(v0, kk * 16 + (mi & 1) * 8 + r8, dp * 16 + (mi >> 1) * 8));
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

template <int V>
int launch_skeleton(const VParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = smem_bytes<Traits<V>::BULK>();
  auto kern = variant_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(p.sq / TILE_M, bh), NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One variant launch.  `variant` numbers the Variant enum above (the
// Python wrapper's table); `stages` 2, or 3 for S3a.  S2 takes `group`
// row blocks per union list and `rowbits`; S3b `clean` as the wrapper
// counts it, S3c `plen`.  Returns a cudaError_t value (0 on success), -1
// for an unknown variant or stage count, -2 if a tensor map cannot be
// encoded.
int rsa_variant_launch(int variant, int stages, const void* q, const void* k,
                       const void* v, void* o, const int* indices,
                       const int* counts, const int* clean,
                       const int* rowbits, const int* text_len,
                       const int* plen, long long kv_bh_stride,
                       long long kv_row_stride, int bh, int heads, int sq,
                       int n_list, int nb_slots, int num_key_blocks,
                       int group, int chunk_blocks, int visual_len,
                       int text_start, int has_text, float sm_scale,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant < BASE || variant > G_PREFETCH || sq % HA_ROWS ||
      (stages != 2 && !(stages == 3 && variant <= NOEXP)))
    return -1;
  if (variant == TWOPHASE || variant == RUNS) {
    VParams p{};
    p.q = q; p.k = k; p.v = v; p.o = o;
    p.indices = indices; p.counts = counts; p.clean = clean;
    p.text_len = text_len; p.plen = plen;
    p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
    p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
    p.num_key_blocks = num_key_blocks; p.chunk_blocks = chunk_blocks;
    p.visual_len = visual_len; p.text_start = text_start;
    p.has_text = has_text;
    p.seq_rows = (int)(kv_bh_stride / kv_row_stride);
    p.sm_scale = sm_scale;
    if (variant == TWOPHASE) return launch_skeleton<TWOPHASE>(p, bh, s);
    const long long rows = (long long)bh * p.seq_rows;
    if (encode_map(&p.tmk, k, rows, kv_row_stride) ||
        encode_map(&p.tmv, v, rows, kv_row_stride))
      return -2;
    return launch_skeleton<RUNS>(p, bh, s);
  }
  // S3a and S2: K1's / K2's launch parameters (bf16, head_dim 128)
  K1Params p{};
  const long long keys = (long long)num_key_blocks * HA_KEYS;
  if (encode_rows_map(&p.tmq, 0, q, sq, bh, 1, HA_D, (long long)sq * HA_D,
                      (long long)bh * sq * HA_D) ||
      encode_rows_map(&p.tmk, 0, k, keys, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride) ||
      encode_rows_map(&p.tmv, 0, v, keys, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride))
    return -2;
  p.o = o; p.v = v;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.rowbits = rowbits; p.text_len = text_len;
  p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks;
  // nobias is K1 over the union lists: one list per group * 128 rows
  p.block_m = variant == G_NOBIAS ? group * HA_ROWS : HA_ROWS;
  p.chunk_blocks = chunk_blocks; p.group = group;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.n_split = 1; p.split_slots = nb_slots;
  p.sm_scale = sm_scale;
  using T = __nv_bfloat16;
  const int tiles = sq / HA_ROWS;
  const dim3 grid(tiles, bh);
  switch (variant) {
    case BASE: return launch_s3a<BASE>(p, grid, stages, s);
    case DMA: return launch_s3a<DMA>(p, grid, stages, s);
    case DMAHALF: return launch_s3a<DMAHALF>(p, grid, stages, s);
    case DMABIG: return launch_s3a<DMABIG>(p, grid, stages, s);
    case COMPUTE: return launch_s3a<COMPUTE>(p, grid, stages, s);
    case COMPUTECLEAN: return launch_s3a<COMPUTECLEAN>(p, grid, stages, s);
    case COMPUTENOMASK: return launch_s3a<COMPUTENOMASK>(p, grid, stages, s);
    case COMPUTENOEXP: return launch_s3a<COMPUTENOEXP>(p, grid, stages, s);
    case NOMASK: return launch_s3a<NOMASK>(p, grid, stages, s);
    case NOEXP: return launch_s3a<NOEXP>(p, grid, stages, s);
    case G_FULL: return launch_hopper_attn<T, GroupedTiles<T>>(p, grid, s);
    case G_DMA:
      return launch_hopper_attn<T, GroupedVariant<T, G_DMA>>(p, grid, s);
    case G_COMPUTE:
      return launch_hopper_attn<T, GroupedVariant<T, G_COMPUTE>>(p, grid, s);
    case G_COMPUTECLEAN:
      return launch_hopper_attn<T, GroupedVariant<T, G_COMPUTECLEAN>>(
          p, grid, s);
    case G_NOBIAS:
      return launch_hopper_attn<T, SparseTiles<T, false>>(p, grid, s);
    case G_PREFETCH:
      return launch_hopper_attn<T, GroupedVariant<T, G_PREFETCH>>(
          p, dim3((tiles + SPAN - 1) / SPAN, bh), s);
  }
  return -1;
}

const char* rsa_error_string(int code) {
  if (code == -2) return "cuTensorMapEncodeTiled failed (the variants' tensor maps)";
  return code < 0 ? "unknown variant or stage count"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
