// Ablation variants of the gather kernels K1 and K2 for NVIDIA Hopper
// (sm_90a): the diagnostic kernels S3 (K1) and S2 (K2).
//
// Replaces the Pallas TPU kernels of the repository's kernel benchmarks:
//   S3a scripts/bench_kernelvars.py:56  build_variant_kernel  (launched :587)
//   S3b scripts/bench_kernelvars.py:205 build_twophase_kernel (launched :442)
//   S3c scripts/bench_kernelvars.py:316 build_runs_kernel     (launched :517)
//   S2  scripts/bench_groupedvars.py:39 build_grouped_variant (launched :224)
//
// Each variant is K1's (or K2's) design in block_sparse.cu with one part
// taken out or changed, so that its time attributes the port's own kernel:
// one thread block (4 warps) owns 64 query rows of one index list, walks
// its key blocks in 64-key units through a cp.async ring in shared memory,
// and runs S = Q K^T and O += P V with mma.sync.m16n8k16 (bf16 in, fp32
// accumulation) and an online softmax in registers.  A variant is a
// template parameter, not a runtime branch; this file is built apart from
// block_sparse.cu, so K1/K2/K1q compile exactly as they do without it.
//
// What each variant computes (the JAX scripts' semantics; the plain
// versions in kernels/variants.py repeat them):
//   S3a (one list per 128 rows; the scripts' lists are not padded, so a
//   slot past the list reads indices[min(s, nb-1)])
//     base        K1 with every unit masked element by element (no clean
//                 prefix, no unit-level window skip)
//     base3, *3   the same with a three-stage ring: its shared memory
//                 (122 KB) leaves one block per SM instead of two
//     dma         the copies and waits of base, no mma; per chunk of
//                 chunk_blocks slots it adds the first K row of the
//                 chunk's first block into every output row (l = 0)
//     dmahalf     dma copying the first 64 keys of each block only
//     dmabig      per chunk, 2 * chunk_blocks contiguous 64-key units from
//                 block min(idx[c*g], NBtot - g), no index lookup per
//                 unit; adds that block's first K row
//     compute*    no copies in the walk: before it, every ring stage gets
//                 the head's first unit (keys 0-63 of K and V) once, so
//                 each walked unit is that real tile and the output is a
//                 nonzero attention (computenoexp: NaN, as noexp)
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
//     full        K2: non-member units skipped, K1's masks
//     dma, compute, computeclean   as above on K2's member walk
//     nobias      every union unit, no membership test (attention over
//                 the union; K2 skips non-members where JAX adds a bias)
//     prefetch    K2 where a thread block walks SPAN consecutive lists
//                 of its head and issues the next list's first unit
//                 before its epilogue (a GPU block cannot prefetch for
//                 another one); output equals full
//
// The runs cap.  A 128-key block of bf16 K|V at D = 128 is 64 KB.  Two ring
// stages holding a whole piece of max_run blocks fit the 227 KB of shared
// memory only at max_run = 1 (128 KB plus q), and then one block per SM
// instead of two.  So the ring keeps K1's 64-key stages and a piece streams
// through them: a piece saves index lookups, and each unit is 4 copies (K
// and V, two 64-column halves each: a 128-byte-swizzled box of 64 x 64)
// instead of K1's 2,048.  A plain cp.async.bulk writes contiguous bytes,
// and unpadded rows 256 bytes apart would make every ldmatrix an 8-way
// bank conflict; the tensor copy's 128-byte swizzle (chunk c of row r at
// chunk c ^ (r & 7)) keeps ldmatrix conflict-free.
//
// What bounds them on the H100: the load-only variants by HBM and L2
// bytes (each unit gathers 32 KB of K|V), the compute-only ones by
// tensor-core and exp work (mma.sync); the rest as K1.  The variants exist
// to measure that split.

// the mbarrier and TMA helpers and the tensor-map encoder of S3c
// (runs) live in hopper_attn.cuh, which the Hopper mainloop of K1/K3 shares
#include "hopper_attn.cuh"

namespace {

constexpr int BLOCK_N = 128;    // keys per index-list block
constexpr int BLOCK_M = 128;    // query rows per list row block
constexpr int UNIT = 64;        // keys per ring stage
constexpr int TILE_M = 64;      // query rows per thread block
constexpr int NTHREADS = 128;
constexpr int D = 128;          // head_dim
constexpr int LD = D + 8;       // padded smem row (elements)
constexpr int SPAN = 4;         // S2 prefetch: consecutive lists per block

enum Variant : int {
  BASE = 0, DMA, DMAHALF, DMABIG, COMPUTE, COMPUTECLEAN, COMPUTENOMASK,
  COMPUTENOEXP, NOMASK, NOEXP,                      // S3a
  TWOPHASE,                                         // S3b
  RUNS,                                             // S3c
  G_FULL, G_DMA, G_COMPUTE, G_COMPUTECLEAN, G_NOBIAS, G_PREFETCH,  // S2
};

enum MaskMode { M_NONE, M_ALL, M_TAIL, M_K1 };

template <int V> struct Traits {
  static constexpr bool GROUPED = V >= G_FULL;
  static constexpr bool LOAD = !(V == COMPUTE || V == COMPUTECLEAN ||
                                 V == COMPUTENOMASK || V == COMPUTENOEXP ||
                                 V == G_COMPUTE || V == G_COMPUTECLEAN);
  static constexpr bool MMA = !(V == DMA || V == DMAHALF || V == DMABIG ||
                                V == G_DMA);
  static constexpr bool HALF = V == DMAHALF;        // one unit per slot
  static constexpr bool BIG = V == DMABIG;          // contiguous chunk units
  static constexpr bool BULK = V == RUNS;           // TMA tensor copies
  static constexpr bool SKIP = GROUPED && V != G_NOBIAS;  // K2's member skip
  static constexpr bool CHUNK_EXTENT = V == NOMASK || V == COMPUTENOMASK;
  static constexpr bool LINEAR = V == NOEXP || V == COMPUTENOEXP;
  static constexpr int MASK =
      (V == NOMASK || V == COMPUTENOMASK || V == COMPUTECLEAN ||
       V == G_COMPUTECLEAN) ? M_NONE
      : V == TWOPHASE ? M_TAIL
      : (V == RUNS || GROUPED) ? M_K1 : M_ALL;
  // rows whose every walked key is masked, or (K2's member skip) that walk
  // no unit, average V over their chunks' other lanes (K1's second pass;
  // the compute-only variants add their ring's tile); without mma or exp,
  // or without masks or skips, there is no such row to repair
  static constexpr bool DEGEN = MMA && !LINEAR && (MASK != M_NONE || SKIP);
  // the scripts' S3 lists are not padded: slot s >= nb reads nb - 1
  static constexpr bool PAD_LAST = !GROUPED && V != RUNS;
  static constexpr bool PREFETCH = V == G_PREFETCH;
};

struct VParams {
  CUtensorMap tmk, tmv;   // runs: K and V as [BH*S rows, D] for the copy engine
  const void* q;          // [BH, Sq, D] bf16
  const void* k;          // K row t of head bh at k + bh*kv_bh_stride + t*kv_row_stride
  const void* v;
  void* o;                // [BH, Sq, D]
  const int* indices;     // [BH, n_list, nb_slots]
  const int* counts;      // [BH, n_list]
  const int* clean;       // [BH, n_list] (twophase, runs, S2)
  const int* rowbits;     // [BH, n_list, nb_slots] (S2)
  const int* text_len;    // [B]
  const int* plen;        // [BH, n_list, nb_slots] (runs)
  long long kv_bh_stride, kv_row_stride;   // elements
  int heads, sq, n_list, nb_slots, num_key_blocks, group, chunk_blocks;
  int visual_len, text_start, has_text, seq_rows;
  float sm_scale;
};

// runs' ring stage: K then V, each two 64-column halves of [64 rows][128 B]
// in the 128-byte swizzle (1024-byte aligned)
constexpr int HALF_TILE = UNIT * 64 * 2;          // 8 KB
constexpr int SWZ_STAGE = 4 * HALF_TILE;          // 32 KB

template <int NS, bool BULK>
constexpr int smem_bytes() {
  return BULK ? TILE_M * LD * 2 + 1024 + NS * SWZ_STAGE + NS * 8
              : (TILE_M + 2 * NS * UNIT) * LD * 2;
}

template <int V, int NS>
__global__ void __launch_bounds__(NTHREADS, 2)
variant_kernel(const __grid_constant__ VParams p) {
  using T = __nv_bfloat16;
  using X = Traits<V>;
  constexpr int KT = D / 16, NT = D / 8, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);       // [TILE_M][LD]
  // K1's ring: [NS][UNIT][LD] for K, then for V; runs: the swizzled ring,
  // its start rounded up to 1024 bytes in the shared address space
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
  if constexpr (!X::LOAD) {
    // the walk copies nothing: fill every stage once with the head's first
    // unit, a defined tile (the TPU variant read stale VMEM)
    for (int st = 0; st < NS; ++st)
      for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
        const int r = i / CPR, c = (i % CPR) * 8;
        cp_async16(sK + (st * UNIT + r) * LD + c, kg + (long long)r * p.kv_row_stride + c);
        cp_async16(sV + (st * UNIT + r) * LD + c, vg + (long long)r * p.kv_row_stride + c);
      }
    cp_async_commit();
    cp_async_wait<0>();
  }
  uint32_t phase = 0;   // BULK: the parity each stage's barrier waits for

  // which lists this block walks, and which 64-row tile of them
  const int tiles = 2 * p.group;
  const int tile = blockIdx.x % tiles;
  const int list0 = X::PREFETCH ? (blockIdx.x / tiles) * SPAN : blockIdx.x / tiles;
  const int list1 = X::PREFETCH ? min(list0 + SPAN, p.n_list) : list0 + 1;
  const int member_bit = tile >> 1;
  bool prefetched = false;   // this list's first unit is in stage 0 already

  auto clamp_block = [&](int blk) {
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  };

  for (int list = list0; list < list1; ++list) {
    if (list != list0) __syncthreads();   // the previous list is done with sQ
    const int row0 = list * p.group * BLOCK_M + tile * TILE_M;
    const long long lr = (long long)bh * p.n_list + list;
    const int count = p.counts[lr];
    const int clean = p.clean ? p.clean[lr] : 0;
    const int clean_slots = clean / cb * cb;   // twophase: whole clean chunks
    const int* idx = p.indices + lr * p.nb_slots;
    const int* bits = X::GROUPED ? p.rowbits + lr * p.nb_slots : nullptr;
    const int* plen = X::BULK ? p.plen + lr * p.nb_slots : nullptr;
    const int nch = (count + cb - 1) / cb;
    const int extent = X::CHUNK_EXTENT ? nch * cb : count;
    const T* qg = reinterpret_cast<const T*>(p.q) + ((long long)bh * p.sq + row0) * D;
    T* og = reinterpret_cast<T*>(p.o) + ((long long)bh * p.sq + row0) * D;

    auto block_of = [&](int slot) {
      return clamp_block(idx[X::PAD_LAST ? min(slot, p.nb_slots - 1) : slot]);
    };
    auto member = [&](int slot) {
      return !X::SKIP || slot < clean || ((bits[slot] >> member_bit) & 1);
    };
    auto next_slot = [&](int slot) {
      if (X::SKIP)
        while (slot < extent && !member(slot)) ++slot;
      return slot;
    };
    auto big_start = [&](int c) {
      return min(block_of(c * cb), p.num_key_blocks - cb);
    };

    // a cursor over the list's units: (slot, half) and the unit's first
    // key token; dmabig: (chunk, unit of the chunk); runs: the piece
    struct Cursor { int slot, half, tok, pstart, pend, pblk; };
    auto set_tok = [&](Cursor& c) {   // c.slot < extent, c.half == 0
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
    auto valid = [&](const Cursor& c) {
      return X::BIG ? c.slot < nch : c.slot < extent;
    };
    auto init = [&](Cursor& c) {
      c.half = 0; c.pstart = 0; c.pend = -1; c.pblk = 0; c.tok = 0;
      c.slot = X::BIG ? 0 : next_slot(0);
      if (valid(c)) {
        if (X::BIG) c.tok = big_start(0) * BLOCK_N;
        else set_tok(c);
      }
    };
    auto advance = [&](Cursor& c) {
      if (X::BIG) {
        if (++c.half == 2 * cb) { c.half = 0; ++c.slot; }
        if (valid(c)) c.tok = big_start(c.slot) * BLOCK_N + c.half * UNIT;
        return;
      }
      if (!X::HALF && c.half == 0) { c.half = 1; c.tok += UNIT; return; }
      c.half = 0;
      c.slot = next_slot(c.slot + 1);
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

    // prologue: NS - 1 units in flight (the first one may have been issued
    // by the previous list's epilogue)
    Cursor prod, cons;
    init(prod);
    cons = prod;
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) {
      const bool issued = i == 0 && prefetched;
      if (X::LOAD && valid(prod) && !issued) load_unit(i, prod.tok);
      if (!issued) cp_async_commit();
      if (valid(prod)) advance(prod);
    }
    prefetched = false;
    __syncthreads();   // sQ (and the filled ring, the barriers) written

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
      bool masked = false;
      if (X::MASK == M_ALL) masked = true;
      if (X::MASK == M_TAIL) masked = slot >= clean_slots;
      if (X::MASK == M_K1) masked = slot >= clean && col0 + UNIT > p.visual_len;
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
        // noexp: the script's linear stand-in (-inf at the first unit)
        alpha[i] = X::LINEAR ? m_r[i] - m_new + 1.f : __expf(m_r[i] - m_new);
        m_r[i] = m_new;
      }
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = s[n][e] - m_r[e >> 1];
          const float pe = X::LINEAR ? d : __expf(d);
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
      if (X::LOAD && valid(prod)) load_unit(pst, prod.tok);
      cp_async_commit();
      if (valid(prod)) advance(prod);
      if constexpr (X::BULK) {
        mbar_wait(&bars[st], (phase >> st) & 1u);
        phase ^= 1u << st;
      } else {
        cp_async_wait<NS - 1>();
      }
      __syncthreads();
      if constexpr (X::MMA) compute_unit(st, cons.slot, cons.tok);
      __syncthreads();   // stage st is refilled NS - 1 iterations on
      advance(cons);
      st = st + 1 == NS ? 0 : st + 1;
    }

    if constexpr (X::DEGEN) {
      // degenerate rows (block_sparse.cu's header): count > 0 and no
      // unmasked walked key; every other lane of the row's chunks weighs
      // p = 1.  Uniform over the block; other blocks skip it.
      if (count > 0 && m_r[0] <= MASK_VALUE) {
        const int npad = nch * cb;
        m_r[0] = m_r[1] = MASK_VALUE;
        uint32_t ones[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ones[i] = Type<T>::pack(1.f, 1.f);
        for (int pslot = 0; pslot < npad; ++pslot) {
          if (pslot < count && member(pslot)) continue;
          // past the list: the scripts' S3 read nb - 1, K1/K2 pad with 0
          const int blk = (X::PAD_LAST || pslot < p.nb_slots) ? block_of(pslot) : 0;
          for (int h = 0; h < 2; ++h) {
            T* v0 = v_stage(0);   // compute-only: every unit is its tile already
            if constexpr (X::LOAD) {
              const T* vs = vg + ((long long)blk * BLOCK_N + h * UNIT) * p.kv_row_stride;
              for (int i = tid; i < UNIT * CPR; i += NTHREADS) {
                const int r = i / CPR, c = (i % CPR) * 8;
                cp_async16(at(v0, r, c), vs + r * p.kv_row_stride + c);
              }
              cp_async_commit();
              cp_async_wait<0>();
            }
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
    }

    if constexpr (!X::MMA) {
      // the load-only variants: per chunk, the first K row of its block
      // (dmabig: of its contiguous span) into every row, l stays 0
      for (int c = 0; c < nch; ++c) {
        const int blk = X::BIG ? big_start(c) : block_of(c * cb);
        const T* kr = kg + (long long)blk * BLOCK_N * p.kv_row_stride + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 f = Type<T>::unpack(*reinterpret_cast<const uint32_t*>(kr + n * 8));
          o_acc[n][0] += f.x;
          o_acc[n][1] += f.y;
          o_acc[n][2] += f.x;
          o_acc[n][3] += f.y;
        }
      }
    }

    if constexpr (X::PREFETCH) {
      // the next list's first member unit into stage 0 (free: the walk and
      // the degenerate pass ended on a barrier), in flight during this
      // list's epilogue
      if (list + 1 < list1) {
        const long long nr = lr + 1;
        const int ncount = p.counts[nr], nclean = p.clean[nr];
        const int* nidx = p.indices + nr * p.nb_slots;
        const int* nbits = p.rowbits + nr * p.nb_slots;
        int s0 = 0;
        while (s0 < ncount && !(s0 < nclean || ((nbits[s0] >> member_bit) & 1))) ++s0;
        if (s0 < ncount) {
          load_unit(0, clamp_block(nidx[s0]) * BLOCK_N);
          cp_async_commit();
          prefetched = true;
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
}

template <int V, int NS>
int launch(const VParams& p, int bh, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NS, Traits<V>::BULK>();
  auto kern = variant_kernel<V, NS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = 2 * p.group;
  const int nx = Traits<V>::PREFETCH
      ? (p.n_list + SPAN - 1) / SPAN * tiles : p.sq / TILE_M;
  dim3 grid(nx, bh);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// stages 2, and 3 for the S3a variants (the scripts' trailing "3")
template <int V>
int launch_stages(const VParams& p, int bh, int stages, cudaStream_t s) {
  if (stages == 2) return launch<V, 2>(p, bh, s);
  if constexpr (V <= NOEXP) {
    if (stages == 3) return launch<V, 3>(p, bh, s);
  }
  return -1;
}

}  // namespace

extern "C" {

// One variant launch.  `variant` numbers the Variant enum above (the
// Python wrapper's table); `stages` 2 or 3.  Returns a cudaError_t value (0
// on success) or -1 for an unknown variant or stage count.
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
  VParams p{};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.indices = indices; p.counts = counts; p.clean = clean;
  p.rowbits = rowbits; p.text_len = text_len; p.plen = plen;
  p.kv_bh_stride = kv_bh_stride; p.kv_row_stride = kv_row_stride;
  p.heads = heads; p.sq = sq; p.n_list = n_list; p.nb_slots = nb_slots;
  p.num_key_blocks = num_key_blocks; p.group = group;
  p.chunk_blocks = chunk_blocks;
  p.visual_len = visual_len; p.text_start = text_start; p.has_text = has_text;
  p.seq_rows = (int)(kv_bh_stride / kv_row_stride);
  p.sm_scale = sm_scale;
  if (variant == RUNS) {
    const long long rows = (long long)bh * p.seq_rows;
    if (encode_map(&p.tmk, k, rows, kv_row_stride) ||
        encode_map(&p.tmv, v, rows, kv_row_stride))
      return -2;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case BASE: return launch_stages<BASE>(p, bh, stages, s);
    case DMA: return launch_stages<DMA>(p, bh, stages, s);
    case DMAHALF: return launch_stages<DMAHALF>(p, bh, stages, s);
    case DMABIG: return launch_stages<DMABIG>(p, bh, stages, s);
    case COMPUTE: return launch_stages<COMPUTE>(p, bh, stages, s);
    case COMPUTECLEAN: return launch_stages<COMPUTECLEAN>(p, bh, stages, s);
    case COMPUTENOMASK: return launch_stages<COMPUTENOMASK>(p, bh, stages, s);
    case COMPUTENOEXP: return launch_stages<COMPUTENOEXP>(p, bh, stages, s);
    case NOMASK: return launch_stages<NOMASK>(p, bh, stages, s);
    case NOEXP: return launch_stages<NOEXP>(p, bh, stages, s);
    case TWOPHASE: return launch_stages<TWOPHASE>(p, bh, stages, s);
    case RUNS: return launch_stages<RUNS>(p, bh, stages, s);
    case G_FULL: return launch_stages<G_FULL>(p, bh, stages, s);
    case G_DMA: return launch_stages<G_DMA>(p, bh, stages, s);
    case G_COMPUTE: return launch_stages<G_COMPUTE>(p, bh, stages, s);
    case G_COMPUTECLEAN: return launch_stages<G_COMPUTECLEAN>(p, bh, stages, s);
    case G_NOBIAS: return launch_stages<G_NOBIAS>(p, bh, stages, s);
    case G_PREFETCH: return launch_stages<G_PREFETCH>(p, bh, stages, s);
  }
  return -1;
}

const char* rsa_error_string(int code) {
  if (code == -2) return "cuTensorMapEncodeTiled failed (runs' tensor maps)";
  return code < 0 ? "unknown variant or stage count"
                  : cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
