// Ablation variants of the gather kernels K1 and K2 for NVIDIA Hopper
// (sm_90a): the diagnostic kernels S3 (K1) and S2 (K2).
//
// Replaces the Pallas TPU kernels of the repository's kernel benchmarks:
//   S3a scripts/bench_kernelvars.py:56  build_variant_kernel  (launched :587)
//   S3b scripts/bench_kernelvars.py:205 build_twophase_kernel (launched :442)
//   S3c scripts/bench_kernelvars.py:316 build_runs_kernel     (launched :517)
//   S2  scripts/bench_groupedvars.py:39 build_grouped_variant (launched :224)
//
// Every variant is a policy of the Hopper mainloop that K1 and K2 run
// (hopper_attn_kernel, hopper_attn.cuh): K1's SparseTiles or K2's
// GroupedTiles (sparse_tiles.cuh) with one part taken out or changed
// through the mainloop's hooks (MainloopDefaults: the ring depth, the
// unit's copy, no copies, a load-only consumer, the linear exp, the
// producer's cursor), so that its time attributes K1's or K2's own kernel:
// 128-row CTAs of 384 threads, TMA copies of 128-key units into an
// mbarrier ring, wgmma, the branch-free mask.  A variant is a template
// parameter, not a runtime branch; this file is built apart from
// block_sparse.cu, so K1/K2/K1q compile exactly as they do without it.
//
// What each variant computes (the JAX scripts' semantics; the plain
// versions in kernels/variants.py repeat them).  The mainloop's unit is
// one 128-key block; where a variant is defined in 64-key units it keeps
// that meaning.
//   S3a and S3b (one list per 128 rows; the scripts' lists are not padded,
//   so a slot past the list reads indices[min(s, nb-1)])
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
//     twophase    (S3b) base whose whole clean chunks (the first clean / g
//                 of them, clean as the wrapper counts it:
//                 twophase_clean) keep every key with no selects, the
//                 script's body_clean; every later unit is masked element
//                 by element (body_tail).  On ascending lists the clean
//                 chunks hold only keys base's mask keeps, so the output
//                 is base's bit for bit: the same units, the same
//                 products, selects that change no kept value.
//   S3c runs      K1 itself for the consumers (K1's clean prefix, window
//                 and finish, which pads past the list with block 0),
//                 whose producer walks the run pieces of piece_lengths
//                 (plen): a slot with plen > 0 starts a piece and is the
//                 one whose block index the producer reads; the piece's
//                 later units take the next blocks with no index read.
//                 Pieces never cross a chunk or pass count.  Output: K1's,
//                 bit for bit (the units arrive in K1's order).
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
// What "one copy per piece" can mean on this card (S3c).  On the TPU the
// script fetched a piece of up to max_run blocks with one DMA.  Here a ring
// stage holds one 128-key unit, 64 KB of K|V (ha_smem(2) = 165,936 bytes
// of the 232,448 a CTA may have); a max_run = 4 piece is 256 KB, so no
// stage can hold one, and the ring keeps one unit a stage.  What a piece
// can save is index reads, and copy instructions per unit: under the
// 128-byte swizzle a TMA box is at most 128 bytes (64 bf16 columns) wide
// and 256 rows tall, so S3c copies a unit as two 64-column x 128-row boxes
// a tensor (4 a unit, from K and V maps encoded with box_rows 128) where
// K1's tma_tile issues four 64 x 64 boxes a tensor (8 a unit).  The
// shared-memory layout is the same (16-byte chunk c of row r at c ^ (r &
// 7), 8 KB of rows on 1,024-byte boundaries), so the consumers read what
// K1's read.  runs1 is K1's addressing with the larger boxes, runs2 /
// runs4 add the pieces: the bench splits the two effects.
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

// S3a and S3b: K1's SparseTiles with variant V on a ring of NS stages
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
    const int g = p.chunk_blocks;
    if (EXTENT) c.u1 = (c.count + g - 1) / g * g;
    // twophase: the units of whole clean chunks
    if (V == TWOPHASE) c.clean = c.clean / g * g;
    return c;
  }
  // the scripts' lists are not padded: slot s >= nb_slots reads nb_slots - 1
  static __device__ int block_of(const Params& p, const Tile& c, int slot) {
    const int blk = c.idx[min(slot, p.nb_slots - 1)];
    return blk < 0 ? 0 : (blk >= p.num_key_blocks ? p.num_key_blocks - 1 : blk);
  }
  static __device__ int key_row(const Params& p, const Tile& c, int u,
                                typename Base::Cursor&) {
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
      // twophase's clean chunks keep every key; no unit-level shortcut
      w.all = V == TWOPHASE && u < c.clean;
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
      tma_halves(dst, &p.tmk, row, c.kv_head, c.kv_batch, full);
      tma_halves(dst + HA_TILE, &p.tmv, row, c.kv_head, c.kv_batch, full);
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

// S3c: K1 (SparseTiles) whose producer walks the run pieces of plen
struct RunsParams : K1Params {
  const int* plen;   // [BH, n_list, nb_slots]: piece_lengths
};

template <typename T>
struct RunPieces : SparseTiles<T, false> {
  using Base = SparseTiles<T, false>;
  using Params = RunsParams;
  using Tile = typename Base::Tile;
  // the piece being walked: units below `end` read block `base` + u
  struct Cursor {
    int end, base;
  };
  static __device__ int key_row(const Params& p, const Tile& c, int u,
                                Cursor& k) {
    if (u >= k.end) {
      // a new piece: one read of its length and of its block index
      k.end = u + p.plen[c.idx - p.indices + u];
      k.base = Base::block_of(p, c, u) - u;
    }
    return (k.base + u) * HA_KEYS;
  }
  // a unit as one 64-column x 128-row box a column half (maps of box_rows
  // 128): 4 copies, where K1 issues 8
  static __device__ void copy(const Params& p, const Tile& c, int row,
                              unsigned char* dst, uint64_t* full) {
    tma_halves(dst, &p.tmk, row, c.kv_head, c.kv_batch, full);
    tma_halves(dst + HA_TILE, &p.tmv, row, c.kv_head, c.kv_batch, full);
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
  // K1's / K2's launch parameters (bf16, head_dim 128); S3c adds plen and
  // copies K and V in boxes of 128 rows
  RunsParams p{};
  const long long keys = (long long)num_key_blocks * HA_KEYS;
  const int box_rows = variant == RUNS ? HA_KEYS : 64;
  if (encode_rows_map(&p.tmq, 0, q, sq, bh, 1, HA_D, (long long)sq * HA_D,
                      (long long)bh * sq * HA_D) ||
      encode_rows_map(&p.tmk, 0, k, keys, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride, box_rows) ||
      encode_rows_map(&p.tmv, 0, v, keys, bh, 1, kv_row_stride, kv_bh_stride,
                      bh * kv_bh_stride, box_rows))
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
  p.plen = plen;
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
    case TWOPHASE:
      return launch_hopper_attn<T, KernelVariant<T, TWOPHASE, 2>>(p, grid, s);
    case RUNS: return launch_hopper_attn<T, RunPieces<T>>(p, grid, s);
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
