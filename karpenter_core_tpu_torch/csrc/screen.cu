// Requirement screen for NVIDIA Hopper (sm_90a): verdict[n, b] =
// Requirements.Compatible(slot row n as the node side, item row b as the
// pod side), requirements.go:123-133.
//
// Replaces the Pallas TPU kernel karpenter_core_tpu/ops/pallas_kernels.py
// (_screen_kernel, reached through slot_screen_pallas and
// batched_slot_screen_pallas). That kernel ran three bf16 [TN, V] x [V, K]
// contractions per slot tile on the MXU (allowed count, excluded count and
// intersection count per key) plus the per-key flag algebra, once per pair.
// Here the work splits by what it depends on:
//
// * screen_prep_kernel, once per row (one warp per row): re-lays the 0/1
//   value plane in the ScreenLayout word order (every key segment starts on
//   a 32-value word), as packed 32-bit words (word-major [W, R], for the
//   row forms) and as int8 bytes ([R, 32 W], for the block form), and
//   writes per-row key bitmasks of KW = ceil(K / 32) words ([4, KW, R]):
//   def, out, esc and deny. On the slot side esc is derived here from the
//   row's own words, def & ((out & has_excl) | (~out & ~has_allow)), so the
//   allowed and excluded counts of the TPU kernel are computed once per row
//   and never per pair. On the item side esc and deny are the pod's planes.
//
// * screen_block_kernel (N > 1 and B > 1), on the tensor cores: per key k,
//   inter_k[n, b] = sum over the key's values of a[n, v] * b[b, v] > 0 is a
//   segmented 0/1 contraction. Each 32-value word of the layout is one k32
//   slab of mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, and no segment
//   straddles a slab, so a key's slabs accumulate in int32, the accumulator
//   is tested against 0 into the key's bit of the pair's inter mask at the
//   key's last slab, and reset. Integer arithmetic on 0/1 inputs: exact, no
//   atomics, no floats. A block of 16 warps stages a 128-slot and a
//   128-item tile of the int8 planes in shared memory with cp.async,
//   double-buffered over the word axis (8 words a stage), so there is no
//   barrier per key and the key loop runs out of registers. Keys accumulate
//   in groups of 16, two pairs' inter masks to a register (128 registers a
//   thread, one block per SM, one wave at the main path's shape). After each
//   group the pair's verdict folds in the key-bitmask algebra, with the
//   block's bitmasks staged in shared memory:
//     ok &= AND( ~(s_def & i_def) | (s_out & i_out) | (s_esc & i_esc)
//                | inter | ~on ) == ~0,   deny |= (i_deny & ~s_def) != 0,
//   and the block writes its slot-major [N, B] verdict bytes through shared
//   memory with coalesced stores.
//
// * screen_row_kernel (N = 1 or B = 1), on the SIMT cores: the single
//   row's words and bitmasks sit in shared memory, and four threads share
//   each row of the other side, each ANDing every fourth word of a key group
//   against the single row (coalesced loads from the word-major planes). A
//   16 x 8 mma tile would waste 15/16 of itself on these shapes.
//
// What bounds it on this card: the block form's contraction is
// 2 * N * B * 32 W int8 operations (at the main path's shape 2.7 us at the
// dense int8 tensor rate) beside the per-pair key tests and flag algebra on
// the SIMT cores (4 us at the 32-bit integer rate); the row forms are
// bound by the planes' bytes. chip_smoke.py computes each bound from the
// shapes it times.
//
// Plain C interface (built with nvcc into a shared library and bound with
// ctypes); each launch goes on the caller's stream and the function returns
// cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "screen_dev.cuh"

namespace {

using screen_dev::FULL;
using screen_dev::group_ok;

// ---- prep ------------------------------------------------------------------

constexpr int PREP_WARPS = 8;

// the low 4 bits of x, one per byte (bit i -> byte i), as 0/1 int8 values
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(PREP_WARPS * 32)
screen_prep_kernel(const uint8_t* __restrict__ allow, int a_ld,  // [R, >= width]
                   const uint8_t* __restrict__ out, int o_ld,    // [R, K]
                   const uint8_t* __restrict__ def, int d_ld,    // [R, K]
                   const uint8_t* __restrict__ esc, int e_ld,    // [R, K] or null
                   const uint8_t* __restrict__ deny, int n_ld,   // [R, K] or null
                   const int32_t* __restrict__ bit_col,          // [W * 32] column or -1
                   const int32_t* __restrict__ word_key,         // [W] key of each word
                   uint32_t* __restrict__ words,                 // [W, R] or null
                   int8_t* __restrict__ bytes,                   // [R, 32 W] or null
                   uint32_t* __restrict__ flags,                 // [4, KW, R]
                   int R, int W, int K, int KW) {
  extern __shared__ uint32_t prep_sh[];  // per warp: has-allowed, has-excluded key bits
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * PREP_WARPS + warp;
  if (r >= R) return;  // uniform across the warp
  uint32_t* has_a = prep_sh + warp * 2 * KW;
  uint32_t* has_x = has_a + KW;
  for (int q = lane; q < KW; q += 32) {
    has_a[q] = 0u;
    has_x[q] = 0u;
  }
  __syncwarp();
  const uint8_t* arow = allow + (size_t)r * a_ld;
  // lane j of each 32-word chunk packs word w0 + j: its 32 columns (a run
  // of one key's segment, -1 past its end) are 32 independent byte loads,
  // so a warp waits for memory twice per chunk, not once per word
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    if (w < W) {
      int col[32];
      const int4* cols = reinterpret_cast<const int4*>(bit_col) + (size_t)w * 8;
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        const int4 c = __ldg(cols + v);
        col[4 * v] = c.x;
        col[4 * v + 1] = c.y;
        col[4 * v + 2] = c.z;
        col[4 * v + 3] = c.w;
      }
      unsigned word = 0u, valid = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (col[j] >= 0) {
          valid |= 1u << j;
          if (__ldg(arow + col[j]) != 0) word |= 1u << j;
        }
      }
      if (words) words[(size_t)w * R + r] = word;
      if (bytes) {
        uint4* dst = reinterpret_cast<uint4*>(bytes + ((size_t)r * W + w) * 32);
        dst[0] = make_uint4(spread4(word), spread4(word >> 4), spread4(word >> 8),
                            spread4(word >> 12));
        dst[1] = make_uint4(spread4(word >> 16), spread4(word >> 20), spread4(word >> 24),
                            spread4(word >> 28));
      }
      const int k = __ldg(word_key + w);
      if (word != 0u) atomicOr(has_a + (k >> 5), 1u << (k & 31));
      if ((~word & valid) != 0u) atomicOr(has_x + (k >> 5), 1u << (k & 31));
    }
  }
  __syncwarp();
  for (int q = 0; q < KW; ++q) {
    const int k = q * 32 + lane;
    const bool in = k < K;
    const bool d = in && def[(size_t)r * d_ld + k] != 0;
    const bool o = in && out[(size_t)r * o_ld + k] != 0;
    bool e;
    if (esc) {
      e = in && esc[(size_t)r * e_ld + k] != 0;
    } else {  // escape = defined & ((out & has_excl) | (~out & ~has_allow))
      const bool a = (has_a[q] >> lane) & 1u;
      const bool x = (has_x[q] >> lane) & 1u;
      e = screen_dev::slot_escape(d, o, a, x);
    }
    const bool n = deny && in && deny[(size_t)r * n_ld + k] != 0;
    const unsigned dw = __ballot_sync(FULL, d);
    const unsigned ow = __ballot_sync(FULL, o);
    const unsigned ew = __ballot_sync(FULL, e);
    const unsigned nw = __ballot_sync(FULL, n);
    if (lane == 0) {
      flags[((size_t)0 * KW + q) * R + r] = dw;
      flags[((size_t)1 * KW + q) * R + r] = ow;
      flags[((size_t)2 * KW + q) * R + r] = ew;
      flags[((size_t)3 * KW + q) * R + r] = nw;
    }
  }
}

// ---- block form: int8 tensor-core contraction --------------------------------

// The tile shape: the one measured fastest at the main path's block
// (PERF.md), one block of 16 warps per SM.
constexpr int WARPS_M = 4;  // warps along the slot axis
constexpr int WARPS_N = 4;  // warps along the item axis
constexpr int MT = 2;       // 16-row mma tiles per warp
constexpr int NT = 4;       // 8-column mma tiles per warp
constexpr int WC = 8;       // words (k32 slabs) per pipeline stage
constexpr int STAGES = 2;   // pipeline depth over the word axis
constexpr int BM = WARPS_M * MT * 16;  // slot rows per block
constexpr int BN = WARPS_N * NT * 8;   // item rows per block
constexpr int BLOCK_THREADS = WARPS_M * WARPS_N * 32;
// staged bytes per row: WC slabs plus padding to an odd number of 32-byte
// slabs, so the 8-byte fragment loads of a half-warp (4 rows x 4 threads)
// fall on 32 distinct banks
constexpr int ROWB = ((WC + 1) | 1) * 32;
constexpr int STAGE_BYTES = (BM + BN) * ROWB;
using FailBits = unsigned long long;  // one bit per pair a thread holds
static_assert(MT * NT * 4 <= 64, "a thread's pairs fit its fail bits");
static_assert(STAGES >= 2, "loads overlap the previous chunk's mma");
static_assert(STAGES * STAGE_BYTES >= BM * BN, "the verdict tile reuses the stages");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill (rows past N or B)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// d += a (16 x 32, row) * b (32 x 8, col), int8 in, int32 accumulate (not
// volatile: the compiler may schedule it like any arithmetic)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint2& a_lo, const uint2& a_hi,
                                       const uint2& b) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a_lo.x), "r"(a_hi.x), "r"(a_lo.y), "r"(a_hi.y), "r"(b.x), "r"(b.y));
}

// Copy words [c * WC, c * WC + WC) of the block's slot and item rows into a
// stage, 16 bytes per cp.async.
__device__ __forceinline__ void load_chunk(uint8_t* stage, const int8_t* s_bytes,
                                           const int8_t* i_bytes, int n0, int b0,
                                           int N, int B, int W, int c) {
  const int w0 = c * WC;
  const int pieces = 2 * min(WC, W - w0);  // 16-byte pieces per row
  const size_t row_bytes = (size_t)W * 32;
  for (int e = threadIdx.x; e < (BM + BN) * pieces; e += BLOCK_THREADS) {
    const int r = e / pieces;
    const int p = e - r * pieces;
    const bool slot = r < BM;
    const int row = slot ? n0 + r : b0 + (r - BM);
    const bool valid = row < (slot ? N : B);
    const int8_t* base = slot ? s_bytes : i_bytes;
    const int8_t* src = valid ? base + row * row_bytes + w0 * 32 + p * 16 : base;
    cp_async16(stage + r * ROWB + p * 16, src, valid);
  }
}

// A thread's pairs: pair p = (i NT + j) 4 + e, with accumulator element e
// = 2 h + cc of mma tile (i, j) at slot row g + 8 h, item column 2 t + cc.
// inter packs two pairs per register (cc = 0 low, cc = 1 high): the keys
// accumulate in groups of 16, each pair's bits for the group in 16 bits.
constexpr int PAIRS = MT * NT * 4;

// Fold key half-group hq (keys 16 hq .. 16 hq + 15) into the pairs' fail
// bits and clear their inter bits. The key bitmasks of the block's rows
// sit in shared memory: slot flags [3, KW, BM], item flags [4, KW, BN].
__device__ __forceinline__ void block_fold(FailBits& fail, unsigned (&inter)[PAIRS / 2],
                                           const uint32_t* sh_sflag, const uint32_t* sh_iflag,
                                           const uint32_t* __restrict__ on_mask, int hq, int KW,
                                           int lrow0, int lcol0) {
  const int q = hq >> 1;
  const int sh = (hq & 1) * 16;
  const unsigned on = __ldg(on_mask + q) >> sh;
  unsigned sd[MT][2], so[MT][2], se[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = lrow0 + i * 16 + h * 8;
      sd[i][h] = sh_sflag[(0 * KW + q) * BM + lr] >> sh;
      so[i][h] = sh_sflag[(1 * KW + q) * BM + lr] >> sh;
      se[i][h] = sh_sflag[(2 * KW + q) * BM + lr] >> sh;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int lc = lcol0 + j * 8 + cc;
      const unsigned id = sh_iflag[(0 * KW + q) * BN + lc] >> sh;
      const unsigned io = sh_iflag[(1 * KW + q) * BN + lc] >> sh;
      const unsigned ie = sh_iflag[(2 * KW + q) * BN + lc] >> sh;
      const unsigned idn = sh_iflag[(3 * KW + q) * BN + lc] >> sh;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p2 = (i * NT + j) * 2 + h;
          const unsigned bits = (inter[p2] >> (16 * cc)) & 0xFFFFu;
          const unsigned ok = ~(sd[i][h] & id) | (so[i][h] & io) | (se[i][h] & ie) | bits | ~on;
          if ((ok & 0xFFFFu) != 0xFFFFu || (idn & ~sd[i][h] & 0xFFFFu) != 0u) {
            fail |= FailBits(1) << (p2 * 2 + cc);
          }
        }
      }
    }
  }
#pragma unroll
  for (int p2 = 0; p2 < PAIRS / 2; ++p2) inter[p2] = 0u;
}

__global__ void __launch_bounds__(BLOCK_THREADS, 1)
screen_block_kernel(const int8_t* __restrict__ s_bytes,    // [N, 32 W]
                    const uint32_t* __restrict__ s_flags,  // [4, KW, N]
                    const int8_t* __restrict__ i_bytes,    // [B, 32 W]
                    const uint32_t* __restrict__ i_flags,  // [4, KW, B]
                    const uint32_t* __restrict__ on_mask,  // [KW]
                    const int32_t* __restrict__ word_key,  // [W]
                    uint8_t* __restrict__ verdict,         // [N, B]
                    int N, int B, int W, int KW) {
  extern __shared__ __align__(16) uint8_t blk_sh[];
  uint8_t* stages = blk_sh;                                             // STAGES x STAGE_BYTES
  int* sh_key = reinterpret_cast<int*>(blk_sh + STAGES * STAGE_BYTES);  // [W]
  uint32_t* sh_sflag = reinterpret_cast<uint32_t*>(sh_key + W);         // [3, KW, BM]
  uint32_t* sh_iflag = sh_sflag + 3 * KW * BM;                          // [4, KW, BN]

  const int n0 = blockIdx.y * BM;
  const int b0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  // this thread's first slot row and item column within the block's tile
  const int lrow0 = wm * MT * 16 + g;
  const int lcol0 = wn * NT * 8 + 2 * t;

  for (int w = threadIdx.x; w < W; w += BLOCK_THREADS) sh_key[w] = word_key[w];
  for (int e = threadIdx.x; e < 3 * KW * BM; e += BLOCK_THREADS) {
    const int fq = e / BM;  // f KW + q
    sh_sflag[e] = s_flags[(size_t)fq * N + min(n0 + (e - fq * BM), N - 1)];
  }
  for (int e = threadIdx.x; e < 4 * KW * BN; e += BLOCK_THREADS) {
    const int fq = e / BN;
    sh_iflag[e] = i_flags[(size_t)fq * B + min(b0 + (e - fq * BN), B - 1)];
  }

  int acc[MT][NT][4];
  unsigned inter[PAIRS / 2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
  for (int p2 = 0; p2 < PAIRS / 2; ++p2) inter[p2] = 0u;
  FailBits fail = 0;
  int hq = 0;  // the key half-group being accumulated

  // a ring of STAGES chunks: chunk c + STAGES - 1 loads while chunk c's
  // slabs run through the tensor cores
  const int nchunks = (W + WC - 1) / WC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load_chunk(stages + c * STAGE_BYTES, s_bytes, i_bytes, n0, b0, N, B, W, c);
    cp_async_commit();
  }
  __syncthreads();  // the word keys and key bitmasks are staged
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();              // everyone's have, and the previous chunk is done
    const int cn = c + STAGES - 1;
    if (cn < nchunks) {
      load_chunk(stages + (cn % STAGES) * STAGE_BYTES, s_bytes, i_bytes, n0, b0, N, B, W, cn);
    }
    cp_async_commit();
    const uint8_t* st = stages + (c % STAGES) * STAGE_BYTES;
    const uint8_t* a_base = st + lrow0 * ROWB + t * 8;
    const uint8_t* b_base = st + (BM + wn * NT * 8 + g) * ROWB + t * 8;
    const int nw = min(WC, W - c * WC);
#pragma unroll
    for (int s = 0; s < WC; ++s) {
      if (s >= nw) break;
      const int w = c * WC + s;
      const int k = sh_key[w];  // uniform across the block
      while (hq < (k >> 4)) {
        block_fold(fail, inter, sh_sflag, sh_iflag, on_mask, hq, KW, lrow0, lcol0);
        ++hq;
      }
      // The 32 bytes of a slab are read in a permuted order that A and B
      // share (thread t takes bytes 8t .. 8t + 7: its k = 4t .. 4t + 3 and
      // k = 16 + 4t .. 16 + 4t + 3), so the dot product is unchanged and each
      // fragment register pair is one 8-byte load.
      uint2 a_lo[MT], a_hi[MT], bf[NT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        a_lo[i] = *reinterpret_cast<const uint2*>(a_base + (i * 16) * ROWB + s * 32);
        a_hi[i] = *reinterpret_cast<const uint2*>(a_base + (i * 16 + 8) * ROWB + s * 32);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        bf[j] = *reinterpret_cast<const uint2*>(b_base + (j * 8) * ROWB + s * 32);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], a_lo[i], a_hi[i], bf[j]);
      if (w + 1 == W || sh_key[w + 1] != k) {  // the key's last slab
        const unsigned bit = 1u << (k & 15);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned& word = inter[(i * NT + j) * 2 + h];
              word |= acc[i][j][2 * h] != 0 ? bit : 0u;
              word |= acc[i][j][2 * h + 1] != 0 ? bit << 16 : 0u;
              acc[i][j][2 * h] = 0;
              acc[i][j][2 * h + 1] = 0;
            }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups are left
  while (hq < 2 * KW) {
    block_fold(fail, inter, sh_sflag, sh_iflag, on_mask, hq, KW, lrow0, lcol0);
    ++hq;
  }

  // verdict tile through shared memory, then coalesced row-major stores
  __syncthreads();         // every warp is done reading the stages
  uint8_t* tile = blk_sh;  // [BM, BN]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lrow0 + i * 16 + 8 * (e >> 1);
        const int cl = lcol0 + j * 8 + (e & 1);
        tile[r * BN + cl] = ((fail >> ((i * NT + j) * 4 + e)) & 1u) ? 0 : 1;
      }
  __syncthreads();
  if ((B & 3) == 0) {  // 4 bytes a store: a 4-byte group is all in or all past B
    for (int e = threadIdx.x * 4; e < BM * BN; e += BLOCK_THREADS * 4) {
      const int r = e / BN;
      const int cl = e - r * BN;
      if (n0 + r < N && b0 + cl < B) {
        *reinterpret_cast<uint32_t*>(verdict + (size_t)(n0 + r) * B + b0 + cl) =
            *reinterpret_cast<const uint32_t*>(tile + e);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BM * BN; e += BLOCK_THREADS) {
      const int r = e / BN;
      const int cl = e - r * BN;
      if (n0 + r < N && b0 + cl < B) verdict[(size_t)(n0 + r) * B + b0 + cl] = tile[e];
    }
  }
}

// ---- row forms: one row against many, on the SIMT cores ----------------------

constexpr int ROW_THREADS = 128;
constexpr int ROW_PARTS = 4;  // threads per row of the other side, splitting its words

// ONE_IS_SLOT: the single row is a slot row (N = 1) and the other side's
// rows are item rows; else the single row is an item row (B = 1) and the
// other side's rows are slot rows. ROW_PARTS threads share each row of the
// other side: each ANDs every ROW_PARTS-th word of a key group against the
// single row and sets the key's bit where a word intersects; the parts'
// bits are ORed with shuffles before the group folds into the verdict.
template <bool ONE_IS_SLOT>
__global__ void __launch_bounds__(ROW_THREADS)
screen_row_kernel(const uint32_t* __restrict__ one_words,   // word w at [w * one_ld]
                  const uint32_t* __restrict__ one_flags,   // (f, q) at [(f KW + q) one_ld]
                  int one_ld,
                  const uint32_t* __restrict__ many_words,  // [W, R]
                  const uint32_t* __restrict__ many_flags,  // [4, KW, R]
                  const uint32_t* __restrict__ on_mask,     // [KW]
                  const int32_t* __restrict__ word_key,     // [W]
                  uint8_t* __restrict__ verdict,            // [R]
                  int R, int W, int KW) {
  extern __shared__ uint32_t row_sh[];
  uint32_t* sh_one = row_sh;                                     // [W]
  int* sh_key = reinterpret_cast<int*>(row_sh + W);              // [W]
  uint32_t* sh_flag = row_sh + 2 * W;                            // [4 KW]
  int* sh_gw = reinterpret_cast<int*>(row_sh + 2 * W + 4 * KW);  // [KW + 1] group starts
  for (int e = threadIdx.x; e <= KW; e += ROW_THREADS) sh_gw[e] = W;
  __syncthreads();
  for (int e = threadIdx.x; e < W; e += ROW_THREADS) {
    sh_one[e] = one_words[(size_t)e * one_ld];
    const int k = word_key[e];
    sh_key[e] = k;
    // word e is the first word of every group in (previous word's group, k's group]
    for (int grp = (e == 0 ? 0 : (word_key[e - 1] >> 5) + 1); grp <= (k >> 5); ++grp) {
      sh_gw[grp] = e;
    }
  }
  for (int e = threadIdx.x; e < 4 * KW; e += ROW_THREADS) {
    sh_flag[e] = one_flags[(size_t)e * one_ld];
  }
  __syncthreads();
  const int id = blockIdx.x * ROW_THREADS + threadIdx.x;
  const int r = id / ROW_PARTS;
  const int part = id % ROW_PARTS;
  const size_t rr = (size_t)min(r, R - 1);  // rows past R compute, and write nothing

  bool fail = false;
  for (int q = 0; q < KW; ++q) {
    unsigned inter = screen_dev::row_inter(sh_one, many_words, R, rr, sh_key, sh_gw[q] + part,
                                           sh_gw[q + 1], ROW_PARTS);
#pragma unroll
    for (int m = 1; m < ROW_PARTS; m <<= 1) inter |= __shfl_xor_sync(FULL, inter, m);
    const unsigned m0 = __ldg(many_flags + ((size_t)0 * KW + q) * R + rr);
    const unsigned m1 = __ldg(many_flags + ((size_t)1 * KW + q) * R + rr);
    const unsigned m2 = __ldg(many_flags + ((size_t)2 * KW + q) * R + rr);
    const unsigned m3 = __ldg(many_flags + ((size_t)3 * KW + q) * R + rr);
    const unsigned on = __ldg(on_mask + q);
    if (ONE_IS_SLOT) {
      fail |= !group_ok(sh_flag[q], sh_flag[KW + q], sh_flag[2 * KW + q], m0, m1, m2, m3,
                        inter, on);
    } else {
      fail |= !group_ok(m0, m1, m2, sh_flag[q], sh_flag[KW + q], sh_flag[2 * KW + q],
                        sh_flag[3 * KW + q], inter, on);
    }
  }
  if (r < R && part == 0) verdict[r] = fail ? 0 : 1;
}

// per device: the dynamic shared memory the block kernel is opted in to
// (cudaFuncSetAttribute holds for the current device only)
constexpr int MAX_DEVICES = 64;
int g_block_smem[MAX_DEVICES] = {};

int row_blocks(int R) { return (int)(((long long)R * ROW_PARTS + ROW_THREADS - 1) / ROW_THREADS); }

size_t row_smem(int W, int KW) { return (2 * (size_t)W + 5 * (size_t)KW + 1) * sizeof(uint32_t); }

}  // namespace

// Key bitmasks and re-laid planes of R rows. esc null: the slot side
// (escape derived from the row's words, deny zero); else the item side.
// words or bytes null: that output is not written.
extern "C" int screen_prep_launch(const void* allow, int a_ld, const void* out, int o_ld,
                                  const void* def, int d_ld, const void* esc, int e_ld,
                                  const void* deny, int n_ld, const void* bit_col,
                                  const void* word_key, void* words, void* bytes,
                                  void* flags, int R, int W, int K, int KW, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = (size_t)PREP_WARPS * 2 * KW * sizeof(uint32_t);
  screen_prep_kernel<<<(R + PREP_WARPS - 1) / PREP_WARPS, PREP_WARPS * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(allow), a_ld, static_cast<const uint8_t*>(out), o_ld,
      static_cast<const uint8_t*>(def), d_ld, static_cast<const uint8_t*>(esc), e_ld,
      static_cast<const uint8_t*>(deny), n_ld, static_cast<const int32_t*>(bit_col),
      static_cast<const int32_t*>(word_key), static_cast<uint32_t*>(words),
      static_cast<int8_t*>(bytes), static_cast<uint32_t*>(flags), R, W, K, KW);
  return static_cast<int>(cudaGetLastError());
}

// form 0: block (s_bytes, i_bytes); form 1: one slot row against B item rows
// (s_words); form 2: N slot rows against item row i_row (i_words). The slot
// side's planes have R = N; the item side's have R = i_ld.
extern "C" int screen_launch(int form, const void* s_words, const void* s_bytes,
                             const void* s_flags, const void* i_words, const void* i_bytes,
                             const void* i_flags, int i_ld, int i_row, const void* on_mask,
                             const void* word_key, void* verdict, int N, int B, int W,
                             int KW, void* stream) {
  if (N <= 0 || B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* on = static_cast<const uint32_t*>(on_mask);
  const int32_t* key = static_cast<const int32_t*>(word_key);
  uint8_t* v = static_cast<uint8_t*>(verdict);
  if (form == 0) {
    const int smem = STAGES * STAGE_BYTES + (W + (3 * BM + 4 * BN) * KW) * (int)sizeof(int);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    int* opted = dev < MAX_DEVICES ? &g_block_smem[dev] : nullptr;
    if (opted == nullptr || smem > *opted) {  // above 48 KB only once opted in
      err = cudaFuncSetAttribute(screen_block_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (opted != nullptr) *opted = smem;
    }
    dim3 grid((B + BN - 1) / BN, (N + BM - 1) / BM);
    screen_block_kernel<<<grid, BLOCK_THREADS, smem, st>>>(
        static_cast<const int8_t*>(s_bytes), static_cast<const uint32_t*>(s_flags),
        static_cast<const int8_t*>(i_bytes), static_cast<const uint32_t*>(i_flags), on, key, v,
        N, B, W, KW);
  } else if (form == 1) {
    screen_row_kernel<true><<<row_blocks(B), ROW_THREADS, row_smem(W, KW), st>>>(
        static_cast<const uint32_t*>(s_words), static_cast<const uint32_t*>(s_flags), 1,
        static_cast<const uint32_t*>(i_words), static_cast<const uint32_t*>(i_flags), on, key, v,
        B, W, KW);
  } else if (form == 2) {
    screen_row_kernel<false><<<row_blocks(N), ROW_THREADS, row_smem(W, KW), st>>>(
        static_cast<const uint32_t*>(i_words) + i_row,
        static_cast<const uint32_t*>(i_flags) + i_row, i_ld,
        static_cast<const uint32_t*>(s_words), static_cast<const uint32_t*>(s_flags), on, key, v,
        N, W, KW);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
