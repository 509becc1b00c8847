// Generic variants of the four decode kernels: every dtype and width
// that the decode path's plain versions take, where the fast kernels
// (band_topk.cu, decode_attention.cu, decode_blocks.cu, decode_ffn.cu)
// take bf16 at the flagship's tile widths only. Each kernel is a
// template over the element type (bf16 or fp32), multiplies with FFMA
// and sums in fp32: no tensor cores, no TF32, no TMA, no cooperative
// launch and no cluster, so fp32 stays fp32 and any width is a masked
// edge. They compute what the plain versions compute, at the same
// rounding points (a no-op in fp32):
//   - band top-k + logsumexp: logits rbf(x . table[v]) rounded to x's
//     dtype, lse over every row, top-k over ids < sel_limit, ties to
//     the lowest id (ops/pallas_topk.py::band_topk_lse);
//   - decode cross-attention: fp32 scores q . k + bias and softmax, the
//     probabilities rounded to v's dtype, fp32 value sums rounded to q's
//     dtype (ops/pallas_kernels.py::decode_cross_attention);
//   - the int8 variants of those two (the routes of the reference's
//     quantized head and K/V, which it computes in XLA: ops/adaptive.py
//     QuantTable, ops/attention.py QuantDecodeKV), the same walks with an
//     int8 operand and its scales (of the working dtype): a band logit is
//     the fp32 sum times its row's scale, rounded once; an attention
//     score the fp32 sum times its key's K scale plus the bias, a
//     probability rounded, times its key's V scale, rounded again
//     (ops/band_topk.py::band_topk_lse_int8_plain,
//     ops/decode_attention.py::decode_cross_attention_int8_plain);
//   - the FFN block: h = relu(r(r(x w1) + b1)), y = r(r(r(h w2) + b2) + x),
//     or the fp32 sum h w2 in the partial mode (ops/pallas_decode.py::
//     decode_ffn_block);
//   - the conv block: linear1, the GLU, the tap predictor and its
//     softmax, the ring combine over the cache [K-1, N, C] (K = 1: no
//     ring, the cache is never read), linear2 and the residual
//     (ops/pallas_decode.py::decode_conv_block).
// r() rounds to the working dtype.
//
// What bounds them on the card: at decode row counts (N <= 80 a call
// of the flagship's beam-5 step at batch 16) the weights, tables and
// K/V are read once and each is used for N rows, so at fp32 they are
// bound by bytes at N = 1 and by fp32 operations (67 TFLOP/s) from N of
// a few tens: the fp32 flagship's greedy step at B = 16 reads 33.5 MB of
// FFN weights and 124 MB of the largest band's table a layer or step.
// The design:
//   - The FFN's and the conv block's products are one routine,
//     `product_kernel`: a block owns a strip of 64 output columns over
//     all the rows of the call (16, 32 or 80 a tile; row tiles only past
//     80, and 16-row tiles for a product of few strips, the tap logits),
//     so each weight element is read from device memory once a call. Its 8 warps split the tile's rows into one or two groups and
//     each chunk's depth into 8 or 4 slices, so each thread sums 4, 8 or
//     10 rows x 8 columns in fp32 registers and does 8 multiplies a row
//     for every 1 + 8 / rows floats it reads from shared memory: shared
//     memory delivers 32 floats a clock to a multiprocessor, a quarter of
//     its multiplies, so tiles of 1 or 2 rows x 4 columns a thread (a
//     float4 of A and of B for 4 multiplies a row) are bound by shared
//     loads. The slices' sums are added in slice order.
//     A ring of 8 or 6 chunks of 32 of the depth that cp.async keeps
//     in flight feeds it. Where the strips leave the card's multiprocessors
//     unevenly loaded, the depth is split over blocks: each split writes
//     its fp32 tile and the last of a strip's splits to arrive (a
//     counter a strip, which it zeroes again) adds the tiles in split
//     order before the epilogue, so a product is one kernel and every
//     sum has a fixed order: two calls on the same inputs give the same
//     bits. The host's ops/decode_blocks.py::generic_product_plan
//     chooses the tile and the split. The band's walk keeps `tile_gemm`.
//   - The FFN is fc1 (its epilogue writes h in the working dtype,
//     rounded as the reference rounds) and fc2 (the residual, or the
//     fp32 sums of the partial mode); the conv block is linear1 with the
//     GLU in its epilogue (a strip's tile holds its 32 a and 32 g
//     columns), the tap logits h wl (rounded, to an fp32 scratch [N, H
//     K]), the softmax and ring combine (a block a row and 128 channels:
//     its heads' probabilities by one warp a head, then a thread a
//     channel with its K - 1 cache rows requested at once and the ring's
//     slots stepped once), and linear2 with the residual.
//   - The band walks 64-id tiles of the table, a block a chunk of tiles
//     in ascending order and a tile of x's rows, and carries each row's
//     max, sum of exponentials and top-k list (in the lanes of the warp
//     that owns the row); a merge kernel adds the chunks' states in
//     chunk order, as band_topk.cu's merge does.
//   - The attention (bound by reading K and V once: 67 MB a layer at the
//     fp32 flagship's greedy step, 20 us at 3.35 TB/s) splits each (item,
//     head)'s S' keys over blocks, grid (H, B, splits), at most 64 keys
//     a split (9 of 58 at S' = 514: 2304 blocks at B = 16; the image's
//     S' = 51 one split). A first kernel forms its split's
//     fp32 scores, writes them (B H Q S' floats) with the split's max and
//     sum of exponentials; a second merges the splits' max and sum in a
//     fixed order, forms the probabilities at the plain version's
//     rounding points and writes the split's fp32 p v; a third adds the
//     splits' parts in split order and rounds them to q's dtype. One
//     split is one kernel (scores, softmax and p v in shared memory).
//     K and V are read once each. Lanes run across a head's columns in
//     16-byte loads (4 fp32, 8 bf16 or 16 int8 a lane; one element where
//     a head's rows are not 16-byte aligned), the lanes of a key row sum
//     its score by shuffles, and key rows go across lane groups and
//     warps, a split's rows requested at once (four loads a lane) before
//     the kernel waits on q, the scores or the statistics, so every
//     thread works at Q = 1 and every multiprocessor has bytes in flight.
// The int8 variants are template instantiations of the band walk and the
// attention with an int8 table or int8 K and V (`if constexpr` on the
// operand's type), so the bf16 and fp32 instantiations keep their code.
// A call is one launch on its wrapper's count (the band, FFN, conv block
// and attention run one to four kernels in it, as band_topk.cu's two).

#include <type_traits>

#include "common.cuh"

namespace nic {
namespace gen {

constexpr int THREADS = 256;
constexpr int TN = 64;          // output columns a tile
constexpr int KC = 32;          // depth a chunk
constexpr int BS = TN + 4;      // floats a row of the B chunk (16-byte rows)
constexpr int BAND_MAX_K = 16;
constexpr int BAND_MAX_CHUNKS = 1024;
constexpr int ATT_SPLIT_KEYS = 64;   // keys a split, at most (att_plan)
constexpr int ATT_MAX_Q = 16;
constexpr int ATT_MAX_HEAD = 256;
constexpr int ATT_U = 4;             // key rows a lane loads at once
constexpr int ATT_QG = 4;            // queries' p v sums a lane holds, at most
constexpr int MAX_TAPS = 32;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld(const int8_t* p) { return (float)*p; }

template <class T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<bf16>(float v) { return rbf(v); }

template <class T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 store_as<bf16>(float v) { return __float2bfloat16(v); }

// Shared memory of tile_gemm: the A chunk [KC][RT + 1] and NB B chunks
// [KC][BS], floats.
template <int RPT, int NB>
__host__ __device__ constexpr int tile_smem_floats() {
  return KC * (16 * RPT + 1) + NB * KC * BS;
}

// acc[g][i][j] += sum over k in [k0, k1) of A[m0 + ty + 16 i][k] *
// B_g(k, n0 + 4 tx + j), tx = tid % 16, ty = tid / 16, for the NB
// column groups g whose B_g starts `goff` columns after B_{g-1}. A is
// row-major [M, lda]; B(k, n) is B[k * ldb + n] (a weight [K, N]) or,
// NK, B[n * ldb + k] (a table's rows). Rows >= M, columns >= n_end and
// depth >= k1 read as 0. k0 is a multiple of KC. Starts and ends with
// every thread of the block past a barrier. B's elements are of type TB
// (T, or int8 for the int8 band).
template <class T, bool NK, int RPT, int NB, class TB = T>
__device__ void tile_gemm(const T* __restrict__ A, int lda, int M, int m0,
                          const TB* __restrict__ B, int ldb, int goff, int n0,
                          int n_end, int k0, int k1, float (&acc)[NB][RPT][4],
                          float* smem) {
  constexpr int RT = 16 * RPT;
  constexpr int AS = RT + 1;
  constexpr int A_PER = RT * KC / THREADS;   // 2 * RPT
  constexpr int B_PER = KC * TN / THREADS;   // 8
  float* As = smem;
  float* Bs = smem + KC * AS;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float ra[A_PER], rb[NB][B_PER];

  auto load = [&](int kc) {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = tid + THREADS * q, r = e / KC, kk = e % KC;
      const int m = m0 + r, k = kc + kk;
      ra[q] = (m < M && k < k1) ? ld(A + (size_t)m * lda + k) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < NB; ++g)
#pragma unroll
      for (int q = 0; q < B_PER; ++q) {
        const int e = tid + THREADS * q;
        const int kk = NK ? e % KC : e / TN, n = NK ? e / KC : e % TN;
        const int k = kc + kk, col = n0 + n;
        rb[g][q] = (col < n_end && k < k1)
                       ? ld(NK ? B + (size_t)(g * goff + col) * ldb + k
                               : B + (size_t)k * ldb + g * goff + col)
                       : 0.f;
      }
  };
  auto stash = [&]() {
#pragma unroll
    for (int q = 0; q < A_PER; ++q) {
      const int e = tid + THREADS * q;
      As[(e % KC) * AS + e / KC] = ra[q];
    }
#pragma unroll
    for (int g = 0; g < NB; ++g)
#pragma unroll
      for (int q = 0; q < B_PER; ++q) {
        const int e = tid + THREADS * q;
        const int kk = NK ? e % KC : e / TN, n = NK ? e / KC : e % TN;
        Bs[g * KC * BS + kk * BS + n] = rb[g][q];
      }
  };

  __syncthreads();
  if (k0 < k1) load(k0);
  for (int kc = k0; kc < k1; kc += KC) {
    stash();
    __syncthreads();
    if (kc + KC < k1) load(kc + KC);
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = As[kk * AS + ty + 16 * i];
#pragma unroll
      for (int g = 0; g < NB; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(
            Bs + g * KC * BS + kk * BS + 4 * tx);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          acc[g][i][0] = fmaf(a[i], b.x, acc[g][i][0]);
          acc[g][i][1] = fmaf(a[i], b.y, acc[g][i][1]);
          acc[g][i][2] = fmaf(a[i], b.z, acc[g][i][2]);
          acc[g][i][3] = fmaf(a[i], b.w, acc[g][i][3]);
        }
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The blocks' products: FFN fc1 and fc2, conv block linear1, the tap
// logits and linear2, one routine.
//
// A block owns the output tile [MT rows][64 columns] (a row tile of the
// call, a strip of columns) over a range of the depth. Its 8 warps are
// WR row groups x WK depth slices: warp (wr, wk) sums rows wr 4 TR +
// ly + 4 i (i < TR) and columns 4 lx + 32 jj + (0..3) (jj < 2), ly =
// lane / 8, lx = lane % 8, over depths wk KW .. (wk + 1) KW - 1 of every
// chunk, so each thread holds TR x 8 fp32 sums and does 8 TR multiplies
// for every TR + 8 floats it reads from shared memory (4 TR = 16, 32 or
// 40 rows a warp: the card's shared memory delivers 32 floats a clock
// to a multiprocessor, its FFMA units 128 multiplies). The depth slices'
// sums are then added in slice order through shared memory. The operands
// come through a ring of the tile's S slots, a chunk of PROD_KC of the
// depth a slot (A [MT][KC + 4], B [KC][64], fp32 whatever the dtype):
// fp32 by 16-byte cp.async where every row and strip is 16-byte
// aligned, else through registers.

constexpr int PROD_KC = 32;
constexpr int PROD_AP = PROD_KC + 4;    // floats a row of the A chunk
constexpr int PROD_BN = 64;             // columns a tile
constexpr int PROD_TP = PROD_BN + 4;    // floats a row of the sums' tiles
// Counters of the depth splits' arrivals a device: one a (row tile,
// strip) of a product whose depth is split (ops/decode_blocks.py::
// GENERIC_COUNTERS).
constexpr int PROD_MAX_COUNTERS = 256;
constexpr int MIX_THREADS = 128;        // channels a block of the combine

// The products' epilogues; also the kinds of their phase sums.
enum Epi { EPI_RELU = 0, EPI_RESID = 1, EPI_SUM = 2, EPI_GLU = 3, EPI_LOGIT = 4 };
constexpr int KIND_MIX = 5;

// The tiles, codes as ops/decode_blocks.py::GENERIC_TILES: rows MT = 4
// TR WR (16, 32, 80) in WR row groups of 8 / WR depth slices, a ring of
// S slots (enough chunks in flight to keep one block a multiprocessor
// fed at the card's memory rate), at least MINB blocks a
// multiprocessor's registers.
template <int TR_, int WR_, int S_, int MINB_>
struct ProdTile {
  static constexpr int TR = TR_, WR = WR_, S = S_, MINB = MINB_;
  static constexpr int WK = 8 / WR, KW = PROD_KC / WK, MT = 4 * TR * WR;
  static constexpr int STAGE = MT * PROD_AP + PROD_KC * PROD_BN;   // floats a slot
  static constexpr int SMEM = 4 * S * STAGE;
  // Elements a thread of the tile, and float4s.
  static constexpr int PER = MT * PROD_BN / THREADS, PER4 = PER / 4;
  static_assert(WR * WK == THREADS / 32 && KW * WK == PROD_KC, "8 warps");
  static_assert(WK * MT * PROD_TP <= S * STAGE, "the slices' tiles fit the ring");
  static_assert(PER4 * 4 * THREADS == MT * PROD_BN, "whole float4s a thread");
};
using Tile16 = ProdTile<4, 1, 8, 2>;
using Tile32 = ProdTile<8, 1, 6, 1>;
using Tile80 = ProdTile<10, 2, 6, 1>;

struct ProdArgs {
  const void* A;          // [M, lda] of T
  const void* B;          // [K, ldb] of T
  const void* bias;       // of T: [width] (GLU: [2 width])
  const void* resid;      // [M, width] of T (EPI_RESID)
  void* out;              // [M, width]: T, or fp32 (EPI_SUM, EPI_LOGIT)
  float* part;            // [splits][row tiles][strips][MT 64] fp32 (splits > 1)
  unsigned* counters;     // [row tiles][strips] (splits > 1), zero between launches
  int M, K, lda, ldb, width, ksplit, splits, epi;
  int strip_cols;         // output columns a strip: 64 (GLU 32)
  int vec;                // 16-byte cp.async of A and B
};

// B's column of local column j (< 64) of the strip starting at output
// column n0, and whether it exists: the GLU's tile holds the strip's a
// columns in [0, 32) and its g columns (B's column width + n) in [32, 64).
__device__ __forceinline__ int prod_col(const ProdArgs& a, int n0, int j, bool& ok) {
  const bool g = j >= a.strip_cols;
  const int i = g ? j - a.strip_cols : j;
  ok = n0 + i < a.width;
  return (g ? a.width : 0) + n0 + i;
}

// Thread 0's phase sums of a product block (kind a.epi): slots 0 blocks,
// 1 waiting for chunks, 2 multiplying, 3 adding the depth slices and
// writing the partial tile, 4 the last split's sum, 5 the epilogue (in
// cycles); 6, 7 the block's life in ns and cycles; 8, 9, 10 the first
// start (as its complement), the last start and the last end, in ns; 11
// issuing the ring's first chunks (cycles).
#define PROD_PHASES(kind, wait, mul, part, sum, epi)                         \
  do {                                                                       \
    if (threadIdx.x == 0) {                                                  \
      NIC_PHASE_ADD(kind, 0, 1);                                             \
      NIC_PHASE_ADD(kind, 1, wait);                                          \
      NIC_PHASE_ADD(kind, 2, mul);                                           \
      NIC_PHASE_ADD(kind, 3, part);                                          \
      NIC_PHASE_ADD(kind, 4, sum);                                           \
      NIC_PHASE_ADD(kind, 5, epi);                                           \
      NIC_PHASE_ADD(kind, 6, NIC_PHASE_NS() - life0);                        \
      NIC_PHASE_ADD(kind, 7, NIC_PHASE_CLOCK() - c_start);                   \
      NIC_PHASE_MAX(kind, 8, ~(unsigned long long)life0);                    \
      NIC_PHASE_MAX(kind, 9, life0);                                         \
      NIC_PHASE_MAX(kind, 10, NIC_PHASE_NS());                               \
      NIC_PHASE_ADD(kind, 11, c_pro);                                        \
    }                                                                        \
  } while (0)

// Grid (strips, row tiles, splits), THREADS threads, PT::SMEM bytes of
// dynamic shared memory. With one split the block applies the epilogue;
// otherwise it writes its fp32 partial tile and the last of the strip's
// splits to arrive adds the splits' tiles in split order, then applies it.
template <class T, class PT>
__global__ void __launch_bounds__(THREADS, PT::MINB) product_kernel(ProdArgs a) {
  constexpr int TR = PT::TR, WK = PT::WK, KW = PT::KW, MT = PT::MT, S = PT::S;
  constexpr int KC = PROD_KC, AP = PROD_AP, BN = PROD_BN, TP = PROD_TP;
  extern __shared__ __align__(16) float sm[];
  __shared__ int is_last;
  const long long life0 = NIC_PHASE_NS(), c_start = NIC_PHASE_CLOCK();
  long long c_wait = 0, c_mul = 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wr = warp / WK, wk = warp % WK;
  const int strip = blockIdx.x, rt = blockIdx.y, z = blockIdx.z;
  const int m0 = rt * MT, n0 = strip * a.strip_cols;
  const int k0 = z * a.ksplit, k1 = min(a.K, k0 + a.ksplit), nk = cdiv(k1 - k0, KC);
  const int r0 = wr * 4 * TR + (lane >> 3), c0 = 4 * (lane & 7);
  const T* A = (const T*)a.A;
  const T* B = (const T*)a.B;

  auto load = [&](int c) {   // chunk c of the block's depth into slot c % S
    float* As = sm + (c % S) * PT::STAGE;
    float* Bs = As + MT * AP;
    const int kc = k0 + c * KC;
    if constexpr (std::is_same<T, float>::value) {
      if (a.vec) {
        for (int e = tid; e < MT * (KC / 4); e += THREADS) {
          const int row = e / (KC / 4), q = 4 * (e % (KC / 4));
          float* d = As + row * AP + q;
          if (m0 + row < a.M && kc + q < k1)
            cp_async16(d, A + (size_t)(m0 + row) * a.lda + kc + q);
          else
            zero16(d);
        }
        for (int e = tid; e < KC * (BN / 4); e += THREADS) {
          const int kk = e / (BN / 4), j = 4 * (e % (BN / 4));
          bool ok;
          const int col = prod_col(a, n0, j, ok);
          float* d = Bs + kk * BN + j;
          if (ok && kc + kk < k1) cp_async16(d, B + (size_t)(kc + kk) * a.ldb + col);
          else zero16(d);
        }
        return;
      }
    }
    for (int e = tid; e < MT * KC; e += THREADS) {
      const int row = e / KC, k = kc + e % KC;
      As[row * AP + e % KC] =
          m0 + row < a.M && k < k1 ? ld(A + (size_t)(m0 + row) * a.lda + k) : 0.f;
    }
    for (int e = tid; e < KC * BN; e += THREADS) {
      const int kk = e / BN, j = e % BN;
      bool ok;
      const int col = prod_col(a, n0, j, ok);
      Bs[kk * BN + j] = ok && kc + kk < k1 ? ld(B + (size_t)(kc + kk) * a.ldb + col) : 0.f;
    }
  };

  float acc[TR][2][4] = {};
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nk) load(c);
    cp_async_commit();
  }
  const long long c_pro = NIC_PHASE_CLOCK() - c_start;
  for (int c = 0; c < nk; ++c) {
    const long long t0 = NIC_PHASE_CLOCK();
    cp_async_wait<S - 2>();   // chunk c has landed (this thread's copies)
    __syncthreads();          // every thread's, and slot (c - 1) % S is free
    if (c + S - 1 < nk) load(c + S - 1);
    cp_async_commit();
    const long long t1 = NIC_PHASE_CLOCK();
    const float* As = sm + (c % S) * PT::STAGE + r0 * AP + wk * KW;
    const float* Bs = sm + (c % S) * PT::STAGE + MT * AP + wk * KW * BN + c0;
#pragma unroll
    for (int kk = 0; kk < KW; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * BN);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * BN + 32);
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const float x = As[4 * i * AP + kk];
        acc[i][0][0] = fmaf(x, b0.x, acc[i][0][0]);
        acc[i][0][1] = fmaf(x, b0.y, acc[i][0][1]);
        acc[i][0][2] = fmaf(x, b0.z, acc[i][0][2]);
        acc[i][0][3] = fmaf(x, b0.w, acc[i][0][3]);
        acc[i][1][0] = fmaf(x, b1.x, acc[i][1][0]);
        acc[i][1][1] = fmaf(x, b1.y, acc[i][1][1]);
        acc[i][1][2] = fmaf(x, b1.z, acc[i][1][2]);
        acc[i][1][3] = fmaf(x, b1.w, acc[i][1][3]);
      }
    }
    const long long t2 = NIC_PHASE_CLOCK();
    c_wait += t1 - t0;
    c_mul += t2 - t1;
  }
  cp_async_wait<0>();
  const long long c_loop = NIC_PHASE_CLOCK();
  // Each depth slice's sums into its own tile over the ring, then thread
  // t adds the slices of float4s t, t + THREADS, .. in slice order into
  // slice 0's tile, which the epilogue reads.
  __syncthreads();            // the ring is free
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      *reinterpret_cast<float4*>(sm + (wk * MT + r0 + 4 * i) * TP + c0 + 32 * jj) =
          make_float4(acc[i][jj][0], acc[i][jj][1], acc[i][jj][2], acc[i][jj][3]);
  __syncthreads();
  float4 sum[PT::PER4];
#pragma unroll
  for (int q = 0; q < PT::PER4; ++q) {
    const int e = tid + q * THREADS, at = (4 * e / BN) * TP + 4 * e % BN;
    sum[q] = *reinterpret_cast<const float4*>(sm + at);
#pragma unroll
    for (int s = 1; s < WK; ++s) {
      const float4 v = *reinterpret_cast<const float4*>(sm + s * MT * TP + at);
      sum[q] = make_float4(sum[q].x + v.x, sum[q].y + v.y, sum[q].z + v.z, sum[q].w + v.w);
    }
  }
  long long c_part = 0, c_sum = 0;
  if (a.splits > 1) {
    // This split's tile to device memory; the last of the strip's splits
    // to arrive adds the splits' tiles in split order.
    const size_t tile4 = (size_t)MT * BN / 4;
    const size_t me = (size_t)rt * gridDim.x + strip;
    const size_t zstride = (size_t)gridDim.y * gridDim.x * tile4;
    float4* p0 = reinterpret_cast<float4*>(a.part) + me * tile4;
#pragma unroll
    for (int q = 0; q < PT::PER4; ++q) p0[z * zstride + tid + q * THREADS] = sum[q];
    __syncthreads();
    if (tid == 0) {
      __threadfence();        // the block's tile is visible before its arrival
      is_last = atomicAdd(a.counters + me, 1u) == (unsigned)(a.splits - 1);
    }
    __syncthreads();
    c_part = NIC_PHASE_CLOCK() - c_loop;
    if (!is_last) {
      PROD_PHASES(a.epi, c_wait, c_mul, c_part, 0, 0);
      return;
    }
    __threadfence();
    if (tid == 0) a.counters[me] = 0u;   // for the next launch
    // The splits' tiles added in split order, four splits of every
    // float4 of the thread requested at once.
    float4 own[PT::PER4], t[PT::PER4];
#pragma unroll
    for (int q = 0; q < PT::PER4; ++q) {
      own[q] = sum[q];
      t[q] = z == 0 ? own[q] : __ldcg(p0 + tid + q * THREADS);
    }
    for (int zz = 1; zz < a.splits; zz += 4) {
      float4 v[4][PT::PER4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < PT::PER4; ++q)
          if (zz + u < a.splits)
            v[u][q] = zz + u == z ? own[q] : __ldcg(p0 + (zz + u) * zstride + tid + q * THREADS);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < PT::PER4; ++q)
          if (zz + u < a.splits)
            t[q] = make_float4(t[q].x + v[u][q].x, t[q].y + v[u][q].y, t[q].z + v[u][q].z,
                               t[q].w + v[u][q].w);
    }
#pragma unroll
    for (int q = 0; q < PT::PER4; ++q) sum[q] = t[q];
    c_sum = NIC_PHASE_CLOCK() - c_loop - c_part;
  } else {
    c_part = NIC_PHASE_CLOCK() - c_loop;
  }
  const long long c_epi0 = NIC_PHASE_CLOCK();
#pragma unroll
  for (int q = 0; q < PT::PER4; ++q) {
    const int e = tid + q * THREADS;
    *reinterpret_cast<float4*>(sm + (4 * e / BN) * TP + 4 * e % BN) = sum[q];
  }
  __syncthreads();
  // The epilogue from the tile at the reference's rounding points,
  // consecutive threads on consecutive output columns, each thread's
  // operands requested before any use.
  if (a.epi == EPI_GLU) {
    constexpr int H2 = BN / 2, PG = MT * H2 / THREADS;
    float ba[PG], bg[PG];
#pragma unroll
    for (int q = 0; q < PG; ++q) {
      const int e = tid + q * THREADS, n = n0 + e % H2;
      const bool ok = m0 + e / H2 < a.M && n < a.width;
      ba[q] = ok ? ld((const T*)a.bias + n) : 0.f;
      bg[q] = ok ? ld((const T*)a.bias + a.width + n) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PG; ++q) {
      const int e = tid + q * THREADS, ml = e / H2, j = e % H2, m = m0 + ml, n = n0 + j;
      if (m >= a.M || n >= a.width) continue;
      const float av = round_to<T>(round_to<T>(sm[ml * TP + j]) + ba[q]);
      const float gv = round_to<T>(round_to<T>(sm[ml * TP + H2 + j]) + bg[q]);
      const float sig = round_to<T>(1.f / (1.f + expf(-gv)));
      ((T*)a.out)[(size_t)m * a.width + n] = store_as<T>(round_to<T>(av * sig));
    }
  } else {
    constexpr int PE = PT::PER;
    float bv[PE], rv[PE];
#pragma unroll
    for (int q = 0; q < PE; ++q) {
      const int e = tid + q * THREADS, m = m0 + e / BN, n = n0 + e % BN;
      const bool ok = m < a.M && n < a.width;
      const size_t at = (size_t)m * a.width + n;
      bv[q] = ok && (a.epi == EPI_RELU || a.epi == EPI_RESID) ? ld((const T*)a.bias + n) : 0.f;
      rv[q] = ok && a.epi == EPI_RESID ? ld((const T*)a.resid + at) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < PE; ++q) {
      const int e = tid + q * THREADS, ml = e / BN, j = e % BN, m = m0 + ml, n = n0 + j;
      if (m >= a.M || n >= a.width) continue;
      const float s0 = sm[ml * TP + j];
      const size_t at = (size_t)m * a.width + n;
      if (a.epi == EPI_RELU)
        ((T*)a.out)[at] = store_as<T>(fmaxf(round_to<T>(round_to<T>(s0) + bv[q]), 0.f));
      else if (a.epi == EPI_RESID)
        ((T*)a.out)[at] = store_as<T>(round_to<T>(round_to<T>(round_to<T>(s0) + bv[q]) + rv[q]));
      else if (a.epi == EPI_SUM)
        ((float*)a.out)[at] = s0;
      else   // EPI_LOGIT: the tap logit, rounded, kept in fp32
        ((float*)a.out)[at] = round_to<T>(s0);
    }
  }
  PROD_PHASES(a.epi, c_wait, c_mul, c_part, c_sum, NIC_PHASE_CLOCK() - c_epi0);
}

template <class T, class PT>
cudaError_t launch_product(const ProdArgs& a, cudaStream_t stream) {
  const long long strips = cdiv(a.width, a.strip_cols), row_tiles = cdiv(a.M, PT::MT);
  if (strips > 0x7fffffff || row_tiles > 65535 ||
      (a.splits > 1 && (a.part == nullptr || a.counters == nullptr ||
                        strips * row_tiles > PROD_MAX_COUNTERS)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(product_kernel<T, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         PT::SMEM);
  if (err != cudaSuccess) return err;
  product_kernel<T, PT><<<dim3((unsigned)strips, (unsigned)row_tiles, a.splits), THREADS,
                          PT::SMEM, stream>>>(a);
  return cudaGetLastError();
}

// One product: `tile` a code of GENERIC_TILES, ksplit the depth a block
// (a multiple of PROD_KC); the caller sets a.epi and a.width, the rest
// follows from them here.
template <class T>
cudaError_t run_product(ProdArgs a, int tile, int ksplit, cudaStream_t stream) {
  if (tile < 0 || tile > 2 || a.M < 1 || a.K < 1 || a.width < 1 || ksplit < PROD_KC ||
      ksplit % PROD_KC != 0)
    return cudaErrorInvalidValue;
  a.ksplit = ksplit;
  a.splits = cdiv(a.K, ksplit);
  if (a.splits > 65535) return cudaErrorInvalidValue;
  a.strip_cols = a.epi == EPI_GLU ? PROD_BN / 2 : PROD_BN;
  a.vec = std::is_same<T, float>::value &&
          ((uintptr_t)a.A | (uintptr_t)a.B) % 16 == 0 && a.lda % 4 == 0 &&
          a.K % 4 == 0 && a.ldb % 4 == 0 && a.width % 4 == 0;
  if (tile == 0) return launch_product<T, Tile16>(a, stream);
  if (tile == 1) return launch_product<T, Tile32>(a, stream);
  return launch_product<T, Tile80>(a, stream);
}

// ---------------------------------------------------------------------------
// The conv block's softmax and ring combine, grid (channel blocks x N),
// MIX_THREADS threads, a channel c of row n a thread. The warps first
// turn the rounded tap logits of each head the block's channels touch
// into probabilities (lane k tap k; the max and the sum of exponentials
// by the warp's tree), rounded to the dtype; then, with hd = c / R (R =
// C / H),
//   acc = sum_{k < K-1} p[hd][k] * cache[(pos_n + k) mod (K-1)][n][c]
//   (fp32, k in order), hconv[n][c] = r(r(acc) + r(p[hd][K-1] h[n][c])),
// the thread's K - 1 cache rows requested at once, its ring slots
// stepped once from its row's position.
template <class T>
__global__ void __launch_bounds__(MIX_THREADS)
    conv_mix_kernel(const T* __restrict__ h, const float* __restrict__ logits,
                    const T* __restrict__ cache, const int* __restrict__ pos, int t,
                    T* __restrict__ hconv, int N, int C, int H, int K) {
  __shared__ float ps[MIX_THREADS + 1][MAX_TAPS];
  const long long life0 = NIC_PHASE_NS(), c_start = NIC_PHASE_CLOCK();
  const int cblocks = cdiv(C, MIX_THREADS);
  const int n = blockIdx.x / cblocks, cb = (blockIdx.x % cblocks) * MIX_THREADS;
  const int R = C / H, Km1 = K - 1;
  const int hd0 = cb / R, nh = min(C - 1, cb + MIX_THREADS - 1) / R - hd0 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < nh; j += MIX_THREADS / 32) {
    const float v = lane < K ? logits[((size_t)n * H + hd0 + j) * K + lane] : -INFINITY;
    const float mx = warp_max(v);
    const float ex = lane < K ? expf(v - mx) : 0.f;
    const float sum = warp_sum(ex);
    if (lane < K) ps[j][lane] = round_to<T>(ex / sum);
  }
  __syncthreads();
  const int c = cb + threadIdx.x;
  if (c < C) {
    const float* p = ps[c / R - hd0];
    float acc = 0.f;
    if (Km1 > 0) {
      const int p0 = pos != nullptr ? pos[n] : t;
      int s = (p0 % Km1 + Km1) % Km1;
      float x[MAX_TAPS - 1];
#pragma unroll
      for (int k = 0; k < MAX_TAPS - 1; ++k) {
        if (k < Km1) {
          x[k] = ld(cache + ((size_t)s * N + n) * C + c);
          s = s + 1 == Km1 ? 0 : s + 1;
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_TAPS - 1; ++k)
        if (k < Km1) acc = fmaf(p[k], x[k], acc);
    }
    const size_t at = (size_t)n * C + c;
    const float cur = round_to<T>(p[Km1] * ld(h + at));
    hconv[at] = store_as<T>(round_to<T>(round_to<T>(acc) + cur));
  }
  if (threadIdx.x == 0) {
    NIC_PHASE_ADD(KIND_MIX, 0, 1);
    NIC_PHASE_ADD(KIND_MIX, 5, NIC_PHASE_CLOCK() - c_start);
    NIC_PHASE_ADD(KIND_MIX, 6, NIC_PHASE_NS() - life0);
    NIC_PHASE_ADD(KIND_MIX, 7, NIC_PHASE_CLOCK() - c_start);
    NIC_PHASE_MAX(KIND_MIX, 8, ~(unsigned long long)life0);
    NIC_PHASE_MAX(KIND_MIX, 9, life0);
    NIC_PHASE_MAX(KIND_MIX, 10, NIC_PHASE_NS());
  }
}

// ---------------------------------------------------------------------------
// Band top-k + logsumexp.

// The row's list (lane i of the warp holds entry i, best first): insert
// (v, id), which beats the list's k-th entry.
__device__ __forceinline__ void list_insert(float& lv, int& li, int k, float v,
                                            int id) {
  const int lane = threadIdx.x & 31;
  const bool before = lane < k && (lv > v || (lv == v && li < id));
  const int p = __popc(__ballot_sync(FULL_MASK, before));
  const float uv = __shfl_up_sync(FULL_MASK, lv, 1);
  const int ui = __shfl_up_sync(FULL_MASK, li, 1);
  if (lane < k && lane > p) {
    lv = uv;
    li = ui;
  } else if (lane == p) {
    lv = v;
    li = id;
  }
}

__device__ __forceinline__ bool beats(float v, int id, float kv, int kid) {
  return v > kv || (v == kv && id < kid);
}

// Grid (row tiles, chunks). Block (g, c) walks the tiles of chunk c in
// ascending order for rows [g * RT, (g + 1) * RT); warp w owns rows
// w * RPW ..: their max, sum of exponentials and top-k list. TB int8:
// the table is int8 with one scale a row (`scale`, of x's dtype; null
// otherwise), and a logit is the fp32 sum times its row's scale, rounded
// once to x's dtype.
template <class T, int RPT, class TB = T>
__global__ void __launch_bounds__(THREADS)
    band_walk_kernel(const T* __restrict__ x, const TB* __restrict__ table,
                     const T* __restrict__ scale,
                     float* __restrict__ pmax, float* __restrict__ psum,
                     float* __restrict__ pval, int* __restrict__ pid, int N,
                     int D, int V, int sel_limit, int k, int tiles_per_chunk,
                     int chunks) {
  constexpr int RT = 16 * RPT, RPW = RT / (THREADS / 32);
  __shared__ __align__(16) float smem[tile_smem_floats<RPT, 1>()];
  __shared__ float Ls[RT][TN + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * RT, chunk = blockIdx.y;
  const int n_tiles = cdiv(V, TN);
  const int t0 = chunk * tiles_per_chunk;
  const int t1 = min(n_tiles, t0 + tiles_per_chunk);
  float m[RPW], s[RPW], lv[RPW];
  int li[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    m[j] = -INFINITY;
    s[j] = 0.f;
    lv[j] = -INFINITY;
    li[j] = BIG_ID;
  }
  for (int tile = t0; tile < t1; ++tile) {
    const int n0 = tile * TN;
    float acc[1][RPT][4] = {};
    tile_gemm<T, true, RPT, 1, TB>(x, D, N, m0, table, D, 0, n0, V, 0, D, acc, smem);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (std::is_same<TB, int8_t>::value) {
          const int col = n0 + 4 * tx + j;
          Ls[ty + 16 * i][4 * tx + j] =
              round_to<T>(acc[0][i][j] * (col < V ? ld(scale + col) : 0.f));
        } else {
          Ls[ty + 16 * i][4 * tx + j] = round_to<T>(acc[0][i][j]);
        }
      }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const int r = warp * RPW + j;
      if (m0 + r >= N) continue;           // warp-uniform
      const int id0 = n0 + lane, id1 = n0 + lane + 32;
      const float v0 = Ls[r][lane], v1 = Ls[r][lane + 32];
      const bool in0 = id0 < V, in1 = id1 < V;
      const float tmax = warp_max(fmaxf(in0 ? v0 : -INFINITY, in1 ? v1 : -INFINITY));
      const float mn = fmaxf(m[j], tmax);
      const float e = (in0 ? expf(v0 - mn) : 0.f) + (in1 ? expf(v1 - mn) : 0.f);
      s[j] = s[j] * expf(m[j] - mn) + warp_sum(e);
      m[j] = mn;
      bool c0 = id0 < sel_limit, c1 = id1 < sel_limit;
      while (true) {
        const float kv = __shfl_sync(FULL_MASK, lv[j], k - 1);
        const int kid = __shfl_sync(FULL_MASK, li[j], k - 1);
        c0 = c0 && beats(v0, id0, kv, kid);
        c1 = c1 && beats(v1, id1, kv, kid);
        if (!__any_sync(FULL_MASK, c0 || c1)) break;
        float bv = -INFINITY;
        int bid = BIG_ID;
        if (c0) { bv = v0; bid = id0; }
        if (c1 && beats(v1, id1, bv, bid)) { bv = v1; bid = id1; }
        warp_argmax(bv, bid);
        list_insert(lv[j], li[j], k, bv, bid);
        if (bid == id0) c0 = false;
        if (bid == id1) c1 = false;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    const int n = m0 + warp * RPW + j;
    if (n >= N) continue;
    const size_t at = (size_t)n * chunks + chunk;
    if (lane == 0) {
      pmax[at] = m[j];
      psum[at] = s[j];
    }
    if (lane < k) {
      pval[at * k + lane] = lv[j];
      pid[at * k + lane] = li[j];
    }
  }
}

// A warp a row: the chunks' (max, sum) into the logsumexp, and their
// sorted lists merged best first (ties to the lowest id).
__global__ void __launch_bounds__(THREADS)
    band_merge_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
                      const float* __restrict__ pval, const int* __restrict__ pid,
                      float* __restrict__ vals, int* __restrict__ ids,
                      float* __restrict__ lse, int N, int k, int chunks) {
  __shared__ int heads[THREADS / 32][BAND_MAX_CHUNKS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (THREADS / 32) + warp;
  if (n >= N) return;                     // warp-uniform; no block barrier
  const size_t base = (size_t)n * chunks;
  float M = -INFINITY;
  for (int c = lane; c < chunks; c += 32) M = fmaxf(M, pmax[base + c]);
  M = warp_max(M);
  float S = 0.f;
  for (int c = lane; c < chunks; c += 32) S += psum[base + c] * expf(pmax[base + c] - M);
  S = warp_sum(S);
  if (lane == 0) lse[n] = M + logf(S);
  for (int c = lane; c < chunks; c += 32) heads[warp][c] = 0;
  __syncwarp();
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bid = BIG_ID, bc = -1;
    for (int c = lane; c < chunks; c += 32) {
      const int hd = heads[warp][c];
      if (hd >= k) continue;
      const float v = pval[(base + c) * k + hd];
      const int id = pid[(base + c) * k + hd];
      if (bc < 0 || beats(v, id, bv, bid)) {
        bv = v;
        bid = id;
        bc = c;
      }
    }
    const int mine = bid;
    warp_argmax(bv, bid);
    if (bc >= 0 && mine == bid) heads[warp][bc] += 1;
    if (lane == 0) {
      vals[(size_t)n * k + r] = bv;
      ids[(size_t)n * k + r] = bid;
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// Decode cross-attention, S' split over blocks: grid (H, B, splits).

// The plan of a call over S keys: `splits` blocks an (item, head) of at
// most ATT_SPLIT_KEYS keys, split z taking keys [z * per, min(S, (z + 1)
// * per)), none empty; the host's ops/decode_attention.py::
// generic_attention_plan mirrors it.
__host__ __device__ inline void att_plan(int S, int& splits, int& per) {
  splits = cdiv(S, ATT_SPLIT_KEYS);
  per = cdiv(S, splits);
}

// A head's width in shared memory: dh rounded up to 16 (the widest
// vector, 16 int8).
__host__ __device__ inline int att_width(int dh) { return (dh + 15) & ~15; }

// Dynamic shared memory of every attention kernel's block, floats: q
// [Q][dhp], the split's scores, then probabilities [Q][per], the warps'
// parts of p v [8][min(Q, ATT_QG)][dhp].
__host__ __device__ inline int att_smem_floats(int Q, int dh, int per) {
  const int dhp = att_width(dh);
  return Q * dhp + Q * per + (THREADS / 32) * (Q < ATT_QG ? Q : ATT_QG) * dhp;
}

struct AttnArgs {
  const void* q;         // [B, Q, E] of T
  const void* k;         // [B, S, E] of TK
  const void* v;         // [B, S, E] of TK
  const void* k_scale;   // [B, S, H] of T (int8)
  const void* v_scale;   // [B, S, H] of T (int8)
  const float* bias;     // [B, S]
  void* out;             // [B, Q, E] of T
  float* scores;         // [B, H, Q, S] (several splits)
  float* stats;          // [2][B, H, Q, splits]: max, sum of exponentials
  float* parts;          // [B, H, splits, Q, dh]: each split's p v
  int B, Q, S, E, H, dh, splits, per;
};

// How a lane holds its part of a key row: VW elements a vector (16
// bytes' worth, or 1 where a head's rows are not 16-byte aligned), at
// most MAXV vectors a lane; QG queries' p v sums a lane keeps at once
// (16 registers, 32 for int8: few enough for four blocks a
// multiprocessor at fp32).
template <class TK, int VW_, int MAXV_>
struct RowLanes {
  static constexpr int VW = VW_, MAXV = MAXV_;
  static constexpr int QG = 16 / (MAXV * VW) > 2 ? 16 / (MAXV * VW) : 2;
  static_assert(QG <= ATT_QG, "att_smem_floats holds ATT_QG queries' parts");
  using Raw = typename std::conditional<VW == 1, float, uint4>::type;
  static_assert(VW == 1 || VW * (int)sizeof(TK) == 16, "16-byte vectors");

  __device__ static Raw load(const TK* p) {
    if constexpr (VW == 1) return ld(p);
    else return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // Element e (a constant after unrolling) of a loaded vector.
  __device__ static float elem(const Raw& r, int e) {
    if constexpr (VW == 1) {
      return r;
    } else {
      const uint32_t word = (&r.x)[e * (int)sizeof(TK) / 4];
      if constexpr (std::is_same<TK, float>::value) {
        return __uint_as_float(word);
      } else if constexpr (std::is_same<TK, bf16>::value) {
        return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
      } else {
        return (float)(int8_t)((word >> (8 * (e & 3))) & 0xffu);
      }
    }
  }
};

// The walk of a split's key rows: nv vectors a row, lpk lanes a row (a
// power of 2 up to 32), kpw rows a warp at once, vpl vectors a lane; a
// lane is lane group g (a key row) and li within it; warp w's pass at
// `base` covers rows base + g + u * gpb, u < ATT_U (gpb = 8 kpw), from
// base = w kpw in steps of gpb ATT_U.
struct Walk {
  int nv, lpk, kpw, vpl, g, li, gpb, base0;
};

__device__ __forceinline__ Walk walk_of(int dh, int vw) {
  Walk w;
  w.nv = cdiv(dh, vw);
  w.lpk = 1;
  while (w.lpk < w.nv && w.lpk < 32) w.lpk <<= 1;
  w.kpw = 32 / w.lpk;
  w.vpl = cdiv(w.nv, w.lpk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  w.g = lane / w.lpk;
  w.li = lane % w.lpk;
  w.gpb = (THREADS / 32) * w.kpw;
  w.base0 = warp * w.kpw;
  return w;
}

// Loads of a pass's key rows (rows at `rows`, E apart), those below n.
template <class L, class TK>
__device__ __forceinline__ void load_rows(typename L::Raw (&raw)[ATT_U][L::MAXV],
                                          const TK* rows, int E, const Walk& w,
                                          int base, int n) {
#pragma unroll
  for (int u = 0; u < ATT_U; ++u) {
    const int j = base + w.g + u * w.gpb;
#pragma unroll
    for (int m = 0; m < L::MAXV; ++m) {
      const int vi = w.li + w.lpk * m;
      if (j < n && m < w.vpl && vi < w.nv) raw[u][m] = L::load(rows + (size_t)j * E + vi * L::VW);
    }
  }
}

// The split's scores into ss[qi * per + j] for its n keys: the fp32 sum
// q . k (times the key's K scale, int8), plus the key's bias. `raw` holds
// the first pass's K rows, loaded by the caller.
template <class T, class TK, class L>
__device__ void att_scores(const AttnArgs& a, typename L::Raw (&raw)[ATT_U][L::MAXV],
                           const TK* kb, const float* qs, float* ss, const Walk& w,
                           int b, int hd, int k0, int n) {
  constexpr bool INT8 = std::is_same<TK, int8_t>::value;
  const int dhp = att_width(a.dh);
  const float* bb = a.bias + (size_t)b * a.S + k0;
  for (int base = w.base0; base < n; base += w.gpb * ATT_U) {
    if (base != w.base0) load_rows<L>(raw, kb, a.E, w, base, n);
#pragma unroll
    for (int u = 0; u < ATT_U; ++u) {
      if (base + u * w.gpb >= n) break;   // warp-uniform: no row of this u
      const int j = base + w.g + u * w.gpb;
      for (int qi = 0; qi < a.Q; ++qi) {
        float part = 0.f;
#pragma unroll
        for (int m = 0; m < L::MAXV; ++m) {
          const int vi = w.li + w.lpk * m;
          if (j >= n || m >= w.vpl || vi >= w.nv) continue;
          const float* qv = qs + qi * dhp + vi * L::VW;
          if constexpr (L::VW == 1) {
            part = fmaf(qv[0], L::elem(raw[u][m], 0), part);
          } else {
#pragma unroll
            for (int e4 = 0; e4 < L::VW; e4 += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qv + e4);
              part = fmaf(q4.x, L::elem(raw[u][m], e4), part);
              part = fmaf(q4.y, L::elem(raw[u][m], e4 + 1), part);
              part = fmaf(q4.z, L::elem(raw[u][m], e4 + 2), part);
              part = fmaf(q4.w, L::elem(raw[u][m], e4 + 3), part);
            }
          }
        }
        for (int off = 1; off < w.lpk; off <<= 1)
          part += __shfl_xor_sync(FULL_MASK, part, off);
        if (j < n && w.li == (qi & (w.lpk - 1))) {
          if constexpr (INT8)
            part *= ld((const T*)a.k_scale + ((size_t)b * a.S + k0 + j) * a.H + hd);
          ss[qi * a.per + j] = part + bb[j];
        }
      }
    }
  }
}

// p v over the split's n keys, QG queries at a time: each lane's sums,
// the warp's lane groups added by shuffles, the warps' parts in warp
// order: the sums, per query and column, to `put(qi, d, sum)`. `raw`
// holds the first pass's V rows, loaded by the caller.
template <class TK, class L, class Put>
__device__ void att_values(const AttnArgs& a, typename L::Raw (&raw)[ATT_U][L::MAXV],
                           const TK* vb, const float* ps, float* red, const Walk& w,
                           int n, Put put) {
  constexpr int QG = L::QG;
  const int dhp = att_width(a.dh), warp = threadIdx.x >> 5;
  const int qr = min(QG, a.Q);   // queries a warp's part in `red`
  for (int q0 = 0; q0 < a.Q; q0 += QG) {
    float acc[QG][L::MAXV][L::VW];
#pragma unroll
    for (int qq = 0; qq < QG; ++qq)
#pragma unroll
      for (int m = 0; m < L::MAXV; ++m)
#pragma unroll
        for (int e = 0; e < L::VW; ++e) acc[qq][m][e] = 0.f;
    for (int base = w.base0; base < n; base += w.gpb * ATT_U) {
      if (q0 != 0 || base != w.base0) load_rows<L>(raw, vb, a.E, w, base, n);
#pragma unroll
      for (int u = 0; u < ATT_U; ++u) {
        const int j = base + w.g + u * w.gpb;
        if (j >= n) continue;
        float pq[QG];
#pragma unroll
        for (int qq = 0; qq < QG; ++qq)
          pq[qq] = q0 + qq < a.Q ? ps[(q0 + qq) * a.per + j] : 0.f;
#pragma unroll
        for (int m = 0; m < L::MAXV; ++m) {
          const int vi = w.li + w.lpk * m;
          if (m >= w.vpl || vi >= w.nv) continue;
#pragma unroll
          for (int e = 0; e < L::VW; ++e) {
            const float x = L::elem(raw[u][m], e);
#pragma unroll
            for (int qq = 0; qq < QG; ++qq) acc[qq][m][e] = fmaf(pq[qq], x, acc[qq][m][e]);
          }
        }
      }
    }
    for (int off = w.lpk; off < 32; off <<= 1)
#pragma unroll
      for (int qq = 0; qq < QG; ++qq)
#pragma unroll
        for (int m = 0; m < L::MAXV; ++m)
#pragma unroll
          for (int e = 0; e < L::VW; ++e)
            acc[qq][m][e] += __shfl_xor_sync(FULL_MASK, acc[qq][m][e], off);
    const int nq = min(QG, a.Q - q0);
    if (w.g == 0) {
#pragma unroll
      for (int qq = 0; qq < QG; ++qq)
#pragma unroll
        for (int m = 0; m < L::MAXV; ++m) {
          const int vi = w.li + w.lpk * m;
          if (qq >= nq || m >= w.vpl || vi >= w.nv) continue;
#pragma unroll
          for (int e = 0; e < L::VW; ++e)
            red[(warp * qr + qq) * dhp + vi * L::VW + e] = acc[qq][m][e];
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nq * a.dh; idx += THREADS) {
      const int qq = idx / a.dh, d = idx % a.dh;
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < THREADS / 32; ++wi) sum += red[(wi * qr + qq) * dhp + d];
      put(q0 + qq, d, sum);
    }
    __syncthreads();
  }
}

// The probabilities of query qi over the split's n keys, from its fp32
// scores `sq` and the softmax's max M and sum L, into pq: rounded to q's
// dtype (int8: times the key's V scale, rounded again).
template <class T, class TK>
__device__ __forceinline__ void att_probs(const AttnArgs& a, const float* sq, float* pq,
                                          float M, float L, int b, int hd, int k0, int n) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < n; j += 32) {
    float p = round_to<T>(expf(sq[j] - M) / L);
    if constexpr (std::is_same<TK, int8_t>::value)
      p = round_to<T>(p * ld((const T*)a.v_scale + ((size_t)b * a.S + k0 + j) * a.H + hd));
    pq[j] = p;
  }
}

enum AttMode { ATT_SCORES = 0, ATT_VALUES = 1, ATT_ONE_SPLIT = 2 };

// grid (H, B, splits), THREADS threads, dynamic shared memory
// att_smem_floats(Q, dh, per) floats. ATT_SCORES: the split's scores to
// a.scores and its max and sum to a.stats. ATT_VALUES: the splits' max
// and sum merged, the split's probabilities and its p v to a.parts.
// ATT_ONE_SPLIT (splits = 1): all of it in shared memory, the output
// rounded to q's dtype. Each kernel requests its K or V rows first, so
// they are in flight while q, the scores or the statistics arrive.
template <class T, class TK, int VW, int MAXV, int MODE>
__global__ void __launch_bounds__(THREADS)
    attn_split_kernel(AttnArgs a) {
  using L = RowLanes<TK, VW, MAXV>;
  extern __shared__ __align__(16) float sm[];
  const int hd = blockIdx.x, b = blockIdx.y, z = blockIdx.z;
  const int k0 = z * a.per, n = min(a.per, a.S - k0);
  const int dhp = att_width(a.dh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* qs = sm;                                     // [Q][dhp]
  float* ss = qs + a.Q * dhp;                         // [Q][per]
  float* red = ss + a.Q * a.per;                      // [8][min(Q, ATT_QG)][dhp]
  const size_t bhq = ((size_t)b * a.H + hd) * a.Q;    // (b, hd, query 0)
  const size_t row0 = ((size_t)b * a.S + k0) * a.E + (size_t)hd * a.dh;
  const TK* kb = (const TK*)a.k + row0;
  const TK* vb = (const TK*)a.v + row0;
  const Walk w = walk_of(a.dh, VW);
  typename L::Raw raw[ATT_U][L::MAXV];
  if (MODE != ATT_VALUES) {
    load_rows<L>(raw, kb, a.E, w, w.base0, n);
    for (int e = threadIdx.x; e < a.Q * dhp; e += THREADS) {
      const int qi = e / dhp, d = e % dhp;
      qs[e] = d < a.dh ? ld((const T*)a.q + ((size_t)b * a.Q + qi) * a.E +
                            (size_t)hd * a.dh + d)
                       : 0.f;
    }
    __syncthreads();
    att_scores<T, TK, L>(a, raw, kb, qs, ss, w, b, hd, k0, n);
    __syncthreads();
    if (MODE == ATT_ONE_SPLIT) load_rows<L>(raw, vb, a.E, w, w.base0, n);
    // Each query's max and sum of exponentials over the split (lanes in
    // key order, then the warp's tree).
    for (int qi = warp; qi < a.Q; qi += THREADS / 32) {
      const float* sq = ss + qi * a.per;
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, sq[j]);
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < n; j += 32) l += expf(sq[j] - m);
      l = warp_sum(l);
      if (MODE == ATT_SCORES) {
        float* srow = a.scores + (bhq + qi) * a.S + k0;
        for (int j = lane; j < n; j += 32) srow[j] = sq[j];
        if (lane == 0) {
          a.stats[(bhq + qi) * a.splits + z] = m;
          a.stats[((size_t)a.B * a.H * a.Q + bhq + qi) * a.splits + z] = l;
        }
      } else {
        att_probs<T, TK>(a, sq, ss + qi * a.per, m, l, b, hd, k0, n);
      }
    }
    if (MODE == ATT_SCORES) return;
  } else {
    load_rows<L>(raw, vb, a.E, w, w.base0, n);
    // The splits' max and sum of each query, merged in a fixed order
    // (lanes in split order, then the warp's tree), and the split's
    // probabilities from its scores.
    // The split's scores are requested with the statistics (n <= 64: two
    // a lane), so the two arrive together.
    const size_t sl = (size_t)a.B * a.H * a.Q * a.splits;
    for (int qi = warp; qi < a.Q; qi += THREADS / 32) {
      const float* sg = a.scores + (bhq + qi) * a.S + k0;
      float* sq = ss + qi * a.per;
      for (int j = lane; j < n; j += 32) sq[j] = __ldcg(sg + j);
      const float* mz = a.stats + (bhq + qi) * a.splits;
      float M = -INFINITY;
      for (int zz = lane; zz < a.splits; zz += 32) M = fmaxf(M, mz[zz]);
      M = warp_max(M);
      float Ls = 0.f;
      for (int zz = lane; zz < a.splits; zz += 32) Ls += mz[sl + zz] * expf(mz[zz] - M);
      Ls = warp_sum(Ls);
      __syncwarp();
      att_probs<T, TK>(a, sq, sq, M, Ls, b, hd, k0, n);
    }
  }
  __syncthreads();
  if (MODE == ATT_VALUES) {
    float* part = a.parts + ((((size_t)b * a.H + hd) * a.splits + z) * a.Q) * a.dh;
    att_values<TK, L>(a, raw, vb, ss, red, w, n, [&](int qi, int d, float sum) {
      part[(size_t)qi * a.dh + d] = sum;
    });
  } else {
    T* ob = (T*)a.out + (size_t)b * a.Q * a.E + (size_t)hd * a.dh;
    att_values<TK, L>(a, raw, vb, ss, red, w, n, [&](int qi, int d, float sum) {
      ob[(size_t)qi * a.E + d] = store_as<T>(sum);
    });
  }
}

// out[b, q, h dh + d] = the splits' parts added in split order, rounded
// to q's dtype; a thread an output element.
template <class T>
__global__ void __launch_bounds__(THREADS) attn_combine_kernel(AttnArgs a) {
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (size_t)a.B * a.Q * a.E) return;
  const int col = (int)(i % a.E), qi = (int)(i / a.E % a.Q), b = (int)(i / a.E / a.Q);
  const int hd = col / a.dh, d = col % a.dh;
  const size_t stride = (size_t)a.Q * a.dh;
  const float* p = a.parts + ((((size_t)b * a.H + hd) * a.splits) * a.Q + qi) * a.dh + d;
  float sum = 0.f;
  for (int z = 0; z < a.splits; ++z) sum += p[z * stride];
  ((T*)a.out)[i] = store_as<T>(sum);
}

template <class T, class TK, int VW, int MAXV, int MODE>
cudaError_t launch_attn(const AttnArgs& a, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_split_kernel<T, TK, VW, MAXV, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  attn_split_kernel<T, TK, VW, MAXV, MODE><<<dim3(a.H, a.B, a.splits), THREADS, smem,
                                             stream>>>(a);
  return cudaGetLastError();
}

template <class T, class TK, int VW, int MAXV>
cudaError_t attn_run(const AttnArgs& a, int smem, cudaStream_t stream) {
  if (a.splits == 1) return launch_attn<T, TK, VW, MAXV, ATT_ONE_SPLIT>(a, smem, stream);
  cudaError_t err = launch_attn<T, TK, VW, MAXV, ATT_SCORES>(a, smem, stream);
  if (err != cudaSuccess) return err;
  err = launch_attn<T, TK, VW, MAXV, ATT_VALUES>(a, smem, stream);
  if (err != cudaSuccess) return err;
  const size_t n = (size_t)a.B * a.Q * a.E;
  attn_combine_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                           stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Entry points, typed.

// TB: the table's element type (T, or int8 with `scale`).
template <class T, class TB = T>
int band_generic(const void* x, const void* table, const void* scale, void* pmax,
                 void* psum, void* pval, void* pid, void* vals, void* ids,
                 void* lse, int N, int D, int V, int sel_limit, int k,
                 int tiles_per_chunk, int chunks, cudaStream_t stream) {
  if (N < 1 || D < 1 || V < 1 || k < 1 || k > BAND_MAX_K || k > sel_limit ||
      sel_limit > V || tiles_per_chunk < 1 || chunks < 1 ||
      chunks > BAND_MAX_CHUNKS || chunks > 65535 ||
      (long long)tiles_per_chunk * chunks < cdiv(V, TN) ||
      (long long)tiles_per_chunk * (chunks - 1) >= cdiv(V, TN))
    return (int)cudaErrorInvalidValue;
  const T* xt = (const T*)x;
  const TB* tt = (const TB*)table;
  if (N <= 16) {
    band_walk_kernel<T, 1, TB><<<dim3(cdiv(N, 16), chunks), THREADS, 0, stream>>>(
        xt, tt, (const T*)scale, (float*)pmax, (float*)psum, (float*)pval,
        (int*)pid, N, D, V, sel_limit, k, tiles_per_chunk, chunks);
  } else {
    band_walk_kernel<T, 2, TB><<<dim3(cdiv(N, 32), chunks), THREADS, 0, stream>>>(
        xt, tt, (const T*)scale, (float*)pmax, (float*)psum, (float*)pval,
        (int*)pid, N, D, V, sel_limit, k, tiles_per_chunk, chunks);
  }
  NIC_RETURN_IF_LAUNCH_FAILED();
  band_merge_kernel<<<cdiv(N, THREADS / 32), THREADS, 0, stream>>>(
      (const float*)pmax, (const float*)psum, (const float*)pval,
      (const int*)pid, (float*)vals, (int*)ids, (float*)lse, N, k, chunks);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// TK: K's and V's element type (T, or int8 with the two scales).
template <class T, class TK = T>
int attention_generic(AttnArgs a, int smem, cudaStream_t stream) {
  if (a.B < 1 || a.Q < 1 || a.Q > ATT_MAX_Q || a.S < 1 || a.H < 1 || a.E % a.H != 0 ||
      a.E / a.H > ATT_MAX_HEAD || a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  a.dh = a.E / a.H;
  int splits, per;
  att_plan(a.S, splits, per);
  const bool split = splits > 1;
  if (a.splits != splits || a.per != per || splits > 65535 ||
      smem != att_smem_floats(a.Q, a.dh, per) * (int)sizeof(float) ||
      smem > MAX_SMEM_BYTES ||
      split != (a.scores != nullptr && a.stats != nullptr && a.parts != nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte loads where every key row of a head starts 16-byte aligned
  // (two a lane for fp32 heads past 128), else one element.
  constexpr int VW = 16 / (int)sizeof(TK);
  const bool vec = ((uintptr_t)a.k | (uintptr_t)a.v) % 16 == 0 &&
                   (a.dh * sizeof(TK)) % 16 == 0 && (a.E * sizeof(TK)) % 16 == 0;
  if (!vec) return (int)attn_run<T, TK, 1, 8>(a, smem, stream);
  if constexpr (VW == 4) {
    if (a.dh > 32 * VW) return (int)attn_run<T, TK, VW, 2>(a, smem, stream);
  }
  return (int)attn_run<T, TK, VW, 1>(a, smem, stream);
}

template <class T>
int ffn_generic(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, void* h, void* part, void* counters, void* y,
                void* sums, int N, int C, int F, int tile1, int ksplit1, int tile2,
                int ksplit2, cudaStream_t stream) {
  if (N < 1 || C < 1 || F < 1 || (b2 == nullptr) != (sums != nullptr))
    return (int)cudaErrorInvalidValue;
  ProdArgs fc1{x, w1, b1, nullptr, h, (float*)part, (unsigned*)counters,
               N, C, C, F, F, 0, 0, EPI_RELU};
  cudaError_t err = run_product<T>(fc1, tile1, ksplit1, stream);
  if (err != cudaSuccess) return (int)err;
  ProdArgs fc2{h, w2, b2, x, b2 == nullptr ? sums : y, (float*)part, (unsigned*)counters,
               N, F, F, C, C, 0, 0, b2 == nullptr ? EPI_SUM : EPI_RESID};
  return (int)run_product<T>(fc2, tile2, ksplit2, stream);
}

template <class T>
int conv_generic(const void* x, const void* cache, const void* pos, const void* w1,
                 const void* b1, const void* wl, const void* w2, const void* b2,
                 void* h, void* logits, void* hconv, void* part, void* counters,
                 void* y, int N, int C, int H, int K, int t, int tile1, int ksplit1,
                 int tile_t, int ksplit_t, int tile2, int ksplit2, cudaStream_t stream) {
  if (N < 1 || C < 1 || H < 1 || C % H != 0 || K < 1 || K > MAX_TAPS ||
      (pos == nullptr && t < 0) || (K > 1 && cache == nullptr))
    return (int)cudaErrorInvalidValue;
  ProdArgs lin1{x, w1, b1, nullptr, h, (float*)part, (unsigned*)counters,
                N, C, C, 2 * C, C, 0, 0, EPI_GLU};
  cudaError_t err = run_product<T>(lin1, tile1, ksplit1, stream);
  if (err != cudaSuccess) return (int)err;
  ProdArgs taps{h, wl, nullptr, nullptr, logits, (float*)part, (unsigned*)counters,
                N, C, C, H * K, H * K, 0, 0, EPI_LOGIT};
  err = run_product<T>(taps, tile_t, ksplit_t, stream);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)cdiv(C, MIX_THREADS) * N;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  conv_mix_kernel<T><<<(unsigned)blocks, MIX_THREADS, 0, stream>>>(
      (const T*)h, (const float*)logits, (const T*)cache, (const int*)pos, t,
      (T*)hconv, N, C, H, K);
  NIC_RETURN_IF_LAUNCH_FAILED();
  ProdArgs lin2{hconv, w2, b2, x, y, (float*)part, (unsigned*)counters,
                N, C, C, C, C, 0, 0, EPI_RESID};
  return (int)run_product<T>(lin2, tile2, ksplit2, stream);
}

}  // namespace gen
}  // namespace nic

// Dtype codes of the generic entry points: 0 bf16, 1 fp32.
#define NIC_GENERIC_DISPATCH(fn, ...)                               \
  do {                                                              \
    if (dtype == 0) return nic::gen::fn<nic::bf16>(__VA_ARGS__);    \
    if (dtype == 1) return nic::gen::fn<float>(__VA_ARGS__);        \
    return (int)cudaErrorInvalidValue;                              \
  } while (0)
// The same for the int8 variants: x or q of the dtype, an int8 table or
// int8 K and V.
#define NIC_GENERIC_INT8_DISPATCH(fn, ...)                                   \
  do {                                                                       \
    if (dtype == 0) return nic::gen::fn<nic::bf16, int8_t>(__VA_ARGS__);     \
    if (dtype == 1) return nic::gen::fn<float, int8_t>(__VA_ARGS__);         \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

// vals [N, k] fp32 logits (rounded to the dtype), ids [N, k] int32, lse
// [N] fp32 of x [N, D] @ table [V, D]^T, any D and V, 1 <= k <= 16,
// k <= sel_limit <= V. The vocab's 64-id tiles go `tiles_per_chunk` a
// chunk to `chunks` (<= 1024) blocks a row tile, none empty. Scratch:
// pmax, psum [N, chunks] fp32, pval [N, chunks, k] fp32, pid
// [N, chunks, k] int32. Returns a cudaError_t.
extern "C" int nic_band_topk_lse_generic(int dtype, const void* x,
                                         const void* table, void* pmax,
                                         void* psum, void* pval, void* pid,
                                         void* vals, void* ids, void* lse,
                                         int N, int D, int V, int sel_limit,
                                         int k, int tiles_per_chunk,
                                         int chunks, void* stream) {
  NIC_GENERIC_DISPATCH(band_generic, x, table, nullptr, pmax, psum, pval,
                                    pid, vals, ids, lse, N, D, V, sel_limit, k,
                                    tiles_per_chunk, chunks,
                                    (cudaStream_t)stream);
}

// out [B, Q, E] = softmax(q_h k_h^T + bias) v_h per head h of E / H <=
// 256 lanes; q [B, Q, E], k, v [B, S, E] of the dtype, bias [B, S] fp32,
// Q <= 16. `splits` and `per` are att_plan(S)'s, `smem` is
// att_smem_floats(Q, E / H, per) * 4. Scratch where splits > 1 (null
// otherwise): scores [B, H, Q, S], stats [2, B, H, Q, splits], parts
// [B, H, splits, Q, E / H], fp32. Returns a cudaError_t.
extern "C" int nic_decode_attention_generic(int dtype, const void* q,
                                            const void* k, const void* v,
                                            const void* bias, void* scores,
                                            void* stats, void* parts, void* out,
                                            int B, int Q, int S, int E, int H,
                                            int splits, int per, int smem,
                                            void* stream) {
  const nic::gen::AttnArgs a{q, k, v, nullptr, nullptr, (const float*)bias, out,
                             (float*)scores, (float*)stats, (float*)parts,
                             B, Q, S, E, H, 0, splits, per};
  NIC_GENERIC_DISPATCH(attention_generic, a, smem, (cudaStream_t)stream);
}

// y [N, C] = r(r(r(h w2) + b2) + x), h = relu(r(r(x w1) + b1)) written
// to h [N, F]; with b2 null, the fp32 sums h w2 to sums [N, C] instead
// (y not written). w1 [C, F], b1 [F], w2 [F, C], b2 [C]. fc1 and fc2 run
// as products of tile codes tile1, tile2 (ops/decode_blocks.py::
// GENERIC_TILES) with ksplit1, ksplit2 of the depth a block (multiples of
// 32); where one splits its depth, part holds the splits' fp32 tiles and
// counters (PROD_MAX_COUNTERS, zero) their arrivals
// (ops/decode_blocks.py::generic_product_plan). Returns a cudaError_t.
extern "C" int nic_decode_ffn_block_generic(int dtype, const void* x,
                                            const void* w1, const void* b1,
                                            const void* w2, const void* b2,
                                            void* h, void* part, void* counters,
                                            void* y, void* sums, int N, int C,
                                            int F, int tile1, int ksplit1,
                                            int tile2, int ksplit2, void* stream) {
  NIC_GENERIC_DISPATCH(ffn_generic, x, w1, b1, w2, b2, h, part, counters, y, sums,
                       N, C, F, tile1, ksplit1, tile2, ksplit2, (cudaStream_t)stream);
}

// y, h = the conv block step for N rows: x [N, C]; cache [K - 1, N, C]
// ring-major (not read at K = 1, may be null then); pos null (every row
// at step t >= 0) or int32 [N], each row's position; w1 [C, 2C], b1
// [2C], wl [C, H K] the tap predictor (head-major), w2 [C, C], b2 [C];
// 1 <= K <= 32. Scratch: logits [N, H K] fp32 (the tap logits, rounded
// to the dtype), hconv [N, C]; part and counters as the FFN's, for
// linear1 (tile1, ksplit1), the tap logits (tile_t, ksplit_t) and
// linear2 (tile2, ksplit2). Returns a cudaError_t.
extern "C" int nic_decode_conv_block_generic(
    int dtype, const void* x, const void* cache, const void* pos, const void* w1,
    const void* b1, const void* wl, const void* w2, const void* b2, void* h,
    void* logits, void* hconv, void* part, void* counters, void* y, int N, int C,
    int H, int K, int t, int tile1, int ksplit1, int tile_t, int ksplit_t,
    int tile2, int ksplit2, void* stream) {
  NIC_GENERIC_DISPATCH(conv_generic, x, cache, pos, w1, b1, wl, w2, b2, h, logits,
                       hconv, part, counters, y, N, C, H, K, t, tile1, ksplit1,
                       tile_t, ksplit_t, tile2, ksplit2, (cudaStream_t)stream);
}

NIC_DEFINE_PHASE_SUMS_READER(nic_decode_generic_sums)

// band_topk_lse's generic variant over an int8 table [V, D] with one
// scale a row [V] of x's dtype: a logit is the fp32 sum x . table[v]
// times scale[v], rounded once to x's dtype. Everything else as
// nic_band_topk_lse_generic. Returns a cudaError_t.
extern "C" int nic_band_topk_lse_int8_generic(int dtype, const void* x,
                                              const void* table_q,
                                              const void* scale, void* pmax,
                                              void* psum, void* pval, void* pid,
                                              void* vals, void* ids, void* lse,
                                              int N, int D, int V, int sel_limit,
                                              int k, int tiles_per_chunk,
                                              int chunks, void* stream) {
  NIC_GENERIC_INT8_DISPATCH(band_generic, x, table_q, scale, pmax, psum, pval,
                            pid, vals, ids, lse, N, D, V, sel_limit, k,
                            tiles_per_chunk, chunks, (cudaStream_t)stream);
}

// decode_cross_attention's generic variant over int8 k_q, v_q [B, S, E]
// with one scale a key and head, k_scale and v_scale [B, S, H] of q's
// dtype: scores (q . k_q) * k_scale + bias and the softmax in fp32,
// probabilities rounded to q's dtype, times v_scale, rounded again, the
// value sums in fp32. Everything else as nic_decode_attention_generic.
// Returns a cudaError_t.
extern "C" int nic_decode_attention_int8_generic(int dtype, const void* q,
                                                 const void* k_q,
                                                 const void* k_scale,
                                                 const void* v_q,
                                                 const void* v_scale,
                                                 const void* bias, void* scores,
                                                 void* stats, void* parts,
                                                 void* out, int B, int Q, int S,
                                                 int E, int H, int splits,
                                                 int per, int smem, void* stream) {
  const nic::gen::AttnArgs a{q, k_q, v_q, k_scale, v_scale, (const float*)bias, out,
                             (float*)scores, (float*)stats, (float*)parts,
                             B, Q, S, E, H, 0, splits, per};
  NIC_GENERIC_INT8_DISPATCH(attention_generic, a, smem, (cudaStream_t)stream);
}
