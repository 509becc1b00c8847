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
// The design aims at a simple kernel that is right:
//   - The products are one tile routine, `tile_gemm`: a block of 256
//     threads computes a [16 or 32 rows] x [64 columns] tile over a
//     range of the depth, 32 deep at a time through shared memory (the
//     next chunk's loads in registers while the current one is
//     multiplied), each thread 1 or 2 rows x 4 columns in fp32.
//   - The TPU kernels carry an fp32 accumulator over a sequential grid;
//     blocks of the card run side by side, so the FFN's and the conv
//     block's products split their depth over blocks where a call has
//     few tiles (the decode's N <= 16 rows make one row tile), each
//     split writing fp32 partial sums that a second kernel adds in split
//     order before the epilogue. Every sum has a fixed order: two calls
//     on the same inputs give the same bits.
//   - The FFN is two such products (fc1 with its epilogue writes h to
//     device memory in the working dtype, exactly as rounded; fc2 with
//     the residual); the conv block is linear1 with the GLU in its
//     epilogue, one kernel for the taps, their softmax and the ring
//     combine a head and 8 rows, then linear2 with the residual.
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
// and attention run one to five kernels in it, as band_topk.cu's two).

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
constexpr int MIX_ROWS = 8;     // rows a conv mix block
constexpr int MIX_CC = 64;      // channels a chunk of the tap product
constexpr int MAX_TAPS = 32;

enum Epi { EPI_RELU = 0, EPI_RESID = 1, EPI_SUM = 2, EPI_GLU = 3 };

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
// Products with an epilogue: FFN fc1 and fc2, conv block linear1 and linear2.

template <class T>
struct GemmArgs {
  const T* A;       // [M, lda]
  const T* B;       // [K, ldb]
  const T* bias;    // [NB * Ncols]
  const T* resid;   // [M, Ncols] (EPI_RESID)
  T* out;           // [M, Ncols]
  float* out32;     // [M, Ncols] (EPI_SUM)
  float* part;      // [splits, M, NB * Ncols] fp32, where splits > 1
  int M, K, lda, ldb, Ncols, ksplit, splits;
};

template <class T, int EPI>
__device__ __forceinline__ void epilogue(const GemmArgs<T>& a, int m, int n,
                                         float s0, float s1) {
  const size_t at = (size_t)m * a.Ncols + n;
  if (EPI == EPI_RELU) {
    a.out[at] = store_as<T>(fmaxf(round_to<T>(round_to<T>(s0) + ld(a.bias + n)), 0.f));
  } else if (EPI == EPI_RESID) {
    a.out[at] = store_as<T>(round_to<T>(
        round_to<T>(round_to<T>(s0) + ld(a.bias + n)) + ld(a.resid + at)));
  } else if (EPI == EPI_SUM) {
    a.out32[at] = s0;
  } else {   // EPI_GLU: a = columns [0, C), g = [C, 2C) of linear1
    const float av = round_to<T>(round_to<T>(s0) + ld(a.bias + n));
    const float gv = round_to<T>(round_to<T>(s1) + ld(a.bias + a.Ncols + n));
    const float sig = round_to<T>(1.f / (1.f + expf(-gv)));
    a.out[at] = store_as<T>(round_to<T>(av * sig));
  }
}

// Grid (row tiles, column tiles, splits). With one split the block
// applies the epilogue; otherwise it writes its fp32 partial sums.
template <class T, int EPI, int RPT>
__global__ void __launch_bounds__(THREADS) gemm_kernel(GemmArgs<T> a) {
  constexpr int NB = EPI == EPI_GLU ? 2 : 1;
  __shared__ __align__(16) float smem[tile_smem_floats<RPT, NB>()];
  const int m0 = blockIdx.x * 16 * RPT, n0 = blockIdx.y * TN;
  const int k0 = blockIdx.z * a.ksplit, k1 = min(a.K, k0 + a.ksplit);
  float acc[NB][RPT][4] = {};
  tile_gemm<T, false, RPT, NB>(a.A, a.lda, a.M, m0, a.B, a.ldb, a.Ncols, n0,
                               a.Ncols, k0, k1, acc, smem);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= a.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 4 * tx + j;
      if (n >= a.Ncols) continue;
      if (a.splits == 1) {
        epilogue<T, EPI>(a, m, n, acc[0][i][j], acc[NB - 1][i][j]);
      } else {
#pragma unroll
        for (int g = 0; g < NB; ++g)
          a.part[((size_t)blockIdx.z * a.M + m) * (NB * a.Ncols) +
                 g * a.Ncols + n] = acc[g][i][j];
      }
    }
  }
}

// The splits' partial sums added in split order, then the epilogue.
template <class T, int EPI>
__global__ void __launch_bounds__(THREADS) split_epilogue_kernel(GemmArgs<T> a) {
  constexpr int NB = EPI == EPI_GLU ? 2 : 1;
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (size_t)a.M * a.Ncols) return;
  const int m = (int)(e / a.Ncols), n = (int)(e % a.Ncols);
  float s[NB] = {};
  for (int z = 0; z < a.splits; ++z)
#pragma unroll
    for (int g = 0; g < NB; ++g)
      s[g] += a.part[((size_t)z * a.M + m) * (NB * a.Ncols) + g * a.Ncols + n];
  epilogue<T, EPI>(a, m, n, s[0], s[NB - 1]);
}

template <class T, int EPI, int RPT>
cudaError_t run_gemm_rpt(const GemmArgs<T>& a, cudaStream_t stream) {
  const dim3 grid(cdiv(a.M, 16 * RPT), cdiv(a.Ncols, TN), a.splits);
  gemm_kernel<T, EPI, RPT><<<grid, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const size_t n = (size_t)a.M * a.Ncols;
  split_epilogue_kernel<T, EPI><<<(unsigned)((n + THREADS - 1) / THREADS),
                                  THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <class T, int EPI>
cudaError_t run_gemm(GemmArgs<T> a, cudaStream_t stream) {
  if (a.M < 1 || a.K < 1 || a.Ncols < 1 || a.ksplit < KC || a.ksplit % KC != 0)
    return cudaErrorInvalidValue;
  a.splits = cdiv(a.K, a.ksplit);
  if (a.splits > 65535 || (a.splits > 1 && a.part == nullptr))
    return cudaErrorInvalidValue;
  return a.M <= 16 ? run_gemm_rpt<T, EPI, 1>(a, stream)
                   : run_gemm_rpt<T, EPI, 2>(a, stream);
}

// ---------------------------------------------------------------------------
// The conv block's taps, softmax and ring combine, for MIX_ROWS rows of
// one head a block: grid (row tiles, heads).
//   logits[r][k] = r(h[n] . taps[hd][k]), p = r(softmax_k(logits)),
//   acc = sum_{k < K-1} p[k] * cache[(pos_n + k) mod (K-1)][n][c] (fp32),
//   hconv[n][c] = r(r(acc) + r(p[K-1] * h[n][c])) for the head's channels.
template <class T>
__global__ void __launch_bounds__(THREADS)
    conv_mix_kernel(const T* __restrict__ h, const T* __restrict__ taps,
                    const T* __restrict__ cache, const int* __restrict__ pos,
                    int t, T* __restrict__ hconv, int N, int C, int H, int K,
                    int kp) {
  __shared__ float hs[MIX_ROWS][MIX_CC + 1];
  __shared__ float ts[MAX_TAPS][MIX_CC + 1];
  __shared__ float ps[MIX_ROWS][MAX_TAPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * MIX_ROWS, hd = blockIdx.y, R = C / H;
  const T* th = taps + (size_t)hd * kp * C;
  // Thread (row warp, tap lane) sums its logit over the channels.
  float logit = 0.f;
  for (int c0 = 0; c0 < C; c0 += MIX_CC) {
    __syncthreads();
    for (int e = tid; e < MIX_ROWS * MIX_CC; e += THREADS) {
      const int r = e / MIX_CC, c = c0 + e % MIX_CC;
      hs[r][e % MIX_CC] = (n0 + r < N && c < C) ? ld(h + (size_t)(n0 + r) * C + c) : 0.f;
    }
    for (int e = tid; e < K * MIX_CC; e += THREADS) {
      const int k = e / MIX_CC, c = c0 + e % MIX_CC;
      ts[k][e % MIX_CC] = c < C ? ld(th + (size_t)k * C + c) : 0.f;
    }
    __syncthreads();
    if (lane < K) {
#pragma unroll 8
      for (int c = 0; c < MIX_CC; ++c) logit = fmaf(hs[warp][c], ts[lane][c], logit);
    }
  }
  // Softmax over the K taps of row `warp`, at the reference's rounding
  // points: the logit rounded, the probability rounded.
  const float v = lane < K ? round_to<T>(logit) : -INFINITY;
  const float mx = warp_max(v);
  const float ex = lane < K ? expf(v - mx) : 0.f;
  const float sum = warp_sum(ex);
  ps[warp][lane] = lane < K ? round_to<T>(ex / sum) : 0.f;
  __syncthreads();
  const int Km1 = K - 1;
  for (int e = tid; e < MIX_ROWS * R; e += THREADS) {
    const int r = e / R, n = n0 + r;
    if (n >= N) continue;
    const int c = hd * R + e % R;
    float acc = 0.f;
    if (Km1 > 0) {
      const int p = pos != nullptr ? pos[n] : t;
#pragma unroll 8
      for (int k = 0; k < Km1; ++k)
        acc = fmaf(ps[r][k], ld(cache + ((size_t)((p + k) % Km1) * N + n) * C + c), acc);
    }
    const float cur = round_to<T>(ps[r][Km1] * ld(h + (size_t)n * C + c));
    hconv[(size_t)n * C + c] = store_as<T>(round_to<T>(round_to<T>(acc) + cur));
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
                const void* b2, void* h, void* part, void* y, void* sums, int N,
                int C, int F, int ksplit1, int ksplit2, cudaStream_t stream) {
  if (N < 1 || C < 1 || F < 1 || (b2 == nullptr) != (sums != nullptr))
    return (int)cudaErrorInvalidValue;
  GemmArgs<T> fc1 = {(const T*)x, (const T*)w1, (const T*)b1, nullptr,
                     (T*)h, nullptr, (float*)part, N, C, C, F, F, ksplit1, 1};
  cudaError_t err = run_gemm<T, EPI_RELU>(fc1, stream);
  if (err != cudaSuccess) return (int)err;
  GemmArgs<T> fc2 = {(const T*)h, (const T*)w2, (const T*)b2, (const T*)x,
                     (T*)y, (float*)sums, (float*)part, N, F, F, C, C, ksplit2, 1};
  err = b2 == nullptr ? run_gemm<T, EPI_SUM>(fc2, stream)
                      : run_gemm<T, EPI_RESID>(fc2, stream);
  return (int)err;
}

template <class T>
int conv_generic(const void* x, const void* cache, const void* pos,
                 const void* w1, const void* b1, const void* taps,
                 const void* w2, const void* b2, void* h, void* hconv,
                 void* part, void* y, int N, int C, int H, int K, int kp, int t,
                 int ksplit1, int ksplit2, cudaStream_t stream) {
  if (N < 1 || C < 1 || H < 1 || C % H != 0 || K < 1 || K > MAX_TAPS ||
      kp < K || (pos == nullptr && t < 0) || N > 65535 * MIX_ROWS || H > 65535 ||
      (K > 1 && cache == nullptr))
    return (int)cudaErrorInvalidValue;
  GemmArgs<T> lin1 = {(const T*)x, (const T*)w1, (const T*)b1, nullptr,
                      (T*)h, nullptr, (float*)part, N, C, C, 2 * C, C, ksplit1, 1};
  cudaError_t err = run_gemm<T, EPI_GLU>(lin1, stream);
  if (err != cudaSuccess) return (int)err;
  conv_mix_kernel<T><<<dim3(cdiv(N, MIX_ROWS), H), THREADS, 0, stream>>>(
      (const T*)h, (const T*)taps, (const T*)cache, (const int*)pos, t,
      (T*)hconv, N, C, H, K, kp);
  NIC_RETURN_IF_LAUNCH_FAILED();
  GemmArgs<T> lin2 = {(const T*)hconv, (const T*)w2, (const T*)b2, (const T*)x,
                      (T*)y, nullptr, (float*)part, N, C, C, C, C, ksplit2, 1};
  return (int)run_gemm<T, EPI_RESID>(lin2, stream);
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
// (y not written). w1 [C, F], b1 [F], w2 [F, C], b2 [C]. ksplit1 and
// ksplit2: the depth a block of fc1 and fc2 (multiples of 32); where one
// is below C or F, part holds the splits' fp32 sums
// (cdiv(depth, ksplit) * N * width floats). Returns a cudaError_t.
extern "C" int nic_decode_ffn_block_generic(int dtype, const void* x,
                                            const void* w1, const void* b1,
                                            const void* w2, const void* b2,
                                            void* h, void* part, void* y,
                                            void* sums, int N, int C, int F,
                                            int ksplit1, int ksplit2,
                                            void* stream) {
  NIC_GENERIC_DISPATCH(ffn_generic, x, w1, b1, w2, b2, h, part, y, sums, N, C,
                                   F, ksplit1, ksplit2, (cudaStream_t)stream);
}

// y, h = the conv block step for N rows: x [N, C]; cache [K - 1, N, C]
// ring-major (not read at K = 1, may be null then); pos null (every row
// at step t >= 0) or int32 [N], each row's position; w1 [C, 2C], b1
// [2C], taps [H, kp, C] (ops/decode_blocks.py::pack_taps), w2 [C, C],
// b2 [C]; 1 <= K <= 32. Scratch: hconv [N, C]; part as the FFN's for
// linear1 (width 2C) and linear2 (width C). Returns a cudaError_t.
extern "C" int nic_decode_conv_block_generic(int dtype, const void* x,
                                             const void* cache,
                                             const void* pos, const void* w1,
                                             const void* b1, const void* taps,
                                             const void* w2, const void* b2,
                                             void* h, void* hconv, void* part,
                                             void* y, int N, int C, int H,
                                             int K, int kp, int t, int ksplit1,
                                             int ksplit2, void* stream) {
  NIC_GENERIC_DISPATCH(conv_generic, x, cache, pos, w1, b1, taps, w2, b2, h,
                                    hconv, part, y, N, C, H, K, kp, t, ksplit1,
                                    ksplit2, (cudaStream_t)stream);
}

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
