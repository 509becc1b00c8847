// Fused top-k + logsumexp of the logits x @ table^T of one adaptive
// softmax band, without writing the [N, V] logits to device memory.
// Logits are rounded to bf16 (the reference's rounding point); the
// logsumexp covers every row of the table, the top-k only ids below
// sel_limit, with ties to the lowest id (the lax.top_k rule).
//
// Replaces: news_image_caption_tpu/ops/pallas_topk.py band_topk_lse
// (_band_kernel, _tile_topk, _merge_topk).
//
// What bounds it on the card: one read of the band's table, 5002 /
// 15000 / 30265 rows x 1024 x bf16 (10 / 31 / 62 MB), against
// 2 * N * V * D flops: device-memory bytes at decode batch sizes.
//
// Design: the TPU kernel walks the vocab tiles in order and carries
// (max, sumexp, top-k) in scratch. Hopper blocks run in parallel, so
// this is two passes: band_partial computes, per (row block, 64-column
// vocab tile), the tile's logits in shared memory and writes per row
// the tile max, the tile sumexp relative to it and the tile's top-k;
// band_merge then folds the partials of one row into the logsumexp and
// the global top-k. The ragged last tile is masked: columns >= V are
// -inf and join nothing, columns in [sel_limit, V) join only the
// logsumexp.

#include "common.cuh"

namespace nic {

using BandTile = Tile<16, 64, 32, 4, 4>;  // 64 threads: 16 rows x 64 vocab ids
constexpr int BAND_MAX_K = 16;
constexpr int MERGE_THREADS = 128;
static_assert(BandTile::BN == 64, "band_partial gives each lane two columns");

// grid = (n_tiles, cdiv(N, BM)). Partials are [N, n_tiles] (max, sum)
// and [N, n_tiles, k] (values, ids).
__global__ void __launch_bounds__(BandTile::THREADS)
band_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ table,
                    float* __restrict__ pmax, float* __restrict__ psum,
                    float* __restrict__ pval, int* __restrict__ pid, int N,
                    int D, int V, int sel_limit, int k, int n_tiles) {
  using T = BandTile;
  __shared__ float smem[T::SMEM_FLOATS];
  __shared__ float logits[T::BM][T::BN + 1];
  const int tile = blockIdx.x, m0 = blockIdx.y * T::BM, v0 = tile * T::BN;
  float acc[T::TM][T::TN] = {};
  block_matmul<T, false>(
      acc, D,
      [&](int m, int d) {
        return (m0 + m < N && d < D) ? to_f(x[(size_t)(m0 + m) * D + d]) : 0.f;
      },
      [&](int d, int n) {
        return (d < D && v0 + n < V) ? to_f(table[(size_t)(v0 + n) * D + d]) : 0.f;
      },
      smem);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int n = tile_col<T>(j);
      logits[tile_row<T>(i)][n] = v0 + n < V ? rbf(acc[i][j]) : -INFINITY;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int m = warp; m < T::BM; m += T::THREADS / 32) {
    const int row = m0 + m;
    if (row >= N) break;  // uniform across the warp
    const int id0 = v0 + lane, id1 = v0 + lane + 32;
    const float l0 = logits[m][lane], l1 = logits[m][lane + 32];
    const float mx = warp_max(fmaxf(l0, l1));
    const float safe = mx == -INFINITY ? 0.f : mx;
    const float s = warp_sum(expf(l0 - safe) + expf(l1 - safe));
    const size_t o = (size_t)row * n_tiles + tile;
    if (lane == 0) {
      pmax[o] = mx;
      psum[o] = s;
    }
    float s0 = id0 < sel_limit ? l0 : -INFINITY;
    float s1 = id1 < sel_limit ? l1 : -INFINITY;
    for (int r = 0; r < k; ++r) {
      float bv = s0;
      int bi = id0;
      if (s1 > s0) {
        bv = s1;
        bi = id1;
      }
      if (bv == -INFINITY) bi = BIG_ID;
      warp_argmax(bv, bi);
      if (lane == 0) {
        pval[o * k + r] = bv;
        pid[o * k + r] = bi;
      }
      if (bi == id0) s0 = -INFINITY;
      if (bi == id1) s1 = -INFINITY;
    }
  }
}

// grid = N, MERGE_THREADS threads: one row's logsumexp and top-k.
__global__ void __launch_bounds__(MERGE_THREADS)
band_merge_kernel(const float* __restrict__ pmax, const float* __restrict__ psum,
                  const float* __restrict__ pval, const int* __restrict__ pid,
                  float* __restrict__ out_val, int* __restrict__ out_id,
                  float* __restrict__ lse, int n_tiles, int k) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int chosen[BAND_MAX_K];
  const int row = blockIdx.x, tid = threadIdx.x;
  const float* pm = pmax + (size_t)row * n_tiles;
  const float* ps = psum + (size_t)row * n_tiles;

  float mx = -INFINITY;
  for (int t = tid; t < n_tiles; t += MERGE_THREADS) mx = fmaxf(mx, pm[t]);
  mx = block_max(mx, red_v);
  const float safe = mx == -INFINITY ? 0.f : mx;
  float s = 0.f;
  for (int t = tid; t < n_tiles; t += MERGE_THREADS) {
    if (pm[t] != -INFINITY) s += ps[t] * expf(pm[t] - safe);
  }
  s = block_sum(s, red_v);
  if (tid == 0) lse[row] = mx == -INFINITY ? -INFINITY : mx + logf(fmaxf(s, 1e-38f));

  const int n_cand = n_tiles * k;
  const float* cv = pval + (size_t)row * n_cand;
  const int* ci = pid + (size_t)row * n_cand;
  for (int r = 0; r < k; ++r) {
    float bv = -INFINITY;
    int bi = BIG_ID;
    for (int j = tid; j < n_cand; j += MERGE_THREADS) {
      const float v = cv[j];
      const int id = ci[j];
      bool taken = false;
      for (int q = 0; q < r; ++q) taken |= chosen[q] == id;
      if (!taken && (v > bv || (v == bv && id < bi))) {
        bv = v;
        bi = id;
      }
    }
    block_argmax(bv, bi, red_v, red_i);
    if (tid == 0) {
      out_val[(size_t)row * k + r] = bv;
      out_id[(size_t)row * k + r] = bi;
      chosen[r] = bi;
    }
    __syncthreads();
  }
}

}  // namespace nic

extern "C" int nic_band_topk_tile_cols() { return nic::BandTile::BN; }

// vals [N, k] fp32 logits, ids [N, k] int32, lse [N] fp32 of
// x [N, D] @ table [V, D]^T (bf16). pmax/psum [N, n_tiles] and
// pval/pid [N, n_tiles, k] are scratch, n_tiles = cdiv(V, 64).
// Returns a cudaError_t.
extern "C" int nic_band_topk_lse(const void* x, const void* table,
                                 void* pmax, void* psum, void* pval,
                                 void* pid, void* vals, void* ids, void* lse,
                                 int N, int D, int V, int sel_limit, int k,
                                 int n_tiles, void* stream) {
  using nic::BandTile;
  if (k < 1 || k > nic::BAND_MAX_K || k > sel_limit || sel_limit > V ||
      n_tiles != nic::cdiv(V, BandTile::BN))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  nic::band_partial_kernel<<<dim3(n_tiles, nic::cdiv(N, BandTile::BM)),
                             BandTile::THREADS, 0, s>>>(
      (const nic::bf16*)x, (const nic::bf16*)table, (float*)pmax,
      (float*)psum, (float*)pval, (int*)pid, N, D, V, sel_limit, k, n_tiles);
  NIC_RETURN_IF_LAUNCH_FAILED();
  nic::band_merge_kernel<<<N, nic::MERGE_THREADS, 0, s>>>(
      (const float*)pmax, (const float*)psum, (const float*)pval,
      (const int*)pid, (float*)vals, (int*)ids, (float*)lse, n_tiles, k);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

extern "C" const char* nic_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
