// The conv block of a decode step of the dynamic-conv decoder layer,
// for one new token per row: linear1 -> GLU -> tap softmax -> ring
// combine -> linear2 + residual. (The layer's FFN block has its own
// source, decode_ffn.cu.)
//
// Replaces: news_image_caption_tpu/ops/pallas_decode.py
// decode_conv_block (_conv_block_kernel).
//
// What bounds it on the card: at decode batch N = 1..16 every weight
// is read once per step and used N times, so the block is bound by
// reading w1, w2 and the tap predictor from device memory: about
// 6.5 MB of bf16 per layer at d = 1024.
//
// Design: Hopper blocks run in no order, so each row product is a
// split-K launch (mm_split_kernel: at N = 16 the output has only 16-32
// tiles of 16 x 64, so K is cut into chunks to put about two blocks
// per SM on the card, every weight element still read once) writing
// fp32 partials, and an elementwise epilogue sums the partials in a
// fixed order and applies the bias, the activation and the residual:
//   linear1 split -> glu_epilogue -> conv_taps (per head: tap logits,
//   softmax, ring combine) -> linear2 split -> bias_residual_epilogue.
// The bf16 rounding points are those of the reference kernel
// (pallas_decode.py:47-101). The products go through `block_matmul`
// (common.cuh), which keeps little in flight: the kernel is bound by
// memory latency, far from the bound above.

#include "common.cuh"

namespace nic {

using RowTile = Tile<16, 64, 32, 4, 4>;  // 64 threads: 16 rows x 64 columns
using TapTile = Tile<16, 32, 32, 2, 2>;  // 128 threads: 16 rows x 32 taps
constexpr int MAX_TAPS = TapTile::BN;
constexpr int EPILOGUE_THREADS = 256;

// Split-K row product: part[z, m, n] = sum over the z-th K chunk of
// a[m, k] * w[k, n]; a [N, Kd], w [Kd, ncols], part [splits, N, ncols]
// fp32. grid = (cdiv(ncols, BN), cdiv(N, BM), splits). At decode batch
// sizes the output has few tiles (16 rows x 64 columns each), so K is
// split across blockIdx.z to put enough blocks on the card.
__global__ void __launch_bounds__(RowTile::THREADS)
mm_split_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                float* __restrict__ part, int N, int Kd, int ncols,
                int chunk) {
  using T = RowTile;
  __shared__ float smem[T::SMEM_FLOATS];
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int k0 = blockIdx.z * chunk;
  const int klen = max(0, min(chunk, Kd - k0));
  float acc[T::TM][T::TN] = {};
  block_matmul<T, true>(
      acc, klen,
      [&](int m, int k) {
        return (m0 + m < N && k < klen) ? to_f(a[(size_t)(m0 + m) * Kd + k0 + k]) : 0.f;
      },
      [&](int k, int n) {
        return (k < klen && n0 + n < ncols) ? to_f(w[(size_t)(k0 + k) * ncols + n0 + n]) : 0.f;
      },
      smem);
  float* out = part + (size_t)blockIdx.z * N * ncols;
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const int m = m0 + tile_row<T>(i), n = n0 + tile_col<T>(j);
      if (m < N && n < ncols) out[(size_t)m * ncols + n] = acc[i][j];
    }
  }
}

// The fp32 product at (m, n): the split partials summed in split order.
__device__ __forceinline__ float split_sum(const float* __restrict__ part,
                                          int splits, int N, int ncols,
                                          int m, int n) {
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[((size_t)z * N + m) * ncols + n];
  return s;
}

// y = rbf(rbf(rbf(prod) + b) + res), y/res [N, C].
__global__ void bias_residual_epilogue(const float* __restrict__ part,
                                       int splits, const bf16* __restrict__ b,
                                       const bf16* __restrict__ res,
                                       bf16* __restrict__ y, int N, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * C) return;
  const int m = i / C, n = i % C;
  const float v = rbf(rbf(split_sum(part, splits, N, C, m, n)) + to_f(b[n]));
  y[i] = to_bf(v + to_f(res[i]));
}

// GLU of linear1 from the [N, 2C] product: h = rbf(a * rbf(sigmoid(g)))
// with a = rbf(rbf(prod[:, c]) + b1[c]), g from column C + c. h [N, C].
__global__ void glu_epilogue(const float* __restrict__ part, int splits,
                             const bf16* __restrict__ b1, bf16* __restrict__ h,
                             int N, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N * C) return;
  const int m = i / C, c = i % C;
  const float a = rbf(rbf(split_sum(part, splits, N, 2 * C, m, c)) + to_f(b1[c]));
  const float g = rbf(rbf(split_sum(part, splits, N, 2 * C, m, C + c)) + to_f(b1[C + c]));
  const float s = rbf(1.f / (1.f + expf(-g)));
  h[i] = to_bf(a * s);
}

// Launch mm_split_kernel over `splits` K chunks (a multiple of BK each).
static cudaError_t launch_mm_split(const bf16* a, const bf16* w, float* part,
                                   int N, int Kd, int ncols, int splits,
                                   cudaStream_t s) {
  const int chunk = cdiv(cdiv(Kd, splits), RowTile::BK) * RowTile::BK;
  mm_split_kernel<<<dim3(cdiv(ncols, RowTile::BN), cdiv(N, RowTile::BM), splits),
                    RowTile::THREADS, 0, s>>>(a, w, part, N, Kd, ncols, chunk);
  return cudaGetLastError();
}

// One head of the dynamic conv for BM rows. grid = (H, cdiv(N, BM)).
// Tap logits rbf(h @ wl[:, head*K : head*K + K]) (wl [C, H*K], head
// major), softmax over the K taps in fp32 rounded to bf16, then for
// each channel c of the head:
//   out = rbf(rbf(sum_{k<K-1} p_k * cache[(t+k) mod (K-1)]) + rbf(p_{K-1} * h))
// cache is ring-major [K-1, N, C]; slots not yet written hold zeros.
__global__ void __launch_bounds__(TapTile::THREADS)
conv_taps_kernel(const bf16* __restrict__ h, const bf16* __restrict__ cache,
                 const bf16* __restrict__ wl, bf16* __restrict__ out, int N,
                 int C, int H, int K, int t) {
  using T = TapTile;
  __shared__ float smem[T::SMEM_FLOATS];
  __shared__ float probs[T::BM][T::BN + 1];
  const int head = blockIdx.x, m0 = blockIdx.y * T::BM;
  const int HK = H * K;
  float acc[T::TM][T::TN] = {};
  block_matmul<T, true>(
      acc, C,
      [&](int m, int k) {
        return (m0 + m < N && k < C) ? to_f(h[(size_t)(m0 + m) * C + k]) : 0.f;
      },
      [&](int k, int n) {
        return (k < C && n < K) ? to_f(wl[(size_t)k * HK + head * K + n]) : 0.f;
      },
      smem);
#pragma unroll
  for (int i = 0; i < T::TM; ++i) {
#pragma unroll
    for (int j = 0; j < T::TN; ++j) probs[tile_row<T>(i)][tile_col<T>(j)] = rbf(acc[i][j]);
  }
  __syncthreads();
  if (threadIdx.x < T::BM) {
    float* p = probs[threadIdx.x];
    float mx = -INFINITY;
    for (int k = 0; k < K; ++k) mx = fmaxf(mx, p[k]);
    float s = 0.f;
    for (int k = 0; k < K; ++k) {
      const float e = expf(p[k] - mx);
      p[k] = e;
      s += e;
    }
    for (int k = 0; k < K; ++k) p[k] = rbf(p[k] / s);
  }
  __syncthreads();
  const int R = C / H, Km1 = K - 1;
  for (int i = threadIdx.x; i < T::BM * R; i += T::THREADS) {
    const int m = i / R, n = m0 + m;
    if (n >= N) continue;
    const int c = head * R + i % R;
    float hist = 0.f;
    for (int k = 0; k < Km1; ++k) {
      const int slot = (t + k) % Km1;
      hist = fmaf(probs[m][k], to_f(cache[((size_t)slot * N + n) * C + c]), hist);
    }
    const float cur = rbf(probs[m][Km1] * to_f(h[(size_t)n * C + c]));
    out[(size_t)n * C + c] = to_bf(rbf(hist) + cur);
  }
}

}  // namespace nic

using nic::bf16;
using nic::cdiv;

// y, h_glu = conv block step. x [N, C]; cache [K-1, N, C] ring-major;
// w1 [C, 2C], b1 [2C] (weight norm folded); wl [C, H*K] head-major;
// w2 [C, C], b2 [C]; hconv [N, C] and part [max(splits1 * 2C,
// splits2 * C) * N] fp32 scratch. Returns a cudaError_t.
extern "C" int nic_decode_conv_block(const void* x, const void* cache,
                                     const void* w1, const void* b1,
                                     const void* wl, const void* w2,
                                     const void* b2, void* h_glu,
                                     void* hconv, void* y, void* part,
                                     int N, int C, int H, int K, int t,
                                     int splits1, int splits2, void* stream) {
  using nic::TapTile;
  if (K < 2 || K > nic::MAX_TAPS || C % H != 0 || t < 0 || splits1 < 1 ||
      splits2 < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ew = cdiv(N * C, nic::EPILOGUE_THREADS);
  cudaError_t err = nic::launch_mm_split((const bf16*)x, (const bf16*)w1,
                                         (float*)part, N, C, 2 * C, splits1, s);
  if (err != cudaSuccess) return (int)err;
  nic::glu_epilogue<<<ew, nic::EPILOGUE_THREADS, 0, s>>>(
      (const float*)part, splits1, (const bf16*)b1, (bf16*)h_glu, N, C);
  NIC_RETURN_IF_LAUNCH_FAILED();
  nic::conv_taps_kernel<<<dim3(H, cdiv(N, TapTile::BM)), TapTile::THREADS, 0, s>>>(
      (const bf16*)h_glu, (const bf16*)cache, (const bf16*)wl, (bf16*)hconv,
      N, C, H, K, t);
  NIC_RETURN_IF_LAUNCH_FAILED();
  err = nic::launch_mm_split((const bf16*)hconv, (const bf16*)w2, (float*)part,
                             N, C, C, splits2, s);
  if (err != cudaSuccess) return (int)err;
  nic::bias_residual_epilogue<<<ew, nic::EPILOGUE_THREADS, 0, s>>>(
      (const float*)part, splits2, (const bf16*)b2, (const bf16*)x, (bf16*)y,
      N, C);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
