// Few-query cross-attention over per-item context K/V, for decode:
// out[b, q, head] = softmax(q_h k_h^T + bias[b]) v_h, fp32 scores and
// softmax, probabilities rounded to bf16 before the value product.
//
// Replaces: news_image_caption_tpu/ops/pallas_kernels.py
// decode_cross_attention (_decode_xattn_kernel).
//
// What bounds it on the card: reading K and V. Per step at batch 16
// the article context (S' = 514 slots x 1024 x bf16) is 16.8 MB of K
// and as much of V per layer, against 4 * Q * S' * E flops per item,
// so the kernel is bound by device-memory bytes.
//
// Design: one block per (head, batch item) reads that head's K and V
// slices exactly once; the Q x S' scores stay in shared memory (no
// score tensor in device memory), like the TPU kernel keeps them in
// VMEM. S' = 514 and 51 are not tile multiples: the tile loaders mask
// the ragged edge. Q is at most 16 (one tile of query rows).

#include "common.cuh"

namespace nic {

using AttnTile = Tile<16, 64, 32, 4, 4>;  // 64 threads
constexpr int ATTN_MAX_Q = AttnTile::BM;

// grid = (H, B). Dynamic shared memory: AttnTile::SMEM_FLOATS + Q * S.
__global__ void __launch_bounds__(AttnTile::THREADS)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        int Q, int S, int E, int dh) {
  using T = AttnTile;
  extern __shared__ float smem[];
  float* p = smem + T::SMEM_FLOATS;  // [Q][S]: scores, then probabilities
  const int head = blockIdx.x, b = blockIdx.y;
  const bf16* qb = q + (size_t)b * Q * E + head * dh;
  const bf16* kb = k + (size_t)b * S * E + head * dh;
  const bf16* vb = v + (size_t)b * S * E + head * dh;
  const float* bb = bias + (size_t)b * S;

  for (int s0 = 0; s0 < S; s0 += T::BN) {
    float acc[T::TM][T::TN] = {};
    block_matmul<T, false>(
        acc, dh,
        [&](int m, int d) {
          return (m < Q && d < dh) ? to_f(qb[(size_t)m * E + d]) : 0.f;
        },
        [&](int d, int n) {
          return (d < dh && s0 + n < S) ? to_f(kb[(size_t)(s0 + n) * E + d]) : 0.f;
        },
        smem);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int m = tile_row<T>(i), n = s0 + tile_col<T>(j);
        if (m < Q && n < S) p[m * S + n] = acc[i][j] + bb[n];
      }
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int m = warp; m < Q; m += T::THREADS / 32) {
    float* row = p + m * S;
    float mx = -INFINITY;
    for (int n = lane; n < S; n += 32) mx = fmaxf(mx, row[n]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int n = lane; n < S; n += 32) {
      const float e = expf(row[n] - mx);
      row[n] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int n = lane; n < S; n += 32) row[n] = rbf(row[n] / sum);
  }
  __syncthreads();

  for (int d0 = 0; d0 < dh; d0 += T::BN) {
    float acc[T::TM][T::TN] = {};
    block_matmul<T, true>(
        acc, S,
        [&](int m, int s) { return (m < Q && s < S) ? p[m * S + s] : 0.f; },
        [&](int s, int n) {
          return (s < S && d0 + n < dh) ? to_f(vb[(size_t)s * E + d0 + n]) : 0.f;
        },
        smem);
#pragma unroll
    for (int i = 0; i < T::TM; ++i) {
#pragma unroll
      for (int j = 0; j < T::TN; ++j) {
        const int m = tile_row<T>(i), n = d0 + tile_col<T>(j);
        if (m < Q && n < dh) out[((size_t)b * Q + m) * E + head * dh + n] = to_bf(acc[i][j]);
      }
    }
  }
}

}  // namespace nic

// out [B, Q, E] = decode cross-attention of q [B, Q, E] (pre-scaled)
// over k, v [B, S, E] with fp32 key bias [B, S]. Returns a cudaError_t.
extern "C" int nic_decode_attention(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int Q, int S, int E,
                                    int H, void* stream) {
  using nic::AttnTile;
  if (Q < 1 || Q > nic::ATTN_MAX_Q || E % H != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)AttnTile::SMEM_FLOATS + (size_t)Q * S);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nic::decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nic::decode_attention_kernel<<<dim3(H, B), AttnTile::THREADS, smem,
                                 (cudaStream_t)stream>>>(
      (const nic::bf16*)q, (const nic::bf16*)k, (const nic::bf16*)v,
      (const float*)bias, (nic::bf16*)out, Q, S, E, E / H);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
