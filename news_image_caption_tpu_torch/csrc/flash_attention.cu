// Full-sequence cross-attention with in-kernel dropout, for the train
// step: forward and backward of
//   out[b, :, head] = dropout(softmax(q_h k_h^T + bias[b])) v_h,
// q [B, T, E] (pre-scaled by dh^-1/2), k, v [B, S, E], bias [B, S]
// fp32 (0 attendable, -1e9 padded), heads side by side in E.
//
// Replaces: news_image_caption_tpu/ops/pallas_flash.py _flash_fwd
// (_fwd_kernel) and _flash_bwd (_bwd_kernel), the two halves of
// flash_cross_attention's custom VJP.
//
// What bounds it on the card: at the flagship (B = 16, T = 63, E =
// 1024, 16 heads) the article K and V are 16.8 MB each per layer
// (S' = 514), so the forward reads 33.7 MB and the backward reads K,
// V, Q and the output gradient and writes dK and dV, about 70 MB,
// against 4 T S' E flops per item for the forward and 10 T S' E for
// the backward. At plain-FMA rates (no tensor cores yet) the products,
// not the bytes, set the time.
//
// Design: one block per (head, batch item), 256 blocks at the
// flagship. The block's T x S' fp32 scores stay in dynamic shared
// memory (63 x 514 x 4 = 130 KB, so the wrapper raises the limit past
// 48 KB), as the TPU kernel keeps them in VMEM, so no score,
// probability or mask tensor exists in device memory. Products go
// through block_matmul (common.cuh); the loaders mask the ragged T and
// S' edges. The backward keeps the probabilities, then overwrites them
// in place with ds; dp is formed twice (once for its row sums delta,
// once for ds), so the block never holds two T x S' arrays. Each
// output element is written by one thread after a fixed-order sum: no
// atomics, the result is deterministic.
//
// Numerics follow the TPU kernel: fp32 scores plus the fp32 bias, fp32
// softmax and dropout, probabilities rounded to bf16 before the value
// product; in the backward dp is scaled by the mask, delta = sum of
// dp * probs, ds = probs * (dp - delta) rounded to bf16, dq = ds k,
// dk = ds^T q, dv = dropped^T g, every product accumulated in fp32.
//
// Dropout: the TPU draws from its hardware generator, which cannot be
// reproduced here. The seed is mixed as the TPU kernel mixes it,
// key = seed * 2654435761 + (b * H + head) (mod 2^32), and the bits of
// (key, t, s) come from a stateless hash: the murmur3 finalizer fmix32,
// row_key = fmix32(key ^ fmix32(t + 0x9e3779b9)), bits =
// fmix32(row_key + s). A slot is kept where bits >= threshold =
// floor(p 2^32). The forward and the backward regenerate the same
// mask; ops/flash_attention.py computes the same bits in torch integer
// ops. The seed is read from device memory, so drawing it needs no
// host round trip.

#include "common.cuh"

namespace nic {

using FlashTile = Tile<64, 64, 32, 4, 4>;  // 256 threads

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t row_key(uint32_t key, int t) {
  return fmix32(key ^ fmix32((uint32_t)t + 0x9e3779b9u));
}

// Dropout multiplier of slot s in the row whose key is rk: 0 where
// dropped, else scale (1 / (1 - p); 1 without dropout).
__device__ __forceinline__ float drop_scale(uint32_t rk, int s,
                                            uint32_t threshold, float scale) {
  if (threshold == 0u) return scale;
  return fmix32(rk + (uint32_t)s) >= threshold ? scale : 0.f;
}

struct FlashArgs {
  const bf16* q;      // [B, T, E]
  const bf16* k;      // [B, S, E]
  const bf16* v;      // [B, S, E]
  const float* bias;  // [B, S]
  const int* seed;    // [1]
  int T, S, E, dh;
  uint32_t threshold;
  float scale;
};

// P[t][s] = q_t . k_s + bias[s] for this block's (head, item), then
// f(t, score) applied by `finish`.
template <class Finish>
__device__ __forceinline__ void scores_to_smem(const FlashArgs& a, const bf16* qb,
                                               const bf16* kb, const float* bb,
                                               float* P, float* tile_smem,
                                               Finish finish) {
  using FT = FlashTile;
  for (int m0 = 0; m0 < a.T; m0 += FT::BM) {
    for (int s0 = 0; s0 < a.S; s0 += FT::BN) {
      float acc[FT::TM][FT::TN] = {};
      block_matmul<FT, false>(
          acc, a.dh,
          [&](int m, int d) {
            return (m0 + m < a.T && d < a.dh) ? to_f(qb[(size_t)(m0 + m) * a.E + d]) : 0.f;
          },
          [&](int d, int n) {
            return (d < a.dh && s0 + n < a.S) ? to_f(kb[(size_t)(s0 + n) * a.E + d]) : 0.f;
          },
          tile_smem);
#pragma unroll
      for (int i = 0; i < FT::TM; ++i) {
#pragma unroll
        for (int j = 0; j < FT::TN; ++j) {
          const int t = m0 + tile_row<FT>(i), s = s0 + tile_col<FT>(j);
          if (t < a.T && s < a.S) P[t * a.S + s] = finish(t, acc[i][j] + bb[s]);
        }
      }
    }
  }
}

// grid = (H, B), FlashTile::THREADS threads. Dynamic shared memory:
// FlashTile::SMEM_FLOATS + T * S floats.
__global__ void __launch_bounds__(FlashTile::THREADS)
flash_fwd_kernel(FlashArgs a, bf16* __restrict__ out, float* __restrict__ lse) {
  using FT = FlashTile;
  extern __shared__ float smem[];
  float* tile_smem = smem;
  float* P = smem + FT::SMEM_FLOATS;  // [T][S]
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const size_t qoff = (size_t)b * a.T * a.E + head * a.dh;
  const size_t koff = (size_t)b * a.S * a.E + head * a.dh;
  const bf16* qb = a.q + qoff;
  const bf16* kb = a.k + koff;
  const bf16* vb = a.v + koff;
  const float* bb = a.bias + (size_t)b * a.S;
  const uint32_t key = (uint32_t)a.seed[0] * 2654435761u + (uint32_t)(b * H + head);

  scores_to_smem(a, qb, kb, bb, P, tile_smem, [](int, float x) { return x; });
  __syncthreads();

  // Softmax, lse and dropout, one warp per row.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int t = warp; t < a.T; t += FT::THREADS / 32) {
    float* row = P + t * a.S;
    float mx = -INFINITY;
    for (int s = lane; s < a.S; s += 32) mx = fmaxf(mx, row[s]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int s = lane; s < a.S; s += 32) {
      const float e = expf(row[s] - mx);
      row[s] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) lse[((size_t)b * H + head) * a.T + t] = mx + logf(sum);
    const uint32_t rk = row_key(key, t);
    for (int s = lane; s < a.S; s += 32) {
      row[s] = rbf(row[s] / sum * drop_scale(rk, s, a.threshold, a.scale));
    }
  }
  __syncthreads();

  for (int m0 = 0; m0 < a.T; m0 += FT::BM) {
    for (int d0 = 0; d0 < a.dh; d0 += FT::BN) {
      float acc[FT::TM][FT::TN] = {};
      block_matmul<FT, true>(
          acc, a.S,
          [&](int m, int s) {
            return (m0 + m < a.T && s < a.S) ? P[(m0 + m) * a.S + s] : 0.f;
          },
          [&](int s, int n) {
            return (s < a.S && d0 + n < a.dh) ? to_f(vb[(size_t)s * a.E + d0 + n]) : 0.f;
          },
          tile_smem);
#pragma unroll
      for (int i = 0; i < FT::TM; ++i) {
#pragma unroll
        for (int j = 0; j < FT::TN; ++j) {
          const int t = m0 + tile_row<FT>(i), d = d0 + tile_col<FT>(j);
          if (t < a.T && d < a.dh) out[qoff + (size_t)t * a.E + d] = to_bf(acc[i][j]);
        }
      }
    }
  }
}

// grid = (H, B), FlashTile::THREADS threads. Dynamic shared memory:
// 2 * FlashTile::SMEM_FLOATS + T * S + 3 * T floats.
__global__ void __launch_bounds__(FlashTile::THREADS)
flash_bwd_kernel(FlashArgs a, const float* __restrict__ lse,
                 const bf16* __restrict__ g, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using FT = FlashTile;
  extern __shared__ float smem[];
  float* tile_smem = smem;
  float* buf = smem + FT::SMEM_FLOATS;             // [BM][BN + 1]: dp * probs
  float* P = buf + FT::SMEM_FLOATS;                // [T][S]: probs, then ds
  float* lse_s = P + a.T * a.S;                    // [T]
  float* delta = lse_s + a.T;                      // [T]
  uint32_t* rks = (uint32_t*)(delta + a.T);        // [T] row keys
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const size_t qoff = (size_t)b * a.T * a.E + head * a.dh;
  const size_t koff = (size_t)b * a.S * a.E + head * a.dh;
  const bf16* qb = a.q + qoff;
  const bf16* kb = a.k + koff;
  const bf16* vb = a.v + koff;
  const bf16* gb = g + qoff;
  const float* bb = a.bias + (size_t)b * a.S;
  const uint32_t key = (uint32_t)a.seed[0] * 2654435761u + (uint32_t)(b * H + head);
  const int tid = threadIdx.x;

  for (int t = tid; t < a.T; t += FT::THREADS) {
    lse_s[t] = lse[((size_t)b * H + head) * a.T + t];
    delta[t] = 0.f;
    rks[t] = row_key(key, t);
  }
  __syncthreads();

  // Probabilities, recomputed from the saved logsumexp.
  scores_to_smem(a, qb, kb, bb, P, tile_smem,
                 [&](int t, float x) { return expf(x - lse_s[t]); });
  __syncthreads();

  // dv[s] = sum_t bf16(probs[t][s] * mask) g[t], before P is overwritten.
  for (int s0 = 0; s0 < a.S; s0 += FT::BM) {
    for (int d0 = 0; d0 < a.dh; d0 += FT::BN) {
      float acc[FT::TM][FT::TN] = {};
      block_matmul<FT, true>(
          acc, a.T,
          [&](int m, int t) {
            const int s = s0 + m;
            return (s < a.S && t < a.T)
                       ? rbf(P[t * a.S + s] * drop_scale(rks[t], s, a.threshold, a.scale))
                       : 0.f;
          },
          [&](int t, int n) {
            return (t < a.T && d0 + n < a.dh) ? to_f(gb[(size_t)t * a.E + d0 + n]) : 0.f;
          },
          tile_smem);
#pragma unroll
      for (int i = 0; i < FT::TM; ++i) {
#pragma unroll
        for (int j = 0; j < FT::TN; ++j) {
          const int s = s0 + tile_row<FT>(i), d = d0 + tile_col<FT>(j);
          if (s < a.S && d < a.dh) dv[koff + (size_t)s * a.E + d] = to_bf(acc[i][j]);
        }
      }
    }
  }

  // dp[t][s] = (g_t . v_s) * mask, formed per (T tile, S tile). Pass 0
  // sums dp * probs into delta in a fixed order; pass 1 overwrites
  // P with ds = bf16(probs * (dp - delta)).
  for (int pass = 0; pass < 2; ++pass) {
    for (int m0 = 0; m0 < a.T; m0 += FT::BM) {
      for (int s0 = 0; s0 < a.S; s0 += FT::BN) {
        float acc[FT::TM][FT::TN] = {};
        block_matmul<FT, false>(
            acc, a.dh,
            [&](int m, int d) {
              return (m0 + m < a.T && d < a.dh) ? to_f(gb[(size_t)(m0 + m) * a.E + d]) : 0.f;
            },
            [&](int d, int n) {
              return (d < a.dh && s0 + n < a.S) ? to_f(vb[(size_t)(s0 + n) * a.E + d]) : 0.f;
            },
            tile_smem);
#pragma unroll
        for (int i = 0; i < FT::TM; ++i) {
#pragma unroll
          for (int j = 0; j < FT::TN; ++j) {
            const int r = tile_row<FT>(i), c = tile_col<FT>(j);
            const int t = m0 + r, s = s0 + c;
            const bool in = t < a.T && s < a.S;
            const float dp = in ? acc[i][j] * drop_scale(rks[t], s, a.threshold, a.scale) : 0.f;
            if (pass == 0) {
              buf[r * (FT::BN + 1) + c] = in ? dp * P[t * a.S + s] : 0.f;
            } else if (in) {
              const float pr = P[t * a.S + s];
              P[t * a.S + s] = rbf(pr * (dp - delta[t]));
            }
          }
        }
        if (pass == 0) {
          __syncthreads();
          if (tid < FT::BM && m0 + tid < a.T) {
            float sum = delta[m0 + tid];
            for (int c = 0; c < FT::BN; ++c) sum += buf[tid * (FT::BN + 1) + c];
            delta[m0 + tid] = sum;
          }
          __syncthreads();
        }
      }
    }
    __syncthreads();
  }

  // dq[t] = sum_s ds[t][s] k[s].
  for (int m0 = 0; m0 < a.T; m0 += FT::BM) {
    for (int d0 = 0; d0 < a.dh; d0 += FT::BN) {
      float acc[FT::TM][FT::TN] = {};
      block_matmul<FT, true>(
          acc, a.S,
          [&](int m, int s) {
            return (m0 + m < a.T && s < a.S) ? P[(m0 + m) * a.S + s] : 0.f;
          },
          [&](int s, int n) {
            return (s < a.S && d0 + n < a.dh) ? to_f(kb[(size_t)s * a.E + d0 + n]) : 0.f;
          },
          tile_smem);
#pragma unroll
      for (int i = 0; i < FT::TM; ++i) {
#pragma unroll
        for (int j = 0; j < FT::TN; ++j) {
          const int t = m0 + tile_row<FT>(i), d = d0 + tile_col<FT>(j);
          if (t < a.T && d < a.dh) dq[qoff + (size_t)t * a.E + d] = to_bf(acc[i][j]);
        }
      }
    }
  }

  // dk[s] = sum_t ds[t][s] q[t] (q is pre-scaled).
  for (int s0 = 0; s0 < a.S; s0 += FT::BM) {
    for (int d0 = 0; d0 < a.dh; d0 += FT::BN) {
      float acc[FT::TM][FT::TN] = {};
      block_matmul<FT, true>(
          acc, a.T,
          [&](int m, int t) {
            return (s0 + m < a.S && t < a.T) ? P[t * a.S + s0 + m] : 0.f;
          },
          [&](int t, int n) {
            return (t < a.T && d0 + n < a.dh) ? to_f(qb[(size_t)t * a.E + d0 + n]) : 0.f;
          },
          tile_smem);
#pragma unroll
      for (int i = 0; i < FT::TM; ++i) {
#pragma unroll
        for (int j = 0; j < FT::TN; ++j) {
          const int s = s0 + tile_row<FT>(i), d = d0 + tile_col<FT>(j);
          if (s < a.S && d < a.dh) dk[koff + (size_t)s * a.E + d] = to_bf(acc[i][j]);
        }
      }
    }
  }
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes a Hopper block may use

inline int set_smem(const void* kernel, size_t bytes) {
  if (bytes > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
  }
  return 0;
}

inline FlashArgs make_args(const void* q, const void* k, const void* v, const void* bias,
                           const void* seed, int T, int S, int E, int H,
                           unsigned threshold, float scale) {
  return FlashArgs{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                   (const int*)seed, T, S, E, E / H, threshold, scale};
}

}  // namespace nic

// out [B, T, E] (bf16) and lse [B, H, T] (fp32) of flash cross-attention
// of q over k, v [B, S, E] with key bias [B, S] and the int32 seed at
// `seed` (device memory). threshold = floor(p 2^32) (0: no dropout),
// scale = 1 / (1 - p). Returns a cudaError_t.
extern "C" int nic_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, void* out,
                             void* lse, int B, int T, int S, int E, int H,
                             unsigned threshold, float scale, void* stream) {
  using nic::FlashTile;
  if (E % H != 0 || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)FlashTile::SMEM_FLOATS + (size_t)T * S);
  const int err = nic::set_smem((const void*)nic::flash_fwd_kernel, smem);
  if (err) return err;
  nic::flash_fwd_kernel<<<dim3(H, B), FlashTile::THREADS, smem, (cudaStream_t)stream>>>(
      nic::make_args(q, k, v, bias, seed, T, S, E, H, threshold, scale), (nic::bf16*)out,
      (float*)lse);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

// dq [B, T, E], dk, dv [B, S, E] (bf16) of the above, from its saved
// lse and the output gradient g [B, T, E] (bf16).
extern "C" int nic_flash_bwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, const void* lse,
                             const void* g, void* dq, void* dk, void* dv, int B,
                             int T, int S, int E, int H, unsigned threshold,
                             float scale, void* stream) {
  using nic::FlashTile;
  if (E % H != 0 || T < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (2 * (size_t)FlashTile::SMEM_FLOATS + (size_t)T * S + 3 * (size_t)T);
  const int err = nic::set_smem((const void*)nic::flash_bwd_kernel, smem);
  if (err) return err;
  nic::flash_bwd_kernel<<<dim3(H, B), FlashTile::THREADS, smem, (cudaStream_t)stream>>>(
      nic::make_args(q, k, v, bias, seed, T, S, E, H, threshold, scale), (const float*)lse,
      (const nic::bf16*)g, (nic::bf16*)dq, (nic::bf16*)dk, (nic::bf16*)dv);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
