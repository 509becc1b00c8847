// Generic variants of the flash kernels (flash_attention.cu): forward
// and backward of the train step's cross-attention,
//   out[b, :, head] = dropout(softmax(q_h k_h^T + bias[b])) v_h,
// q [B, T, E] (pre-scaled by dh^-1/2), k, v [B, S, E], bias [B, S]
// fp32, at every dtype and head size the plain versions take, where the
// fast kernels take bf16 with heads of 16, 32, 64 or 128 only.
//
// Replaces: news_image_caption_tpu/ops/pallas_flash.py _flash_fwd
// (_fwd_kernel) and _flash_bwd (_bwd_kernel), which compute in any float
// dtype with fp32 sums and gate on the head size alone
// (supported_head_dim), for the models the fast kernels do not take:
// fp32 training (the flagship at trainer.mixed_precision fp32), heads of
// 4 and 8 (configs/tiny_test.yaml, the toy), heads up to 256.
//
// Numerics: those of ops/flash_attention.py::flash_attention_fwd_plain
// and _bwd_plain, at the same rounding points (no-ops in fp32): fp32
// scores plus the fp32 bias, fp32 softmax and dropout, probabilities
// rounded to v's dtype before the value product; in the backward dp =
// g v^T times the mask, delta = sum_s dp * probs (formed from the
// probabilities, not from the rounded output), ds = probs * (dp -
// delta) rounded to v's dtype before the dq and dk products. Every
// product multiplies with FFMA in fp32 (no tensor cores, so fp32 never
// goes through TF32). The dropout hash is common.cuh's, so this kernel
// and the fast one drop the same slots.
//
// What bounds it on the card: at the fp32 flagship (B = 16, T = 63, 16
// heads of 64) the fp32 operations over the card's 67 TFLOP/s (2.1
// GFLOP forward and 5.3 backward in the article call, S' = 514; 0.2 and
// 0.5 in the image's, S' = 51), against 76 / 147 MB and 15 / 26 MB of
// bytes. The design aims at a simple kernel that is right:
//   - grid (H, B, T tiles), 256 threads as 16 x 16: a block owns ROWS
//     query rows of one (head, item) and walks the keys twice in chunks
//     of KEYS, as the fast kernel does. The tile shape follows the head
//     size (Tiles below): 64 rows and 64 keys up to heads of 64, 64 x 32
//     up to 128, 32 x 32 up to 256, so that q (and g), a chunk of K and
//     V, and the chunk's probabilities fit shared memory as fp32.
//   - Operands lie in shared memory as fp32, transposed ([d][row],
//     [d][key], rows padded by one float): every product reads one
//     broadcast and one run of consecutive floats a step. A thread holds
//     a register tile: scores RPT rows x KPT keys, the output or dq RPT
//     rows x CPT columns, a chunk's dk or dv KPT keys x CPT columns.
//   - Forward: walk 1 keeps each row's maximum and sum of exponentials
//     (rescaled as the maximum grows; the 16 lanes of a row reduce by
//     shuffles), writes lse; walk 2 forms p = exp(s - max) / sum times
//     the mask, rounds it into shared memory and adds p v.
//   - Backward: walk 1 forms probs = exp(s - lse) and dp, adds delta
//     and writes the chunk's dv = dropped^T g; walk 2 forms ds, adds dq
//     = ds k in registers and writes the chunk's dk = ds^T q. T > ROWS:
//     each T tile writes fp32 parts of dk and dv that a second kernel
//     adds in tile order. Every sum has a fixed order: no atomics, two
//     calls on the same inputs give the same bits.
//   - Query rows past T are zeros (lse +inf in the backward: probs 0),
//     keys past S' score -inf and weigh 0, and a padded key (bias -1e9)
//     is a key like any other, as in the plain versions.

#include "common.cuh"

namespace nic {
namespace fgen {

constexpr int THREADS = 256;   // tx = tid % 16, ty = tid / 16
constexpr int MAX_HEAD = 256;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

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

// The sum and the maximum over the 16 lanes of one ty (a half warp).
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

// The tile shape of one class of head sizes: a thread owns RPT rows
// (ty + 16 i), KPT keys (tx + 16 j) and CPT columns (tx + 16 c) of a
// head padded to W = 16 CPT.
template <int RPT_, int KPT_, int CPT_>
struct Tiles {
  static constexpr int RPT = RPT_, KPT = KPT_, CPT = CPT_;
  static constexpr int ROWS = 16 * RPT, KEYS = 16 * KPT, W = 16 * CPT;
  static constexpr int RS = ROWS + 1, KS = KEYS + 1;   // padded strides
  // Floats of dynamic shared memory: q (and g) [W][RS], K and V [W][KS],
  // the chunk's probabilities [ROWS][KS], the key bias [KEYS].
  static constexpr int smem_floats(bool backward) {
    return (backward ? 2 : 1) * W * RS + 2 * W * KS + ROWS * KS + KEYS;
  }
};

using Tiles16 = Tiles<4, 4, 1>;
using Tiles32 = Tiles<4, 4, 2>;
using Tiles64 = Tiles<4, 4, 4>;
using Tiles128 = Tiles<4, 2, 8>;
using Tiles256 = Tiles<2, 2, 16>;

// (rows, keys, smem bytes) of the class of head size dh (1..256); the
// host's ops/flash_attention.py::generic_flash_plan mirrors it.
inline void plan_of(int dh, bool backward, int& rows, int& keys, int& smem) {
#define NIC_FGEN_PLAN(TL)                                     \
  rows = TL::ROWS, keys = TL::KEYS,                           \
  smem = TL::smem_floats(backward) * (int)sizeof(float)
  if (dh <= 16) NIC_FGEN_PLAN(Tiles16);
  else if (dh <= 32) NIC_FGEN_PLAN(Tiles32);
  else if (dh <= 64) NIC_FGEN_PLAN(Tiles64);
  else if (dh <= 128) NIC_FGEN_PLAN(Tiles128);
  else NIC_FGEN_PLAN(Tiles256);
#undef NIC_FGEN_PLAN
}

struct Args {
  const void* q;      // [B, T, E]
  const void* k;      // [B, S, E]
  const void* v;      // [B, S, E]
  const float* bias;  // [B, S]
  const int* seed;    // [1]
  int T, S, E, dh;
  uint32_t threshold;
  float scale;
  int row0, h0, heads_total;
};

// Rows [0, valid) of N rows of dh elements, E apart in device memory,
// into dst[d * (N + 1) + row] as fp32 for d < W; zeros past `valid` and
// past dh.
template <class T, int N, int W>
__device__ __forceinline__ void load_t(float* dst, const T* src, int E, int valid,
                                       int dh) {
  for (int e = threadIdx.x; e < N * W; e += THREADS) {
    const int row = e / W, d = e % W;
    dst[d * (N + 1) + row] =
        (row < valid && d < dh) ? ld(src + (size_t)row * E + d) : 0.f;
  }
}

// s[i][j] = a[row i] . b[key j] over d < dh, for the thread's rows and
// keys (a [W][RS], b [W][KS] transposed tiles).
template <class TL>
__device__ __forceinline__ void rows_dot_keys(float (&s)[TL::RPT][TL::KPT],
                                              const float* a, const float* b,
                                              int dh, int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < dh; ++d) {
    float av[TL::RPT], bv[TL::KPT];
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) av[i] = a[d * TL::RS + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TL::KPT; ++j) bv[j] = b[d * TL::KS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i)
#pragma unroll
      for (int j = 0; j < TL::KPT; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][c] += sum over keys kk < n of p[row i][kk] * x[column c][kk]
// (p [ROWS][KS], x a [W][KS] tile of K or V).
template <class TL>
__device__ __forceinline__ void probs_times_keys(float (&acc)[TL::RPT][TL::CPT],
                                                 const float* p, const float* x,
                                                 int n, int tx, int ty) {
#pragma unroll 4
  for (int kk = 0; kk < n; ++kk) {
    float pv[TL::RPT];
#pragma unroll
    for (int i = 0; i < TL::RPT; ++i) pv[i] = p[(ty + 16 * i) * TL::KS + kk];
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const float xv = x[(tx + 16 * c) * TL::KS + kk];
#pragma unroll
      for (int i = 0; i < TL::RPT; ++i) acc[i][c] = fmaf(pv[i], xv, acc[i][c]);
    }
  }
}

// acc[j][c] = sum over rows r < rows of p[r][key j] * x[column c][r]
// (x a [W][RS] tile of q or g): a chunk's dk or dv.
template <class TL>
__device__ __forceinline__ void keys_times_rows(float (&acc)[TL::KPT][TL::CPT],
                                                const float* p, const float* x,
                                                int rows, int tx, int ty) {
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float pv[TL::KPT];
#pragma unroll
    for (int j = 0; j < TL::KPT; ++j) pv[j] = p[r * TL::KS + ty + 16 * j];
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const float xv = x[(tx + 16 * c) * TL::RS + r];
#pragma unroll
      for (int j = 0; j < TL::KPT; ++j) acc[j][c] = fmaf(pv[j], xv, acc[j][c]);
    }
  }
}

// The chunk's K (and V), transposed, and its key bias (-inf past S').
template <class T, class TL>
__device__ __forceinline__ void load_chunk(float* ks, float* vs, float* bs,
                                           const T* kb, const T* vb, const float* bb,
                                           const Args& a, int s0, int n, bool with_v) {
  load_t<T, TL::KEYS, TL::W>(ks, kb + (size_t)s0 * a.E, a.E, n, a.dh);
  if (with_v) load_t<T, TL::KEYS, TL::W>(vs, vb + (size_t)s0 * a.E, a.E, n, a.dh);
  for (int j = threadIdx.x; j < TL::KEYS; j += THREADS)
    bs[j] = j < n ? bb[s0 + j] : -INFINITY;
}

// grid (H, B, T tiles), THREADS threads, dynamic shared memory
// TL::smem_floats(false) floats.
template <class T, class TL>
__global__ void __launch_bounds__(THREADS)
flash_fwd_generic_kernel(Args a, T* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [W][RS]
  float* ks = qs + TL::W * TL::RS;       // [W][KS]
  float* vs = ks + TL::W * TL::KS;       // [W][KS]
  float* ps = vs + TL::W * TL::KS;       // [ROWS][KS]
  float* bs = ps + TL::ROWS * TL::KS;    // [KEYS]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int t0 = blockIdx.z * TL::ROWS, rows = min(TL::ROWS, a.T - t0);
  const size_t qoff = ((size_t)b * a.T + t0) * a.E + (size_t)head * a.dh;
  const size_t koff = (size_t)b * a.S * a.E + (size_t)head * a.dh;
  const T* kb = (const T*)a.k + koff;
  const T* vb = (const T*)a.v + koff;
  const float* bb = a.bias + (size_t)b * a.S;
  load_t<T, TL::ROWS, TL::W>(qs, (const T*)a.q + qoff, a.E, rows, a.dh);
  const uint32_t key = dropout_key(a.seed[0], b, a.row0, a.heads_total, a.h0, head);
  uint32_t rk[TL::RPT];
  float mx[TL::RPT], sum[TL::RPT];
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i) {
    rk[i] = row_key(key, t0 + ty + 16 * i);
    mx[i] = -INFINITY;
    sum[i] = 0.f;
  }
  float o[TL::RPT][TL::CPT] = {};
  for (int walk = 0; walk < 2; ++walk) {
    for (int s0 = 0; s0 < a.S; s0 += TL::KEYS) {
      const int n = min(TL::KEYS, a.S - s0);
      __syncthreads();   // the previous chunk is read
      load_chunk<T, TL>(ks, vs, bs, kb, vb, bb, a, s0, n, walk == 1);
      __syncthreads();
      float s[TL::RPT][TL::KPT] = {};
      rows_dot_keys<TL>(s, qs, ks, a.dh, tx, ty);
#pragma unroll
      for (int i = 0; i < TL::RPT; ++i)
#pragma unroll
        for (int j = 0; j < TL::KPT; ++j) s[i][j] += bs[tx + 16 * j];
      if (walk == 0) {
#pragma unroll
        for (int i = 0; i < TL::RPT; ++i) {
          float m = -INFINITY;
#pragma unroll
          for (int j = 0; j < TL::KPT; ++j) m = fmaxf(m, s[i][j]);
          m = fmaxf(mx[i], max16(m));
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < TL::KPT; ++j) part += expf(s[i][j] - m);
          sum[i] = sum[i] * expf(mx[i] - m) + sum16(part);
          mx[i] = m;
        }
      } else {
#pragma unroll
        for (int i = 0; i < TL::RPT; ++i)
#pragma unroll
          for (int j = 0; j < TL::KPT; ++j) {
            const float p = expf(s[i][j] - mx[i]) / sum[i] *
                            drop_scale(rk[i], s0 + tx + 16 * j, a.threshold, a.scale);
            ps[(ty + 16 * i) * TL::KS + tx + 16 * j] = round_to<T>(p);
          }
        __syncthreads();   // the chunk's probabilities are whole
        probs_times_keys<TL>(o, ps, vs, n, tx, ty);
      }
    }
    if (walk == 0 && tx == 0) {
#pragma unroll
      for (int i = 0; i < TL::RPT; ++i) {
        const int r = ty + 16 * i;
        if (r < rows) lse[((size_t)b * H + head) * a.T + t0 + r] = mx[i] + logf(sum[i]);
      }
    }
  }
  T* ob = out + qoff;
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < a.dh) ob[(size_t)r * a.E + col] = store_as<T>(o[i][c]);
    }
  }
}

// A chunk's dk or dv for keys [s0, s0 + n): rounded into `to`, or, with
// several T tiles, as fp32 into `part`; both at this (item, head)'s key 0.
template <class T, class TL>
__device__ __forceinline__ void store_keys(const float (&acc)[TL::KPT][TL::CPT],
                                           T* to, float* part, const Args& a,
                                           int s0, int n, int tx, int ty) {
#pragma unroll
  for (int j = 0; j < TL::KPT; ++j) {
    const int key = ty + 16 * j;
    if (key >= n) continue;
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const int col = tx + 16 * c;
      if (col >= a.dh) continue;
      const size_t at = (size_t)(s0 + key) * a.E + col;
      if (part != nullptr) part[at] = acc[j][c];
      else to[at] = store_as<T>(acc[j][c]);
    }
  }
}

// grid (H, B, T tiles), THREADS threads, dynamic shared memory
// TL::smem_floats(true) floats. parts: null for one T tile, else fp32
// [2 (dk, dv)][T tiles][B, S, E].
template <class T, class TL>
__global__ void __launch_bounds__(THREADS)
flash_bwd_generic_kernel(Args a, const float* __restrict__ lse,
                         const T* __restrict__ gout, T* __restrict__ dq,
                         T* __restrict__ dk, T* __restrict__ dv,
                         float* __restrict__ parts) {
  extern __shared__ __align__(16) float sm[];
  float* qs = sm;                        // [W][RS]
  float* gs = qs + TL::W * TL::RS;       // [W][RS]
  float* ks = gs + TL::W * TL::RS;       // [W][KS]
  float* vs = ks + TL::W * TL::KS;       // [W][KS]
  float* ps = vs + TL::W * TL::KS;       // [ROWS][KS]: dropped probabilities, then ds
  float* bs = ps + TL::ROWS * TL::KS;    // [KEYS]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const int t0 = blockIdx.z * TL::ROWS, rows = min(TL::ROWS, a.T - t0);
  const size_t qoff = ((size_t)b * a.T + t0) * a.E + (size_t)head * a.dh;
  const size_t koff = (size_t)b * a.S * a.E + (size_t)head * a.dh;
  const T* kb = (const T*)a.k + koff;
  const T* vb = (const T*)a.v + koff;
  const float* bb = a.bias + (size_t)b * a.S;
  const size_t kv_elems = (size_t)B * a.S * a.E;
  float* dk_part = parts == nullptr ? nullptr : parts + blockIdx.z * kv_elems + koff;
  float* dv_part =
      parts == nullptr ? nullptr : parts + (gridDim.z + blockIdx.z) * kv_elems + koff;
  load_t<T, TL::ROWS, TL::W>(qs, (const T*)a.q + qoff, a.E, rows, a.dh);
  load_t<T, TL::ROWS, TL::W>(gs, gout + qoff, a.E, rows, a.dh);
  const uint32_t key = dropout_key(a.seed[0], b, a.row0, a.heads_total, a.h0, head);
  const float* lb = lse + ((size_t)b * H + head) * a.T + t0;
  uint32_t rk[TL::RPT];
  float lrow[TL::RPT], delta[TL::RPT];
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i) {
    const int r = ty + 16 * i;
    rk[i] = row_key(key, t0 + r);
    lrow[i] = r < rows ? lb[r] : INFINITY;   // a row past T: probs 0
    delta[i] = 0.f;
  }
  float dqa[TL::RPT][TL::CPT] = {};
  for (int walk = 0; walk < 2; ++walk) {
    for (int s0 = 0; s0 < a.S; s0 += TL::KEYS) {
      const int n = min(TL::KEYS, a.S - s0);
      __syncthreads();   // the previous chunk is read
      load_chunk<T, TL>(ks, vs, bs, kb, vb, bb, a, s0, n, true);
      __syncthreads();
      float s[TL::RPT][TL::KPT] = {}, dp[TL::RPT][TL::KPT] = {};
      rows_dot_keys<TL>(s, qs, ks, a.dh, tx, ty);
      rows_dot_keys<TL>(dp, gs, vs, a.dh, tx, ty);
#pragma unroll
      for (int i = 0; i < TL::RPT; ++i)
#pragma unroll
        for (int j = 0; j < TL::KPT; ++j) {
          const float p = expf(s[i][j] + bs[tx + 16 * j] - lrow[i]);
          const float m = drop_scale(rk[i], s0 + tx + 16 * j, a.threshold, a.scale);
          const float d = dp[i][j] * m;
          float x;
          if (walk == 0) {
            delta[i] = fmaf(d, p, delta[i]);
            x = p * m;
          } else {
            x = p * (d - delta[i]);
          }
          ps[(ty + 16 * i) * TL::KS + tx + 16 * j] = round_to<T>(x);
        }
      __syncthreads();   // the chunk's dropped probabilities or ds are whole
      float acc[TL::KPT][TL::CPT] = {};
      if (walk == 0) {
        keys_times_rows<TL>(acc, ps, gs, rows, tx, ty);   // dv = dropped^T g
        store_keys<T, TL>(acc, dv + koff, dv_part, a, s0, n, tx, ty);
      } else {
        probs_times_keys<TL>(dqa, ps, ks, n, tx, ty);     // dq += ds k
        keys_times_rows<TL>(acc, ps, qs, rows, tx, ty);   // dk = ds^T q
        store_keys<T, TL>(acc, dk + koff, dk_part, a, s0, n, tx, ty);
      }
    }
    if (walk == 0) {
      // The 16 lanes of a row hold its keys: its delta, in a fixed order.
#pragma unroll
      for (int i = 0; i < TL::RPT; ++i) delta[i] = sum16(delta[i]);
    }
  }
  T* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < TL::RPT; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int c = 0; c < TL::CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < a.dh) dqb[(size_t)r * a.E + col] = store_as<T>(dqa[i][c]);
    }
  }
}

// dk and dv of a backward over several T tiles: the tiles' fp32 parts
// [2][tiles][n] added in tile order and rounded once. grid.y = 2.
template <class T>
__global__ void __launch_bounds__(THREADS)
add_parts_kernel(const float* __restrict__ parts, T* __restrict__ dk,
                 T* __restrict__ dv, int tiles, size_t n) {
  const float* src = parts + (size_t)blockIdx.y * tiles * n;
  T* dst = blockIdx.y == 0 ? dk : dv;
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * THREADS) {
    float sum = src[i];
    for (int z = 1; z < tiles; ++z) sum += src[(size_t)z * n + i];
    dst[i] = store_as<T>(sum);
  }
}

template <class T, class TL>
cudaError_t launch_fwd(const Args& a, void* out, void* lse, int B, int H, int smem,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_generic_kernel<T, TL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  flash_fwd_generic_kernel<T, TL><<<dim3(H, B, cdiv(a.T, TL::ROWS)), THREADS, smem,
                                    stream>>>(a, (T*)out, (float*)lse);
  return cudaGetLastError();
}

template <class T, class TL>
cudaError_t launch_bwd(const Args& a, const void* lse, const void* g, void* dq,
                       void* dk, void* dv, void* parts, int B, int H, int smem,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_generic_kernel<T, TL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(a.T, TL::ROWS);
  flash_bwd_generic_kernel<T, TL><<<dim3(H, B, tiles), THREADS, smem, stream>>>(
      a, (const float*)lse, (const T*)g, (T*)dq, (T*)dk, (T*)dv, (float*)parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  const size_t n = (size_t)B * a.S * a.E;
  const size_t want = (n + THREADS - 1) / THREADS;
  add_parts_kernel<T><<<dim3((unsigned)(want < 4096 ? want : 4096), 2), THREADS, 0,
                        stream>>>((const float*)parts, (T*)dk, (T*)dv, tiles, n);
  return cudaGetLastError();
}

template <class T>
cudaError_t fwd_typed(const Args& a, void* out, void* lse, int B, int H, int smem,
                      cudaStream_t stream) {
  if (a.dh <= 16) return launch_fwd<T, Tiles16>(a, out, lse, B, H, smem, stream);
  if (a.dh <= 32) return launch_fwd<T, Tiles32>(a, out, lse, B, H, smem, stream);
  if (a.dh <= 64) return launch_fwd<T, Tiles64>(a, out, lse, B, H, smem, stream);
  if (a.dh <= 128) return launch_fwd<T, Tiles128>(a, out, lse, B, H, smem, stream);
  return launch_fwd<T, Tiles256>(a, out, lse, B, H, smem, stream);
}

template <class T>
cudaError_t bwd_typed(const Args& a, const void* lse, const void* g, void* dq,
                      void* dk, void* dv, void* parts, int B, int H, int smem,
                      cudaStream_t stream) {
#define NIC_FGEN_BWD(TL) launch_bwd<T, TL>(a, lse, g, dq, dk, dv, parts, B, H, smem, stream)
  if (a.dh <= 16) return NIC_FGEN_BWD(Tiles16);
  if (a.dh <= 32) return NIC_FGEN_BWD(Tiles32);
  if (a.dh <= 64) return NIC_FGEN_BWD(Tiles64);
  if (a.dh <= 128) return NIC_FGEN_BWD(Tiles128);
  return NIC_FGEN_BWD(Tiles256);
#undef NIC_FGEN_BWD
}

// Whether a call's shapes, plan and scratch are ones the kernels take.
inline bool call_ok(int dtype, int B, int T, int S, int E, int H, int smem,
                    bool backward, bool has_parts, int h0, int heads_total) {
  if (dtype < 0 || dtype > 1 || B < 1 || T < 1 || S < 1 || H < 1 || E % H != 0 ||
      E / H > MAX_HEAD || B > 65535 || h0 < 0 || heads_total < h0 + H)
    return false;
  int rows, keys, want;
  plan_of(E / H, backward, rows, keys, want);
  if (cdiv(T, rows) > 65535 || smem != want || smem > MAX_SMEM_BYTES) return false;
  return !backward || (T > rows) == has_parts;
}

}  // namespace fgen
}  // namespace nic

// out [B, T, E] and lse [B, H, T] (fp32) of flash cross-attention of q
// over k, v [B, S, E] with key bias [B, S] (fp32) and the int32 seed at
// `seed` (device memory); q, k, v and out of the dtype (0 bf16, 1 fp32),
// any T, S >= 1, E / H in 1..256. threshold = floor(p 2^32) (0: no
// dropout), scale = 1 / (1 - p); row0, h0 and heads_total as
// nic_flash_fwd's. `smem` must equal the plan's (fgen::plan_of).
// Returns a cudaError_t.
extern "C" int nic_flash_fwd_generic(int dtype, const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* seed, void* out, void* lse, int B,
                                     int T, int S, int E, int H, unsigned threshold,
                                     float scale, int smem, int row0, int h0,
                                     int heads_total, void* stream) {
  using namespace nic::fgen;
  if (!call_ok(dtype, B, T, S, E, H, smem, false, false, h0, heads_total))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const float*)bias, (const int*)seed, T, S, E, E / H,
               threshold, scale, row0, h0, heads_total};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0 ? fwd_typed<nic::bf16>(a, out, lse, B, H, smem, st)
                          : fwd_typed<float>(a, out, lse, B, H, smem, st));
}

// dq [B, T, E], dk, dv [B, S, E] of the above, from its saved lse and
// the output gradient g [B, T, E] of the dtype. `smem` must equal the
// plan's; `parts`: fp32 scratch of 2 * ceil(T / rows) * B * S * E
// elements where T exceeds the plan's rows, else null. Returns a
// cudaError_t.
extern "C" int nic_flash_bwd_generic(int dtype, const void* q, const void* k,
                                     const void* v, const void* bias,
                                     const void* seed, const void* lse,
                                     const void* g, void* dq, void* dk, void* dv,
                                     void* parts, int B, int T, int S, int E, int H,
                                     unsigned threshold, float scale, int smem,
                                     int row0, int h0, int heads_total,
                                     void* stream) {
  using namespace nic::fgen;
  if (!call_ok(dtype, B, T, S, E, H, smem, true, parts != nullptr, h0, heads_total))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, (const float*)bias, (const int*)seed, T, S, E, E / H,
               threshold, scale, row0, h0, heads_total};
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == 0
                   ? bwd_typed<nic::bf16>(a, lse, g, dq, dk, dv, parts, B, H, smem, st)
                   : bwd_typed<float>(a, lse, g, dq, dk, dv, parts, B, H, smem, st));
}
