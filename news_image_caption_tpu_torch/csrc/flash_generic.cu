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
// What bounds them on the card: at the fp32 flagship (B = 16, T = 63, 16
// heads of 64) the fp32 operations over the card's 67 TFLOP/s (2.1
// GFLOP forward and 5.3 backward in the article call, S' = 514; 0.2 and
// 0.5 in the image's, S' = 51), against 76 / 147 MB and 15 / 26 MB of
// bytes: the FFMA rate, if the products are fed from registers.
//
// The forward holds a block's score rows (flash_fwd_held_kernel), as the
// reference's _fwd_kernel holds its block's whole score row:
//   - grid (H, B, T tiles), 256 threads; a block owns R query rows of
//     one (head, item) and keeps their scores over all S' keys in shared
//     memory. It forms them once (q k^T, 128 keys a chunk), then each
//     row's maximum, exponentials, sum, lse and probabilities (dropout
//     scale, rounding to v's dtype) in place, then p v. That is two
//     products and one exponential an element, where a walk that keeps
//     no row forms q k^T twice. No online softmax: the probabilities are
//     normalised before they are rounded, as in the plain version.
//   - R follows S' (fwd_plan): the largest of 64, 32, 16 rows whose
//     rows, q tile, K / V ring and key bias fit the block's 227 KB; at
//     heads of 64, 64 rows hold S' up to 552 (the flagship's 514: 222 KB,
//     one block a multiprocessor, 256 blocks in two waves of 132 and
//     124; S' = 51: 102 KB, two blocks a multiprocessor, one wave), 32
//     rows up to 1,160, 16 rows up to 2,324; at heads of 256 (64-key
//     chunks), 16 rows up to 1,212. Past that limit (even 16 rows cannot
//     hold a row) the forward walks the keys twice
//     (flash_fwd_generic_kernel below).
//   - K and then V chunks stream through one ring of 3 slots (2 where 3
//     do not fit or S' is one chunk) filled by 16-byte cp.async copies
//     in fp32 (4-byte copies where a head's rows are not 16-byte
//     aligned; bf16 is widened through registers), so the next chunk
//     lands while this one is multiplied, and V's first chunk lands
//     during the softmax.
//   - Operands lie in shared memory as fp32 rows ([row][d], 4 floats of
//     padding a row, so 4 or 8 lanes reading 4 or 8 rows hit distinct
//     bank groups). Each thread holds a register tile fed by 16-byte
//     loads along d: for q k^T, 8 rows x 4 keys at 64 rows (R / 8 x 4
//     below), warps 2 x 4 over rows and keys, lanes 4 x 8, so a load of
//     q serves 4 addresses and one of K 8, one shared-memory wavefront
//     each, 12 loads for 128 FFMA; each score sums d in order, as the
//     backward's walk does, so the forward's lse cancels the backward's
//     scores exactly. For p v, 8 rows x 4 columns, 4 keys of p a load,
//     the warp's key slices added by shuffles in one order. The softmax
//     takes a warp's rows side by side.
// The backward keeps the two walks below: R x 64 tiles of fp32 operands,
// transposed ([d][row], [d][key], rows padded by one float), a register
// tile a thread (scores RPT rows x KPT keys, dq RPT x CPT, a chunk's dk
// or dv KPT x CPT), 16 x 16 threads a block:
//   - walk 1 forms probs = exp(s - lse) and dp, adds delta and writes the
//     chunk's dv = dropped^T g; walk 2 forms ds, adds dq = ds k in
//     registers and writes the chunk's dk = ds^T q. T > ROWS: each T tile
//     writes fp32 parts of dk and dv that a second kernel adds in tile
//     order. The two-walk forward has the same tiles: walk 1 keeps each
//     row's maximum and sum of exponentials (rescaled as the maximum
//     grows), walk 2 forms the probabilities and adds p v.
// Every sum has a fixed order: no atomics, two calls on the same inputs
// give the same bits. Query rows past T are zeros (lse +inf in the
// backward: probs 0), keys past S' weigh 0, and a padded key (bias
// -1e9) is a key like any other, as in the plain versions.

#include <type_traits>

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

// ---------------------------------------------------------------------------
// The held-row forward.

constexpr int HELD_PAD = 4;     // floats after each row of q, K or V

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Keys a chunk of the ring at head width W: 128, or 64 at 256 (two
// slots of 128 keys would not fit).
__host__ __device__ __forceinline__ int held_keys(int W) { return W == 256 ? 64 : 128; }

// Floats of dynamic shared memory of a held-row block: q [R][W + 4],
// the ring [stages][keys][W + 4], the key bias [S4], the score rows
// [R][S4 + 4] (S4 = S' rounded up to 4).
__host__ __device__ inline int held_smem_floats(int W, int R, int S, int stages) {
  const int P = W + HELD_PAD, S4 = round4(S);
  return R * P + stages * held_keys(W) * P + S4 + R * (S4 + 4);
}

// Whether a block of R rows exists at head width W (an instantiation
// below): 64 rows up to heads of 128, 32 and 16 rows at every width.
__host__ __device__ inline bool held_rows_ok(int W, int R) {
  return (R == 64 && W <= 128) || R == 32 || R == 16;
}

// The width class of head size dh (1..256).
__host__ __device__ inline int width_of(int dh) {
  return dh <= 16 ? 16 : dh <= 32 ? 32 : dh <= 64 ? 64 : dh <= 128 ? 128 : 256;
}

// The forward's plan: rows a block, ring slots (0: the two walks) and
// dynamic shared memory in bytes; the host's ops/flash_attention.py::
// generic_flash_plan mirrors it.
struct FwdPlan {
  int rows, stages, smem;
};

inline FwdPlan fwd_plan(int dh, int S) {
  const int W = width_of(dh);
  for (int R = 64; R >= 16; R /= 2) {
    if (!held_rows_ok(W, R)) continue;
    // Slots: 3, or 2 where 3 do not fit or the call has two chunks.
    for (int stages = min(3, 2 * cdiv(S, held_keys(W))); stages >= 2; --stages) {
      const long long bytes = 4LL * held_smem_floats(W, R, S, stages);
      if (bytes <= MAX_SMEM_BYTES) return {R, stages, (int)bytes};
    }
  }
  FwdPlan p{0, 0, 0};
  int keys;
  plan_of(dh, false, p.rows, keys, p.smem);
  return p;
}

// A held-row block's shape: W the head width, R rows, KC keys a chunk.
// Scores: warps 2 (rows) x 4 (keys), a warp 4 row groups x 8 key groups
// of lanes, a thread TR rows (rg + 4 i) x TK keys (kg + 8 j), each score
// summed over all of d in order (as the backward's walk sums it, so the
// lse cancels the backward's scores exactly); a load of q serves 4
// addresses and one of K 8, both a single shared-memory wavefront.
// Values: CQ warps a row group of 8 rows, each CW columns; a lane 4
// columns of a column quad (CG a warp) and a key slice (KS a warp).
template <int W_, int R_>
struct Held {
  static constexpr int W = W_, R = R_, P = W + HELD_PAD, KC = W == 256 ? 64 : 128;
  static constexpr int TR = R / 8, TK = KC / 32, QUADS = W / 4;
  static constexpr int CQ = 64 / R, CW = W / CQ, CG = CW / 4, KS = 32 / CG;
  static_assert(TR * 8 == R && TK * 32 == KC, "2 x 4 warps of 4 x 8 lanes");
  static_assert(CG >= 1 && CG <= 32 && CG * KS == 32, "a warp of column quads");
};

// Rows [0, valid) of N rows of dh elements, E apart in device memory,
// into dst[row * (W + 4) + d] as fp32, zeros past `valid` and past dh
// up to W. fp32 goes by cp.async (16 bytes where `vec`, else 4), bf16
// through registers; the caller commits and waits.
template <class T, int N, int W>
__device__ __forceinline__ void copy_rows(float* dst, const T* src, int E, int valid,
                                          int dh, bool vec) {
  constexpr int P = W + HELD_PAD, QUADS = W / 4;
  for (int e = threadIdx.x; e < N * QUADS; e += THREADS) {
    const int row = e / QUADS, c = (e % QUADS) * 4;
    float* d = dst + row * P + c;
    if (row >= valid || c >= dh) {
      zero16(d);
      continue;
    }
    const T* s = src + (size_t)row * E + c;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        cp_async16(d, s);
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (c + i < dh) cp_async4(d + i, s + i);
        else d[i] = 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = c + i < dh ? ld(s + i) : 0.f;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[i][j] = q[r0 + 4 i] . k[k0 + 8 j] over d in order, for the key
// columns j < jn (all of them where WHOLE).
template <class HL, bool WHOLE>
__device__ __forceinline__ void scores_walk(float (&acc)[HL::TR][HL::TK], const float* qs,
                                            const float* kc, int r0, int k0, int jn) {
  constexpr int P = HL::P, TR = HL::TR, TK = HL::TK;
#pragma unroll 1
  for (int m = 0; m < HL::QUADS; ++m) {
    float4 qv[TR], kv[TK];
#pragma unroll
    for (int i = 0; i < TR; ++i) qv[i] = ld4(qs + (r0 + 4 * i) * P + 4 * m);
#pragma unroll
    for (int j = 0; j < TK; ++j)
      if (WHOLE || j < jn) kv[j] = ld4(kc + (k0 + 8 * j) * P + 4 * m);
#pragma unroll
    for (int j = 0; j < TK; ++j) {
      if (!WHOLE && j >= jn) continue;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        float a = acc[i][j];
        a = fmaf(qv[i].x, kv[j].x, a);
        a = fmaf(qv[i].y, kv[j].y, a);
        a = fmaf(qv[i].z, kv[j].z, a);
        acc[i][j] = fmaf(qv[i].w, kv[j].w, a);
      }
    }
  }
}

// Scores, one chunk of K at `kc` (keys [s0, s0 + n)): q k^T + bias into
// sc[row][s0 + key] for keys below S'.
template <class HL>
__device__ __forceinline__ void held_scores(const float* qs, const float* kc,
                                            const float* bs, float* sc, int SP, int s0,
                                            int n, int S) {
  constexpr int TR = HL::TR, TK = HL::TK;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = (warp >> 2) * (HL::R / 2) + (lane >> 3);
  const int k0 = (warp & 3) * (HL::KC / 4) + (lane & 7);
  // Key columns j whose keys k0 - (lane & 7) + 8 j .. are below n (the
  // same for the whole warp).
  const int jn = max(0, min(TK, (n - (k0 - (lane & 7)) + 7) >> 3));
  if (jn == 0) return;
  float acc[TR][TK] = {};
  // A whole chunk's columns without a guard; the last chunk's with one.
  if (jn == TK) scores_walk<HL, true>(acc, qs, kc, r0, k0, jn);
  else scores_walk<HL, false>(acc, qs, kc, r0, k0, jn);
#pragma unroll
  for (int j = 0; j < TK; ++j) {
    const int key = s0 + k0 + 8 * j;
    if (j >= jn || key >= S) continue;
    const float b = bs[key];
#pragma unroll
    for (int i = 0; i < TR; ++i) sc[(r0 + 4 * i) * SP + key] = acc[i][j] + b;
  }
}

// Softmax: each row's maximum, exponentials and their sum (lanes in key
// order, then the warp's tree), lse of the valid rows, and the
// probabilities exp(s - max) times 1 / sum times the dropout scale,
// rounded to T, in place; zeros at keys [S', S4). Warp w takes rows w +
// 8 i, i < RPW, side by side, so their reductions overlap.
template <class T, int RPW>
__device__ __forceinline__ void held_softmax(float* sc, int SP, int S, int rows,
                                             const Args& a, uint32_t key, int t0,
                                             float* lse_row) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* row = sc + warp * SP;
  constexpr int STEP = THREADS / 32;   // rows between a warp's rows
  float mx[RPW], sum[RPW], inv[RPW];
  uint32_t rk[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) mx[i] = -INFINITY, sum[i] = 0.f;
  // Each pass loads the rows' values before it stores any, so the rows'
  // chains overlap.
  for (int j = lane; j < S; j += 32)
#pragma unroll
    for (int i = 0; i < RPW; ++i) mx[i] = fmaxf(mx[i], row[i * STEP * SP + j]);
#pragma unroll
  for (int i = 0; i < RPW; ++i) mx[i] = warp_max(mx[i]);
  for (int j = lane; j < S; j += 32) {
    float e[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) e[i] = row[i * STEP * SP + j];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      e[i] = expf(e[i] - mx[i]);
      sum[i] += e[i];
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) row[i * STEP * SP + j] = e[i];
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    sum[i] = warp_sum(sum[i]);
    inv[i] = 1.f / sum[i];
    rk[i] = row_key(key, t0 + warp + STEP * i);
  }
  for (int j = lane; j < S; j += 32) {
    float e[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) e[i] = row[i * STEP * SP + j];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      row[i * STEP * SP + j] =
          round_to<T>(e[i] * inv[i] * drop_scale(rk[i], j, a.threshold, a.scale));
  }
  for (int j = S + lane; j < round4(S); j += 32)
#pragma unroll
    for (int i = 0; i < RPW; ++i) row[i * STEP * SP + j] = 0.f;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < RPW; ++i)
      if (warp + STEP * i < rows) lse_row[warp + STEP * i] = mx[i] + logf(sum[i]);
}

// Values, one chunk of V at `vc` (keys [s0, s0 + n)): o += p v for the
// thread's 8 rows x 4 columns over its key slice's quads.
template <class HL>
__device__ __forceinline__ void held_values(float (&o)[8][4], const float* sc, int SP,
                                            const float* vc, int s0, int n) {
  constexpr int P = HL::P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rg = warp / HL::CQ, cp = warp % HL::CQ;
  const int cg = lane % HL::CG, ks = lane / HL::CG;
  const int col = cp * HL::CW + 4 * cg, nq = (n + 3) >> 2;
  const float* pr = sc + rg * 8 * SP + s0;
#pragma unroll 1
  for (int qd = ks; qd < nq; qd += HL::KS) {
    float4 pv[8], vv[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) pv[i] = ld4(pr + i * SP + 4 * qd);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) vv[kk] = ld4(vc + (4 * qd + kk) * P + col);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o[i][0] = fmaf(pv[i].w, vv[3].x, fmaf(pv[i].z, vv[2].x,
                fmaf(pv[i].y, vv[1].x, fmaf(pv[i].x, vv[0].x, o[i][0]))));
      o[i][1] = fmaf(pv[i].w, vv[3].y, fmaf(pv[i].z, vv[2].y,
                fmaf(pv[i].y, vv[1].y, fmaf(pv[i].x, vv[0].y, o[i][1]))));
      o[i][2] = fmaf(pv[i].w, vv[3].z, fmaf(pv[i].z, vv[2].z,
                fmaf(pv[i].y, vv[1].z, fmaf(pv[i].x, vv[0].z, o[i][2]))));
      o[i][3] = fmaf(pv[i].w, vv[3].w, fmaf(pv[i].z, vv[2].w,
                fmaf(pv[i].y, vv[1].w, fmaf(pv[i].x, vv[0].w, o[i][3]))));
    }
  }
}

// grid (H, B, T tiles of HL::R), THREADS threads, dynamic shared memory
// held_smem_floats(W, R, S, stages) floats; stages 2 or 3. At most 128
// registers a thread, so two blocks share a multiprocessor where their
// shared memory fits (S' = 51 at heads of 64).
template <class T, class HL>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_held_kernel(Args a, T* __restrict__ out, float* __restrict__ lse, int stages,
                      bool vec) {
  constexpr int W = HL::W, R = HL::R, P = HL::P, KC = HL::KC;
  extern __shared__ __align__(16) float sm[];
  const int S4 = round4(a.S), SP = S4 + 4;
  float* qs = sm;                           // [R][P]
  float* ring = qs + R * P;                 // [stages][KC][P]
  float* bs = ring + stages * KC * P;       // [S4]
  float* sc = bs + S4;                      // [R][SP]
  const int tid = threadIdx.x;
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int t0 = blockIdx.z * R, rows = min(R, a.T - t0);
  const size_t qoff = ((size_t)b * a.T + t0) * a.E + (size_t)head * a.dh;
  const size_t koff = (size_t)b * a.S * a.E + (size_t)head * a.dh;
  const T* kb = (const T*)a.k + koff;
  const T* vb = (const T*)a.v + koff;
  const float* bb = a.bias + (size_t)b * a.S;
  const int nc = cdiv(a.S, KC), items = 2 * nc;
  NIC_PHASE(0);
  // Item i < nc is K's chunk i, else V's chunk i - nc, into slot i % stages.
  auto issue = [&](int i) {
    if (i < items) {
      const int s0 = (i < nc ? i : i - nc) * KC;
      copy_rows<T, KC, W>(ring + (i % stages) * KC * P,
                          (i < nc ? kb : vb) + (size_t)s0 * a.E, a.E,
                          min(KC, a.S - s0), a.dh, vec);
    }
    cp_async_commit();
  };
  copy_rows<T, R, W>(qs, (const T*)a.q + qoff, a.E, rows, a.dh, vec);   // in group 0
  for (int j = tid; j < S4; j += THREADS) bs[j] = j < a.S ? bb[j] : 0.f;
  for (int i = 0; i < stages - 1; ++i) issue(i);
  const uint32_t key = dropout_key(a.seed[0], b, a.row0, a.heads_total, a.h0, head);
  for (int i = 0; i < nc; ++i) {
    issue(i + stages - 1);            // into the slot item i - 1 freed
    cp_async_wait_upto(stages - 1);   // item i has landed
    __syncthreads();
    held_scores<HL>(qs, ring + (i % stages) * KC * P, bs, sc, SP, i * KC,
                    min(KC, a.S - i * KC), a.S);
    __syncthreads();                  // the slot is read
  }
  NIC_PHASE(1);
  held_softmax<T, R / 8>(sc, SP, a.S, rows, a, key, t0,
                         lse + ((size_t)b * H + head) * a.T + t0);
  __syncthreads();
  NIC_PHASE(2);
  float o[8][4] = {};
  for (int i = nc; i < items; ++i) {
    issue(i + stages - 1);
    cp_async_wait_upto(stages - 1);
    __syncthreads();
    const int s0 = (i - nc) * KC;
    held_values<HL>(o, sc, SP, ring + (i % stages) * KC * P, s0, min(KC, a.S - s0));
    __syncthreads();
  }
  NIC_PHASE(3);
  // The warp's key slices, added by the same tree in every lane; row i
  // is written by the lanes of key slice i % KS.
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = HL::CG; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[i][c] += __shfl_xor_sync(FULL_MASK, o[i][c], off);
  const int rg = warp / HL::CQ, cp = warp % HL::CQ;
  const int ks = lane / HL::CG, col = cp * HL::CW + 4 * (lane % HL::CG);
  T* ob = out + qoff;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rg * 8 + i;
    if (r >= rows || ks != i % HL::KS) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (col + c < a.dh) ob[(size_t)r * a.E + col + c] = store_as<T>(o[i][c]);
  }
  NIC_PHASE(4);
}

template <class T, class HL>
cudaError_t launch_held(const Args& a, void* out, void* lse, int B, int H,
                        const FwdPlan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_held_kernel<T, HL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         p.smem);
  if (err != cudaSuccess) return err;
  const bool vec = ((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v) % 16 == 0 &&
                   a.dh % 4 == 0 && a.E % 4 == 0;
  flash_fwd_held_kernel<T, HL><<<dim3(H, B, cdiv(a.T, HL::R)), THREADS, p.smem,
                                 stream>>>(a, (T*)out, (float*)lse, p.stages, vec);
  return cudaGetLastError();
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
cudaError_t fwd_typed(const Args& a, void* out, void* lse, int B, int H,
                      const FwdPlan& p, cudaStream_t stream) {
  if (p.stages == 0) {   // the two walks
    if (a.dh <= 16) return launch_fwd<T, Tiles16>(a, out, lse, B, H, p.smem, stream);
    if (a.dh <= 32) return launch_fwd<T, Tiles32>(a, out, lse, B, H, p.smem, stream);
    if (a.dh <= 64) return launch_fwd<T, Tiles64>(a, out, lse, B, H, p.smem, stream);
    if (a.dh <= 128) return launch_fwd<T, Tiles128>(a, out, lse, B, H, p.smem, stream);
    return launch_fwd<T, Tiles256>(a, out, lse, B, H, p.smem, stream);
  }
#define NIC_FGEN_HELD(W, R)                                         \
  if (width_of(a.dh) == W && p.rows == R)                           \
    return launch_held<T, Held<W, R>>(a, out, lse, B, H, p, stream)
  NIC_FGEN_HELD(16, 64);
  NIC_FGEN_HELD(16, 32);
  NIC_FGEN_HELD(16, 16);
  NIC_FGEN_HELD(32, 64);
  NIC_FGEN_HELD(32, 32);
  NIC_FGEN_HELD(32, 16);
  NIC_FGEN_HELD(64, 64);
  NIC_FGEN_HELD(64, 32);
  NIC_FGEN_HELD(64, 16);
  NIC_FGEN_HELD(128, 64);
  NIC_FGEN_HELD(128, 32);
  NIC_FGEN_HELD(128, 16);
  NIC_FGEN_HELD(256, 32);
  NIC_FGEN_HELD(256, 16);
#undef NIC_FGEN_HELD
  return cudaErrorInvalidValue;
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
  if (backward) {
    plan_of(E / H, true, rows, keys, want);
  } else {
    const FwdPlan p = fwd_plan(E / H, S);
    rows = p.rows, want = p.smem;
  }
  if (cdiv(T, rows) > 65535 || smem != want || smem > MAX_SMEM_BYTES) return false;
  return !backward || (T > rows) == has_parts;
}

}  // namespace fgen
}  // namespace nic

NIC_DEFINE_PHASE_READER(nic_flash_generic_phases)

// out [B, T, E] and lse [B, H, T] (fp32) of flash cross-attention of q
// over k, v [B, S, E] with key bias [B, S] (fp32) and the int32 seed at
// `seed` (device memory); q, k, v and out of the dtype (0 bf16, 1 fp32),
// any T, S >= 1, E / H in 1..256. threshold = floor(p 2^32) (0: no
// dropout), scale = 1 / (1 - p); row0, h0 and heads_total as
// nic_flash_fwd's. `smem` must equal the plan's (fgen::fwd_plan: the
// held rows, or the two walks past their limit). Returns a cudaError_t.
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
  const FwdPlan p = fwd_plan(E / H, S);
  return (int)(dtype == 0 ? fwd_typed<nic::bf16>(a, out, lse, B, H, p, st)
                          : fwd_typed<float>(a, out, lse, B, H, p, st));
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
