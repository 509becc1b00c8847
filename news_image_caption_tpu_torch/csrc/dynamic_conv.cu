// Causal dynamic depthwise convolution over a whole sequence, forward
// only:
//   out[b, t, c] = sum_k w[b, t, c / R, k] * x[b, t - K + 1 + k, c],
// x, out [B, T, C]; w [B, T, H, K] (the per-position taps, already
// normalised); R = C / H channels per head; rows before t = 0 read as
// zeros. x and w are both bf16 or both fp32.
//
// Replaces: news_image_caption_tpu/ops/pallas_kernels.py
// dynamic_conv_pallas (_dynconv_kernel).
//
// What bounds it on the card: every x, w and out element is touched
// once, so the floor is bytes: at B = 16, T = 512, C = 1024, H = 16 in
// bf16, 16.8 MB of x, 0.8-8.1 MB of w (K = 3-31) and 16.8 MB of out,
// 10.3-12.4 us at 3.35 TB/s. At K = 31 the K multiply-adds an output
// (0.26 G fused multiply-adds) take 7.8 us at the card's fp32 rate, so
// the tap loop must issue little besides them to stay under the bytes.
//
// Design: one block of four warps per (batch item, segment of tiles of
// 4 M time rows, chunk of 64 channels); ops/dynamic_conv.py::
// dynamic_conv_plan chooses M, the segment (one or two tiles), the tap
// layouts and the instantiation, and this file
// checks the plan. A block issues every copy of its segment at once as
// `cp.async`, one group a tile, so a later tile's copies land under an
// earlier tile's sums: the x window (the segment's rows and the K - 1
// before them, zeros before t = 0 and past T) as 16-byte lines, and each
// row's taps as the 4-byte words of w that hold them (a head's taps start
// at byte 2 (t H + h) K, 4-byte aligned only for even (t H + h) K in
// bf16). x is read once inside a segment. No tap passes through a
// register on its way in: staging them through registers made a
// thread's global loads wait for one another, and the time grew with K
// (62.7 against 43.0 us at K=31, one tile a block; PERF.md §6). For
// K = 3, 7, 15 and 31
// (the flagship's layers) K and M = 16 are template parameters: a tile's
// taps are converted once to fp32 in a [rows][head slots][tap slots]
// layout, a row padded to a power of two of at least 4 so that it loads
// as float4 warp broadcasts (a warp's 32 channel pairs are one head at R
// = 64); a lane owns one channel pair and a warp 16 consecutive rows; the
// lane loads and converts the M + K - 1 x values of its window once each
// into registers, so an output costs K fused multiply-adds and about (M +
// K - 1) / M + K / 4 shared-memory loads for its two channels. Every
// other K (1..31) and an odd R (a pair whose channels lie in two heads)
// take the generic instantiation: K at run time, each channel's taps read
// from the staged words, x from shared memory for each tap. Index math is
// shifts: no division by a run-time value while staging. Blocks of 128
// threads under 48 KB of shared memory, four a multiprocessor. The TPU
// kernel's sublane-aligned halo padding, its one-hot head-to-lane matmul
// and the tap-major transpose of w exist for the TPU's (8, 128) tiles and
// have no counterpart here.
//
// What holds it (phase stamps, PERF.md §6): a block's reads and its
// sums and writes run one after the other. Issuing the copies stalls
// once the copy queue is full (1.7-4.4 us a block at K = 3-31), and the
// sums and writes take 4.1-10.3 us a block, at K=31 with four warps a
// scheduler to hide the fused multiply-adds' latency; 47-31% of the
// byte floor at K = 3-31.
//
// Numerics: every product and the running sum in fp32, taps in order k =
// 0 .. K-1, one rounding to the output type at the store, as the TPU
// kernel. Each tap is one fused multiply-add (fmaf), which rounds once
// where the plain version (ops/dynamic_conv.py) rounds the product and
// the sum apart: the fp32 sums differ by at most (2K + 1) 2^-24
// sum_k |w x|, and the output by that plus one unit in the last place of
// its type (`dynamic_conv_tolerance`). For bf16 inputs a product of two
// bf16 values is exact in fp32 (8 + 8 significant bits), so the fused
// and the separate sums are the same and the output equals the plain
// version bit for bit; fp32 inputs differ within the tolerance. Fused
// because separate products double the tap loop's floating-point
// instructions and measured 9% slower at K = 31 (PERF.md §6).

#include "common.cuh"

namespace nic {

constexpr int DC_PAIRS = 32;                  // channel pairs a block: a warp's lanes
constexpr int DC_CHUNK = 2 * DC_PAIRS;        // channels a block
constexpr int DC_WARPS = 4;                   // row groups a block, one warp each
constexpr int DC_THREADS = DC_PAIRS * DC_WARPS;
constexpr int DC_MAX_TAPS = 31;
constexpr int DC_FIXED_ROWS = 16;             // M of the instantiations K = 3, 7, 15, 31
constexpr int DC_MAX_ROWS = 16;               // the most rows a thread
constexpr int DC_MAX_TILES = 2;               // the most tiles a block walks
constexpr int DC_SMEM_BUDGET = 48 * 1024;     // no opt-in to more needed

template <class T>
struct PairOf;
template <>
struct PairOf<bf16> {
  using type = __nv_bfloat162;
};
template <>
struct PairOf<float> {
  using type = float2;
};

__device__ __forceinline__ float as_f(float v) { return v; }
__device__ __forceinline__ float as_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float2 as_f2(float2 v) { return v; }
__device__ __forceinline__ float2 as_f2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ void store_pair(float2* p, float a, float b) {
  *p = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat162* p, float a, float b) {
  *p = __floats2bfloat162_rn(a, b);
}

// Tap slots a row of the instantiation for K: a power of two, at least 4.
__host__ __device__ constexpr int dc_tap_slots(int K) {
  return K <= 4 ? 4 : K <= 8 ? 8 : K <= 16 ? 16 : 32;
}

// Heads that channels [c0, c0 + width) touch.
__host__ __device__ __forceinline__ int heads_touched(int c0, int width, int R) {
  return (c0 + width - 1) / R - c0 / R + 1;
}

// Shared memory of one block: the x window of its segment [tiles *
// rows + K - 1][DC_PAIRS] pairs, the segment's taps as they lie in w
// [tiles * rows][raw_slots] 4-byte words, then (K templated) one tile's
// taps as fp32 [rows][head slots][tap slots].
__host__ __device__ __forceinline__ int dc_smem_bytes(int rows, int tiles, int K,
                                                      int head_slots, int tap_slots,
                                                      int raw_slots, int elem_bytes,
                                                      bool fp32_taps) {
  return (tiles * rows + K - 1) * DC_CHUNK * elem_bytes + tiles * rows * raw_slots * 4 +
         (fp32_taps ? rows * head_slots * tap_slots * 4 : 0);
}

// grid = (cdiv(T, tiles * 4 M), cdiv(C, DC_CHUNK), B); DC_THREADS
// threads. A block walks a segment of `tiles` tiles of 4 M rows. KT = K
// and M = rows a thread as template parameters, or KT = 0: the generic
// instantiation (K and M at run time). `lines`: x rows move as 16-byte
// lines (C * sizeof(T) a multiple of 16, x 16-byte aligned); else as
// pairs. `w_words`: the 4-byte words that hold w.
template <class T, int KT, int M>
__global__ void __launch_bounds__(DC_THREADS, 4)
dynamic_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int Tlen, int C, int H, int K, int rows_per_thread, int tiles,
                    int log_heads, int log_taps, int log_raw, int lines, long long w_words) {
  using P = typename PairOf<T>::type;
  constexpr int ES = sizeof(T);
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int rows = DC_WARPS * rows_per_thread, seg = tiles * rows;
  const int b = blockIdx.z, t0 = blockIdx.x * seg, c0 = blockIdx.y * DC_CHUNK;
  const int halo = K - 1, R = C / H, h0 = c0 / R;
  const int width = min(DC_CHUNK, C - c0);                 // channels of this chunk
  const int nh = heads_touched(c0, width, R);
  P* xs = reinterpret_cast<P*>(dc_smem);                   // [seg + halo][DC_PAIRS]
  uint32_t* raw = reinterpret_cast<uint32_t*>(xs + (seg + halo) * DC_PAIRS);  // [seg][raw]
  float* ws = reinterpret_cast<float*>(raw + (seg << log_raw));  // [rows][heads][taps]
  NIC_PHASE(0);

  // Every copy of the segment at once, one group a tile: its x rows
  // (tile 0 with the K - 1 rows before it; zeros before t = 0 and past
  // T) and the words that hold its taps of heads h0 .. h0 + nh - 1.
  const T* xb = x + (size_t)b * Tlen * C + c0;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w);
  const int raw_mask = (1 << log_raw) - 1;
  for (int i = 0; i < tiles; ++i) {
    const int lo = i == 0 ? 0 : halo + i * rows, hi = halo + (i + 1) * rows;
    if (lines) {
      constexpr int LOG_LINES = ES == 2 ? 3 : 4;       // 16-byte lines a row: 8 or 16
      const int used = width * ES / 16;
      for (int j = threadIdx.x; j < (hi - lo) << LOG_LINES; j += DC_THREADS) {
        const int r = lo + (j >> LOG_LINES), l = j & ((1 << LOG_LINES) - 1);
        const int t = t0 - halo + r;
        unsigned char* dst = reinterpret_cast<unsigned char*>(xs + r * DC_PAIRS) + l * 16;
        if (t < 0 || t >= Tlen)
          zero16(dst);
        else if (l < used)
          cp_async16(dst, reinterpret_cast<const unsigned char*>(xb + (size_t)t * C) + l * 16);
      }
    } else {
      const int npairs = width / 2;
      for (int j = threadIdx.x; j < (hi - lo) * DC_PAIRS; j += DC_THREADS) {
        const int r = lo + (j >> 5), p = j & (DC_PAIRS - 1);
        const int t = t0 - halo + r;
        P v;
        store_pair(&v, 0.f, 0.f);
        if (t >= 0 && t < Tlen && p < npairs)
          v = *reinterpret_cast<const P*>(xb + (size_t)t * C + 2 * p);
        xs[r * DC_PAIRS + p] = v;
      }
    }
    // Row t's taps start at element e0 = ((b T + t) H + h0) K of w; the
    // words from e0 * ES / 4 on hold them, the first at element e0 % 2
    // of its word where ES = 2.
    for (int j = threadIdx.x; j < rows << log_raw; j += DC_THREADS) {
      const int r = i * rows + (j >> log_raw), q = j & raw_mask;
      const int t = t0 + r;
      const long long e0 = ((long long)(b * Tlen + t) * H + h0) * K;
      const long long first = e0 * ES / 4, end = ((e0 + (long long)nh * K) * ES + 3) / 4;
      if (t < Tlen && first + q < end) {
        uint32_t* dst = raw + (r << log_raw) + q;
        if (first + q < w_words)
          cp_async4(dst, w32 + first + q);
        else  // the last word of a bf16 w of odd length: its lower half
          *reinterpret_cast<T*>(dst) = *reinterpret_cast<const T*>(w32 + first + q);
      }
    }
    cp_async_commit();
  }
  NIC_PHASE(1);

  const int p = threadIdx.x & (DC_PAIRS - 1), r0 = (threadIdx.x >> 5) * rows_per_thread;
  const int c = c0 + 2 * p;
  const bool active = 2 * p < width;
  const int log_row = log_heads + log_taps;
  for (int i = 0; i < tiles && t0 + i * rows < Tlen; ++i) {
    if (i + 1 < tiles)  // tile i landed, tile i + 1 may still be in flight
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1
    if (i == 0) {
      NIC_PHASE(2);
    }
    const int ti = t0 + i * rows;                     // the tile's first row
    const P* xc = xs + (i * rows + r0) * DC_PAIRS + p;  // tap 0 of row r0
    T* ob = out + ((size_t)b * Tlen + ti) * C + c;
    if constexpr (KT > 0) {
      // The tile's taps as fp32 float4 rows, zeros in the padding, past
      // the chunk's heads and past T.
      for (int j = threadIdx.x; j < rows << log_row; j += DC_THREADS) {
        const int k = j & ((1 << log_taps) - 1);
        const int hh = (j >> log_taps) & ((1 << log_heads) - 1);
        const int r = j >> log_row, t = ti + r;
        float v = 0.f;
        if (k < KT && hh < nh && t < Tlen) {
          const int odd = ES == 2 ? (int)((((long long)(b * Tlen + t) * H + h0) * KT) & 1) : 0;
          const T* rt = reinterpret_cast<const T*>(raw + ((i * rows + r) << log_raw));
          v = as_f(rt[odd + hh * KT + k]);
        }
        ws[j] = v;
      }
      __syncthreads();
      if (active) {
        constexpr int TS = dc_tap_slots(KT);
        const float* wh = ws + ((c / R - h0) << log_taps);  // the pair's head (R even)
        float2 xv[M + KT - 1];
#pragma unroll
        for (int j = 0; j < M + KT - 1; ++j) xv[j] = as_f2(xc[j * DC_PAIRS]);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const float4* wr = reinterpret_cast<const float4*>(wh + ((r0 + m) << log_row));
          float sa = 0.f, sb = 0.f;
#pragma unroll
          for (int q = 0; q < TS / 4; ++q) {
            const float4 w4 = wr[q];
            const float wk[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (4 * q + u < KT) {
                sa = fmaf(wk[u], xv[m + 4 * q + u].x, sa);
                sb = fmaf(wk[u], xv[m + 4 * q + u].y, sb);
              }
            }
          }
          if (ti + r0 + m < Tlen)
            store_pair(reinterpret_cast<P*>(ob + (size_t)(r0 + m) * C), sa, sb);
        }
      }
    } else if (active) {
      // Each channel's taps straight from the words of w, x from shared
      // memory for each tap.
      const int ka = (c / R - h0) * K, kb = ((c + 1) / R - h0) * K;
      for (int m = 0; m < rows_per_thread && ti + r0 + m < Tlen; ++m) {
        const int t = ti + r0 + m;
        const int odd = ES == 2 ? (int)((((long long)(b * Tlen + t) * H + h0) * K) & 1) : 0;
        const T* rt = reinterpret_cast<const T*>(raw + ((i * rows + r0 + m) << log_raw)) + odd;
        const P* xr = xc + m * DC_PAIRS;
        float sa = 0.f, sb = 0.f;
        for (int k = 0; k < K; ++k) {
          const float2 xv = as_f2(xr[k * DC_PAIRS]);
          sa = fmaf(as_f(rt[ka + k]), xv.x, sa);
          sb = fmaf(as_f(rt[kb + k]), xv.y, sb);
        }
        store_pair(reinterpret_cast<P*>(ob + (size_t)(r0 + m) * C), sa, sb);
      }
    }
  }
  NIC_PHASE(3);
}

template <class T>
using DcKernel = void (*)(const T*, const T*, T*, int, int, int, int, int, int, int, int, int,
                          int, long long);

template <class T>
DcKernel<T> dc_kernel(int instance) {
  switch (instance) {
    case 0: return dynamic_conv_kernel<T, 0, 0>;
    case 3: return dynamic_conv_kernel<T, 3, DC_FIXED_ROWS>;
    case 7: return dynamic_conv_kernel<T, 7, DC_FIXED_ROWS>;
    case 15: return dynamic_conv_kernel<T, 15, DC_FIXED_ROWS>;
    case 31: return dynamic_conv_kernel<T, 31, DC_FIXED_ROWS>;
    default: return nullptr;
  }
}

inline bool dc_pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

inline int dc_log2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// Whether the plan is one this file runs for the shape.
inline bool dc_plan_ok(const void* x, int C, int H, int K, int elem_bytes, int tile_rows,
                       int rows_per_thread, int tiles, int channels, int head_slots,
                       int tap_slots, int raw_slots, int lines, int smem_bytes, int instance) {
  const int R = C / H;
  if (channels != DC_CHUNK || rows_per_thread < 1 || rows_per_thread > DC_MAX_ROWS ||
      tile_rows != DC_WARPS * rows_per_thread || tiles < 1 || tiles > DC_MAX_TILES)
    return false;
  int heads = 1;  // the most heads one chunk touches
  for (int c0 = 0; c0 < C; c0 += DC_CHUNK) {
    const int n = heads_touched(c0, C - c0 < DC_CHUNK ? C - c0 : DC_CHUNK, R);
    if (n > heads) heads = n;
  }
  if (!dc_pow2(tap_slots) || tap_slots < 4 || tap_slots < K || !dc_pow2(head_slots) ||
      head_slots < heads || !dc_pow2(raw_slots) ||
      raw_slots * 4 < (heads * K + 1) * elem_bytes)
    return false;
  if (smem_bytes != dc_smem_bytes(tile_rows, tiles, K, head_slots, tap_slots, raw_slots,
                                  elem_bytes, instance != 0) ||
      smem_bytes > DC_SMEM_BUDGET)
    return false;
  if (lines && ((C * elem_bytes) % 16 != 0 || (reinterpret_cast<uintptr_t>(x) & 15)))
    return false;
  if (reinterpret_cast<uintptr_t>(x) & (2 * elem_bytes - 1))  // pairs: one load each
    return false;
  if (instance != 0 && (instance != K || rows_per_thread != DC_FIXED_ROWS || R % 2 != 0 ||
                        tap_slots != dc_tap_slots(K)))
    return false;
  return true;
}

template <class T>
int launch_dynamic_conv(const void* x, const void* w, void* out, int B, int Tlen, int C,
                        int H, int K, int tile_rows, int rows_per_thread, int tiles,
                        int head_slots, int tap_slots, int raw_slots, int lines,
                        int smem_bytes, int instance, cudaStream_t s) {
  const DcKernel<T> kernel = dc_kernel<T>(instance);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const long long w_words = (long long)B * Tlen * H * K * (long long)sizeof(T) / 4;
  kernel<<<dim3(cdiv(Tlen, tiles * tile_rows), cdiv(C, DC_CHUNK), B), DC_THREADS, smem_bytes,
           s>>>((const T*)x, (const T*)w, (T*)out, Tlen, C, H, K, rows_per_thread, tiles,
                dc_log2(head_slots), dc_log2(tap_slots), dc_log2(raw_slots), lines, w_words);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace nic

NIC_DEFINE_PHASE_READER(nic_dynamic_conv_phases)

// out [B, T, C] = the causal dynamic conv of x [B, T, C] with taps
// w [B, T, H, K], all contiguous and of one type: elem_bytes 2 (bf16)
// or 4 (fp32). Needs T >= 1, 1 <= K <= 31, C even and divisible by H,
// and the plan of ops/dynamic_conv.py::dynamic_conv_plan for the shape:
// rows a tile and a thread, tiles a block, channels a block (64), head
// and tap slots of the fp32 tap layout, 4-byte words a row of the taps
// as staged, 16-byte lines or pairs for x, the block's shared memory and
// the instantiation (K, or 0 for the generic one). Returns a
// cudaError_t: cudaErrorInvalidValue for a shape or plan it does not run.
extern "C" int nic_dynamic_conv_fwd(const void* x, const void* w, void* out, int B, int T,
                                    int C, int H, int K, int elem_bytes, int tile_rows,
                                    int rows_per_thread, int tiles, int channels,
                                    int head_slots, int tap_slots, int raw_slots, int lines,
                                    int smem_bytes, int instance, void* stream) {
  if (B < 1 || T < 1 || H < 1 || C % H != 0 || C % 2 != 0 || K < 1 ||
      K > nic::DC_MAX_TAPS || B > 65535 || (elem_bytes != 2 && elem_bytes != 4) ||
      (reinterpret_cast<uintptr_t>(w) & 3) ||
      !nic::dc_plan_ok(x, C, H, K, elem_bytes, tile_rows, rows_per_thread, tiles, channels,
                       head_slots, tap_slots, raw_slots, lines, smem_bytes, instance))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    return nic::launch_dynamic_conv<nic::bf16>(x, w, out, B, T, C, H, K, tile_rows,
                                               rows_per_thread, tiles, head_slots, tap_slots,
                                               raw_slots, lines, smem_bytes, instance, s);
  return nic::launch_dynamic_conv<float>(x, w, out, B, T, C, H, K, tile_rows, rows_per_thread,
                                         tiles, head_slots, tap_slots, raw_slots, lines,
                                         smem_bytes, instance, s);
}
