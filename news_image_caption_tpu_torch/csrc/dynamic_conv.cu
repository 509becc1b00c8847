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
// 10-12 us at 3.35 TB/s. At K = 31 the 2 K multiply-adds per output
// (0.52 GFLOP, kept as separate multiplies and adds, see below) take
// about as long at the card's fp32 rate. On an H100 SXM (700 W) this
// design runs at 14-38% of the byte floor (K = 31 to 3): about 20 us
// of staging plus 2.3 us per tap, the tap loop bound by issuing its
// shared-memory loads and fp32 instructions, not by bytes.
//
// Design: one block per (batch item, tile of up to 64 time rows, chunk
// of 128 channels). The block stages the tile's x rows plus the K - 1
// rows before it in shared memory (zeros before t = 0 and past T, so
// no padded copy of x exists in device memory), and the taps
// w[b, t, h, :] of the heads the chunk touches, as fp32. Each thread
// owns one channel pair (bf16x2 or float2 loads and stores) and walks
// every fourth row of the tile; each row's sum reads its K x rows from
// shared memory. The TPU kernel's sublane-aligned halo padding, its
// one-hot head-to-lane matmul and the tap-major transpose of w exist
// for the TPU's (8, 128) tiles and have no counterpart here: a thread
// finds its head as c / R.
//
// Numerics are the TPU kernel's: every product and the running sum in
// fp32, taps in order k = 0 .. K-1, one rounding to the output type at
// the store. Products and sums use __fmul_rn / __fadd_rn so that the
// compiler cannot contract them into fused multiply-adds; the result
// then equals the plain version's (ops/dynamic_conv.py) bit for bit.

#include "common.cuh"

namespace nic {

constexpr int DC_PAIRS = 64;                  // channel pairs per block
constexpr int DC_CHUNK = 2 * DC_PAIRS;        // channels per block
constexpr int DC_ROW_LANES = 4;               // rows processed side by side
constexpr int DC_THREADS = DC_PAIRS * DC_ROW_LANES;
constexpr int DC_MAX_ROWS = 64;               // time rows per block
constexpr int DC_MAX_TAPS = 31;
constexpr size_t DC_SMEM_BUDGET = 48 * 1024;  // no opt-in to more needed

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

// Heads that channels [c0, c0 + width) touch.
__host__ __device__ __forceinline__ int heads_touched(int c0, int width, int R) {
  return (c0 + width - 1) / R - c0 / R + 1;
}

// Shared memory of one block: the x window [rows + K - 1][DC_PAIRS]
// pairs, then the taps [rows][heads * K] fp32.
template <class T>
__host__ __device__ __forceinline__ size_t dc_smem_bytes(int rows, int K, int heads) {
  return sizeof(typename PairOf<T>::type) * (size_t)(rows + K - 1) * DC_PAIRS +
         sizeof(float) * (size_t)rows * heads * K;
}

// grid = (cdiv(T, rows), cdiv(C, DC_CHUNK), B); DC_THREADS threads.
template <class T>
__global__ void __launch_bounds__(DC_THREADS)
dynamic_conv_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                    int Tlen, int C, int H, int K, int rows) {
  using P = typename PairOf<T>::type;
  extern __shared__ __align__(16) unsigned char dc_smem[];
  const int b = blockIdx.z, t0 = blockIdx.x * rows, c0 = blockIdx.y * DC_CHUNK;
  const int R = C / H, halo = K - 1;
  const int npairs = min(DC_CHUNK, C - c0) / 2;
  const int h0 = c0 / R, nw = heads_touched(c0, 2 * npairs, R) * K;
  P* xs = reinterpret_cast<P*>(dc_smem);                              // [rows + halo][DC_PAIRS]
  float* ws = reinterpret_cast<float*>(xs + (size_t)(rows + halo) * DC_PAIRS);  // [rows][nw]

  const T* xb = x + (size_t)b * Tlen * C + c0;
  for (int i = threadIdx.x; i < (rows + halo) * DC_PAIRS; i += DC_THREADS) {
    const int r = i / DC_PAIRS, p = i % DC_PAIRS;
    const int t = t0 - halo + r;
    P v;
    store_pair(&v, 0.f, 0.f);
    if (t >= 0 && t < Tlen && p < npairs)
      v = *reinterpret_cast<const P*>(xb + (size_t)t * C + 2 * p);
    xs[i] = v;
  }
  // The taps of row t and heads h0 .. are nw contiguous elements of w.
  const T* wb = w + ((size_t)b * Tlen * H + h0) * K;
  const size_t w_row = (size_t)H * K;
  for (int i = threadIdx.x; i < rows * nw; i += DC_THREADS) {
    const int r = i / nw, j = i % nw;
    const int t = t0 + r;
    ws[i] = t < Tlen ? as_f(wb[(size_t)t * w_row + j]) : 0.f;
  }
  __syncthreads();

  const int p = threadIdx.x % DC_PAIRS;
  if (p >= npairs) return;
  const int c = c0 + 2 * p;
  const int ka = (c / R - h0) * K, kb = ((c + 1) / R - h0) * K;
  T* ob = out + (size_t)b * Tlen * C + c;
  for (int r = threadIdx.x / DC_PAIRS; r < rows && t0 + r < Tlen; r += DC_ROW_LANES) {
    const float* wr = ws + (size_t)r * nw;
    const P* xr = xs + (size_t)r * DC_PAIRS + p;  // x row t - K + 1 at k = 0
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < K; ++k) {
      const float2 xv = as_f2(xr[(size_t)k * DC_PAIRS]);
      sa = __fadd_rn(sa, __fmul_rn(wr[ka + k], xv.x));
      sb = __fadd_rn(sb, __fmul_rn(wr[kb + k], xv.y));
    }
    store_pair(reinterpret_cast<P*>(ob + (size_t)(t0 + r) * C), sa, sb);
  }
}

// Largest row tile (a power of two up to DC_MAX_ROWS) whose block fits
// in the shared-memory budget; 0 if none does.
template <class T>
int dc_rows(int K, int heads) {
  for (int rows = DC_MAX_ROWS; rows >= 1; rows /= 2)
    if (dc_smem_bytes<T>(rows, K, heads) <= DC_SMEM_BUDGET) return rows;
  return 0;
}

template <class T>
int launch_dynamic_conv(const void* x, const void* w, void* out, int B, int Tlen, int C,
                        int H, int K, cudaStream_t s) {
  const int R = C / H;
  int heads = 1;  // the most heads one chunk touches
  for (int c0 = 0; c0 < C; c0 += DC_CHUNK) {
    const int n = heads_touched(c0, C - c0 < DC_CHUNK ? C - c0 : DC_CHUNK, R);
    if (n > heads) heads = n;
  }
  const int rows = dc_rows<T>(K, heads);
  if (rows == 0) return (int)cudaErrorInvalidValue;
  dynamic_conv_kernel<T><<<dim3(cdiv(Tlen, rows), cdiv(C, DC_CHUNK), B), DC_THREADS,
                           dc_smem_bytes<T>(rows, K, heads), s>>>(
      (const T*)x, (const T*)w, (T*)out, Tlen, C, H, K, rows);
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}

}  // namespace nic

// out [B, T, C] = the causal dynamic conv of x [B, T, C] with taps
// w [B, T, H, K], all contiguous and of one type: elem_bytes 2 (bf16)
// or 4 (fp32). Needs T >= 1, 1 <= K <= 31, C even and divisible by H.
// Returns a cudaError_t.
extern "C" int nic_dynamic_conv_fwd(const void* x, const void* w, void* out, int B, int T,
                                    int C, int H, int K, int elem_bytes, void* stream) {
  if (B < 1 || T < 1 || H < 1 || C % H != 0 || C % 2 != 0 || K < 1 ||
      K > nic::DC_MAX_TAPS || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) return nic::launch_dynamic_conv<nic::bf16>(x, w, out, B, T, C, H, K, s);
  if (elem_bytes == 4) return nic::launch_dynamic_conv<float>(x, w, out, B, T, C, H, K, s);
  return (int)cudaErrorInvalidValue;
}
