// Device helpers shared by the port's decode kernels.
//
// Every kernel here does its products through `block_matmul`: a block
// of (BM / TM) * (BN / TN) threads stages BK-deep slices of both
// operands in shared memory (as fp32) and accumulates a BM x BN tile
// in fp32 registers with plain FMA. Decode runs at a few rows (N = the
// request batch), where the card is bound by reading the weights once,
// not by arithmetic; tensor-core products (wgmma) and TMA staging are
// left for the PRs that make these kernels fast.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nic {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BIG_ID = 1 << 30;  // id of an empty top-k slot

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }
// Round to bf16 and back: the bf16 rounding points of the reference.
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Shape of one block_matmul tile. Thread t owns rows
// ty + i * TY (i < TM) and columns tx + j * TX (j < TN) of the tile,
// with tx = t % TX and ty = t / TX.
template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  // A slice [BK][BM + 1] and B slice [BK][BN + 1]; the +1 keeps both
  // the k-fast stores and the row reads free of bank conflicts.
  static constexpr int SMEM_FLOATS = BK * (BM + 1) + BK * (BN + 1);
  static_assert(BM % TM == 0 && BN % TN == 0, "tile must divide evenly");
  static_assert(THREADS % 32 == 0, "tile must be whole warps");
};

template <class T>
__device__ __forceinline__ int tile_row(int i) {
  return (int)threadIdx.x / T::TX + i * T::TY;
}

template <class T>
__device__ __forceinline__ int tile_col(int j) {
  return (int)threadIdx.x % T::TX + j * T::TX;
}

// acc[i][j] += sum over k < K of A(tile_row(i), k) * B(k, tile_col(j)).
// load_a(m, k) and load_b(k, n) return one operand element as fp32, and
// 0 outside the matrix. KN_B says how B lies in memory: true for [K, N]
// row-major (n contiguous), false for [N, K] row-major (k contiguous);
// the staging walks the contiguous index fastest so that global reads
// coalesce. Each thread issues all its loads of a BK slice into
// registers before storing them, and fetches the next slice while the
// block multiplies the current one, so a slice costs about one memory
// latency instead of one per element. Every thread of the block
// (exactly T::THREADS, 1-D) must call it. smem holds T::SMEM_FLOATS
// floats.
template <class T, bool KN_B, class LoadA, class LoadB>
__device__ __forceinline__ void block_matmul(float (&acc)[T::TM][T::TN],
                                             int K, LoadA load_a,
                                             LoadB load_b, float* smem) {
  constexpr int A_ITEMS = T::BM * T::BK / T::THREADS;
  constexpr int B_ITEMS = T::BK * T::BN / T::THREADS;
  static_assert(A_ITEMS * T::THREADS == T::BM * T::BK &&
                    B_ITEMS * T::THREADS == T::BK * T::BN,
                "tile slices must divide evenly among the threads");
  float* As = smem;
  float* Bs = smem + T::BK * (T::BM + 1);
  const int tid = threadIdx.x;
  const int tx = tid % T::TX, ty = tid / T::TX;
  float ra[A_ITEMS], rb[B_ITEMS];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int r = 0; r < A_ITEMS; ++r) {
      const int i = tid + r * T::THREADS;
      ra[r] = load_a(i / T::BK, k0 + i % T::BK);
    }
#pragma unroll
    for (int r = 0; r < B_ITEMS; ++r) {
      const int i = tid + r * T::THREADS;
      rb[r] = KN_B ? load_b(k0 + i / T::BN, i % T::BN)
                   : load_b(k0 + i % T::BK, i / T::BK);
    }
  };
  if (K > 0) fetch(0);
  for (int k0 = 0; k0 < K; k0 += T::BK) {
#pragma unroll
    for (int r = 0; r < A_ITEMS; ++r) {
      const int i = tid + r * T::THREADS;
      As[(i % T::BK) * (T::BM + 1) + i / T::BK] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < B_ITEMS; ++r) {
      const int i = tid + r * T::THREADS;
      const int k = KN_B ? i / T::BN : i % T::BK;
      const int n = KN_B ? i % T::BN : i / T::BK;
      Bs[k * (T::BN + 1) + n] = rb[r];
    }
    __syncthreads();
    if (k0 + T::BK < K) fetch(k0 + T::BK);
#pragma unroll 4
    for (int k = 0; k < T::BK; ++k) {
      float a[T::TM], b[T::TN];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) a[i] = As[k * (T::BM + 1) + ty + i * T::TY];
#pragma unroll
      for (int j = 0; j < T::TN; ++j) b[j] = Bs[k * (T::BN + 1) + tx + j * T::TX];
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
#pragma unroll
        for (int j = 0; j < T::TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Best (value, id) across the warp: larger value first, then the lower
// id (the lax.top_k tie rule). Every lane gets the winner.
__device__ __forceinline__ void warp_argmax(float& v, int& id) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, v, o);
    const int oi = __shfl_xor_sync(FULL_MASK, id, o);
    if (ov > v || (ov == v && oi < id)) {
      v = ov;
      id = oi;
    }
  }
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at
// most 1024). scratch holds 32 floats / ints; every thread gets the
// result.
__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  v = warp_max(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : -INFINITY;
  v = warp_max(v);
  __syncthreads();
  return v;
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  v = warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = lane < nwarps ? scratch[lane] : 0.f;
  v = warp_sum(v);
  __syncthreads();
  return v;
}

__device__ __forceinline__ void block_argmax(float& v, int& id, float* sv,
                                             int* si) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  warp_argmax(v, id);
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = id;
  }
  __syncthreads();
  v = lane < nwarps ? sv[lane] : -INFINITY;
  id = lane < nwarps ? si[lane] : BIG_ID;
  warp_argmax(v, id);
  __syncthreads();
}

}  // namespace nic

// Return the launch error, if any, from a C entry point.
#define NIC_RETURN_IF_LAUNCH_FAILED()          \
  do {                                         \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
