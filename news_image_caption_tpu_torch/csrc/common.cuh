// Device helpers shared by the port's kernels.
//
// Every kernel of the port is built from them: `cp_async16` copies 16
// bytes from device memory straight into shared memory with no register
// in between, so a block issues the loads of its operands at entry or
// keeps a ring of tiles in flight (`cp_async_wait_upto`) while it
// multiplies; `bulk_copy` hands a contiguous run to the copy engine,
// which counts its bytes on an `mbarrier_*` barrier while the threads go
// on; `ldmatrix_*` reads 8 x 8 bf16 tiles from shared memory in the
// tensor cores' fragment layout, transposed where the operand lies
// k-major; `mma_bf16` is mma.sync.m16n8k16, bf16 inputs and fp32
// accumulation, with the decode step's N <= 16 rows, or 16 query rows a
// warp of the train step's attention, as the 16-row operand;
// `blocks_barrier` and the `barrier_set_*` pair let the blocks of one
// cooperative launch wait for one another on counters in device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace nic {

using bf16 = __nv_bfloat16;

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int BIG_ID = 1 << 30;  // id of an empty top-k slot
// Shared memory one block can use on the H100 (227 KB), static and
// dynamic together.
constexpr int MAX_SMEM_BYTES = 232448;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf(float v) { return __float2bfloat16(v); }
// Round to bf16 and back: the bf16 rounding points of the reference.
__device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Asynchronous 16-byte copy from device memory into shared memory,
// past L1 and the registers. Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

// The same for 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most PENDING of this thread's committed groups are
// still in flight. A __syncthreads() after it makes the data of every
// thread's copies visible to the block.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A barrier in shared memory (8 bytes, 8-byte aligned) that counts
// the bytes of bulk copies. One thread initialises it for one arrival
// and, with the same call, arrives and says how many bytes the copies
// will bring; a __syncthreads() must follow before a copy names it.
__device__ __forceinline__ void mbarrier_init_expect(void* bar, uint32_t bytes) {
  const uint32_t addr = smem_u32(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(addr) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(addr),
               "r"(bytes)
               : "memory");
}

// Asynchronous copy of `bytes` contiguous bytes (a multiple of 16, both
// addresses 16-byte aligned) from device memory into shared memory by
// the copy engine: one instruction, no register and no waiting thread.
// Its bytes count on `bar` as they land.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          uint32_t bytes, void* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Wait until every expected byte of the barrier's first phase landed;
// the copied data is visible to the waiting thread after it.
__device__ __forceinline__ void mbarrier_wait(void* bar) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
  }
}

// The same where the count is known only at run time (at most 2).
__device__ __forceinline__ void cp_async_wait_upto(int pending) {
  if (pending <= 0) cp_async_wait<0>();
  else if (pending == 1) cp_async_wait<1>();
  else cp_async_wait<2>();
}

__device__ __forceinline__ void zero16(void* smem) {
  *reinterpret_cast<uint4*>(smem) = make_uint4(0u, 0u, 0u, 0u);
}

// The flash kernels' dropout (flash_attention.cu, flash_generic.cu), one
// copy, so that every kernel drops the same slots: a stateless hash of
// (seed, b, head, t, s). The seed is mixed as the TPU kernel mixes it,
// key = seed * 2654435761 + ((b + row0) * heads_total + h0 + head)
// (mod 2^32), row0 the batch's first row in a data-parallel run's
// global batch and h0 a tensor-parallel rank's first head among
// heads_total; row_key = fmix32(key ^ fmix32(t + 0x9e3779b9)), bits =
// fmix32(row_key + s) (fmix32: the murmur3 finalizer), kept where bits
// >= threshold = floor(p 2^32). ops/flash_attention.py::dropout_keep
// computes the same bits in torch integer ops.
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t dropout_key(int seed, int b, int row0,
                                                int heads_total, int h0,
                                                int head) {
  return (uint32_t)seed * 2654435761u +
         (uint32_t)((b + row0) * heads_total + h0 + head);
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

// Two int8 values as a bf16 pair packed the way mma_bf16 reads its
// operands, `lo` in the lower half. Exact: an int8 has 8 significant
// bits at most, and bf16 holds 8.
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(int lo, int hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The same for two neighbouring int8 values in shared memory, the one
// at the lower address in the lower half (2-byte aligned).
__device__ __forceinline__ uint32_t i8pair_to_bf16x2(const void* at) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(at);
  return i8x2_to_bf16x2((int)(int8_t)(v & 0xffu), (int)(int8_t)(v >> 8));
}

// Two 8 x 8 bf16 tiles as the B operand of one mma_bf16 where shared
// memory holds B as [n][k], k contiguous (K of attention): lanes 0-7
// give the row addresses (16 bytes each) of the k 0-7 tile, lanes 8-15
// of the k 8-15 tile.
__device__ __forceinline__ void ldmatrix_x2(uint32_t& b0, uint32_t& b1,
                                            const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(row))
               : "memory");
}

// Four 8 x 8 bf16 tiles as the A operand of one mma_bf16 where shared
// memory holds A as [m][k], k contiguous (q of attention): lanes 0-7
// give the row addresses of rows 0-7 and lanes 8-15 of rows 8-15 at
// k 0-7 (a[0], a[1]), lanes 16-31 the same at k 8-15 (a[2], a[3]).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_u32(row))
               : "memory");
}

// Four 8 x 8 bf16 tiles, transposed on the way, as the B operands of
// two mma_bf16 where shared memory holds B as [k][n], n contiguous (a
// weight matrix, V of attention): lanes 0-7 give the rows k 0-7 and
// lanes 8-15 the rows k 8-15 of the first n tile (b0, b1), lanes 16-31
// the same of the second n tile (b2, b3).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& b0, uint32_t& b1,
                                                  uint32_t& b2, uint32_t& b3,
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
      : "r"(smem_u32(row))
      : "memory");
}

// c[16 x 8] += a[16 x 16] * b[16 x 8] on the tensor cores, bf16 in,
// fp32 out. With g = lane / 4 and t = lane % 4, a lane holds
//   a[0] = A(g, 2t..2t+1)      a[1] = A(g + 8, 2t..2t+1)
//   a[2] = A(g, 2t+8..2t+9)    a[3] = A(g + 8, 2t+8..2t+9)
//   b0 = B(2t..2t+1, g)        b1 = B(2t+8..2t+9, g)
//   c[0..1] = C(g, 2t..2t+1)   c[2..3] = C(g + 8, 2t..2t+1)
// each pair packed into 32 bits, the lower index in the lower half.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand of mma_bf16 from a row-major bf16 matrix in shared
// memory: `at` points at element (g, k0 + 2t) of this lane, `stride`
// is the row stride in bytes.
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const unsigned char* at,
                                            int stride) {
  a[0] = *reinterpret_cast<const uint32_t*>(at);
  a[1] = *reinterpret_cast<const uint32_t*>(at + 8 * stride);
  a[2] = *reinterpret_cast<const uint32_t*>(at + 16);
  a[3] = *reinterpret_cast<const uint32_t*>(at + 8 * stride + 16);
}

// Two 8 x 8 bf16 tiles, transposed on the way, as the B operand of one
// mma_bf16 where shared memory holds B as [k][n], n contiguous: lanes
// 0-7 give the rows k 0-7 and lanes 8-15 the rows k 8-15 of the n tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(row))
               : "memory");
}

// All `expected` blocks that call it with the same counter, zero before
// the launch, wait here for one another; what they wrote to device
// memory before is visible to all of them after, to reads that go to L2
// (__ldcg, cp.async.cg). Every thread of the block calls it; thread 0
// adds one with release and polls with acquire, so nothing waits for an
// atomic's return. The blocks must all be on the card (a cooperative
// launch).
__device__ __forceinline__ void blocks_barrier(unsigned* counter,
                                               unsigned expected) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(counter),
                 "r"(1u)
                 : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
    } while (seen < expected);
  }
  __syncthreads();
}

// The counters of a kernel's blocks_barrier calls: counters
// [1 + 2 * slots], zero before the first launch, hold a count of
// launches and two sets of `slots` barrier counters. A launch uses the
// set of its parity and zeroes the other for the next launch, so no
// block resets a counter while another may still poll it. One thread of
// every block calls barrier_set_begin before its first barrier (`resets`
// in one block only) and gets the launch's set; one thread of one block
// calls barrier_set_end after that block's last barrier, which must be
// one that every block has reached after its begin. Launches that share
// the counters must follow one another.
__device__ __forceinline__ unsigned* barrier_set_begin(unsigned* counters,
                                                       int slots, bool resets,
                                                       unsigned& launch) {
  launch = *reinterpret_cast<volatile unsigned*>(counters);
  if (resets) {
    unsigned* other = counters + 1 + (~launch & 1u) * slots;
    for (int i = 0; i < slots; ++i) other[i] = 0u;
  }
  return counters + 1 + (launch & 1u) * slots;
}

__device__ __forceinline__ void barrier_set_end(unsigned* counters,
                                                unsigned launch) {
  counters[0] = launch + 1u;
}

}  // namespace nic

// Phase timers, for ops/_phase_timers.py. NIC_PHASE(i) marks the end of
// phase i of a kernel and compiles to nothing, unless the sources are
// built with -DNIC_PHASE_TIMERS: then thread 0 of every block stores
// its multiprocessor's cycle counter and the card's nanosecond timer
// there, and NIC_DEFINE_PHASE_READER(name) defines the C function that
// copies the stamps of this source's kernels to the host, or zeroes
// them when called with a null pointer.
#ifdef NIC_PHASE_TIMERS
namespace nic {
constexpr int PHASE_SLOTS = 16, PHASE_BLOCKS = 2048;
static __device__ long long phase_stamps[2][PHASE_BLOCKS][PHASE_SLOTS];
__device__ __forceinline__ void phase_stamp(int i) {
  const unsigned block =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  if (threadIdx.x != 0 || block >= PHASE_BLOCKS) return;
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  phase_stamps[0][block][i] = clock64();
  phase_stamps[1][block][i] = (long long)ns;
}
}  // namespace nic
#define NIC_PHASE(i) nic::phase_stamp(i)
#define NIC_DEFINE_PHASE_READER(name)                                   \
  extern "C" int name(void* host) {                                     \
    if (host != nullptr)                                                \
      return (int)cudaMemcpyFromSymbol(host, nic::phase_stamps,         \
                                       sizeof(nic::phase_stamps));      \
    void* stamps;                                                       \
    cudaError_t err = cudaGetSymbolAddress(&stamps, nic::phase_stamps); \
    if (err != cudaSuccess) return (int)err;                            \
    return (int)cudaMemset(stamps, 0, sizeof(nic::phase_stamps));       \
  }
#else
#define NIC_PHASE(i)
#define NIC_DEFINE_PHASE_READER(name)
#endif

// Phase sums, for kernels whose phases repeat inside a block (a ring of
// chunks): NIC_PHASE_CLOCK() reads the multiprocessor's cycle counter
// (NIC_PHASE_NS() the card's nanosecond timer), NIC_PHASE_ADD(kind,
// slot, v) adds v to sum [kind][slot] of this source's kernels
// (NIC_PHASE_MAX keeps the largest v there), and
// NIC_DEFINE_PHASE_SUMS_READER(name) defines the C function that copies
// the sums to the host, or zeroes them when called with a null pointer.
// Without -DNIC_PHASE_TIMERS the clocks read 0 and the adds vanish.
#ifdef NIC_PHASE_TIMERS
namespace nic {
constexpr int PHASE_KINDS = 8, PHASE_SUMS = 12;
static __device__ unsigned long long phase_sums[PHASE_KINDS][PHASE_SUMS];
__device__ __forceinline__ long long phase_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return (long long)ns;
}
}  // namespace nic
#define NIC_PHASE_CLOCK() clock64()
#define NIC_PHASE_NS() nic::phase_ns()
#define NIC_PHASE_ADD(kind, slot, v) \
  atomicAdd(&nic::phase_sums[kind][slot], (unsigned long long)(v))
#define NIC_PHASE_MAX(kind, slot, v) \
  atomicMax(&nic::phase_sums[kind][slot], (unsigned long long)(v))
#define NIC_DEFINE_PHASE_SUMS_READER(name)                              \
  extern "C" int name(void* host) {                                     \
    if (host != nullptr)                                                \
      return (int)cudaMemcpyFromSymbol(host, nic::phase_sums,           \
                                       sizeof(nic::phase_sums));        \
    void* sums;                                                         \
    cudaError_t err = cudaGetSymbolAddress(&sums, nic::phase_sums);     \
    if (err != cudaSuccess) return (int)err;                            \
    return (int)cudaMemset(sums, 0, sizeof(nic::phase_sums));           \
  }
#else
#define NIC_PHASE_CLOCK() 0LL
#define NIC_PHASE_NS() 0LL
#define NIC_PHASE_ADD(kind, slot, v)
#define NIC_PHASE_MAX(kind, slot, v)
#define NIC_DEFINE_PHASE_SUMS_READER(name)
#endif

// Return the launch error, if any, from a C entry point.
#define NIC_RETURN_IF_LAUNCH_FAILED()          \
  do {                                         \
    const cudaError_t err_ = cudaGetLastError(); \
    if (err_ != cudaSuccess) return (int)err_; \
  } while (0)
