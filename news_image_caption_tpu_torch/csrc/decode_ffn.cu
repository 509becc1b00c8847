// The FFN block of a decode step, for one new token per row:
// y = rbf(rbf(rbf(h w2) + b2) + x), h = relu(rbf(rbf(x w1) + b1)), where
// rbf rounds to bf16 (the reference kernel's rounding points) and both
// products accumulate in fp32. One launch for up to 16 rows.
//
// Replaces: news_image_caption_tpu/ops/pallas_decode.py
// decode_ffn_block (_ffn_kernel).
//
// What bounds it on the card: bytes. At N <= 16 rows the call reads
// w1 [C, F] and w2 [F, C] once (16.8 MB of bf16 at C = 1024, F = 4096,
// 5 us at 3.35 TB/s) and does 268 MFLOP, 0.3 us of the tensor cores.
// The card reaches its memory rate only with a few MB of loads in
// flight, so the design is about issuing every load at once and keeping
// the partial sums small.
//
// Design. The TPU kernel walks F in chunks one after the other and
// carries an fp32 accumulator; here the chunks run side by side, in
// F / 32 blocks (128 at F = 4096, one a multiprocessor) that are all on
// the card at once (a cooperative launch), in groups of `group` (8)
// neighbours.
//   - Block g requests everything it will read in its first
//     instructions: x and the 32 columns g * 32.. of w1 (64 KB at
//     C = 1024) with 16-byte cp.async copies, and of w2 the rows of its
//     group's 256 FFN columns restricted to the block's own C / 8 = 128
//     output columns (64 KB) with one bulk copy of a 256-byte run a
//     thread, which the copy engine carries out while the threads go on:
//     issuing 4096 more cp.async would hold them until w2 had landed.
//     The 128 blocks have the whole 16.8 MB in flight together, and fc1
//     and the group's barrier pass while w2 arrives.
//   - fc1 on the tensor cores (mma.sync m16n8k16, the N <= 16 rows
//     zero-padded to the 16-row operand): the 8 warps split K = C, their
//     fp32 partials are added in warp order in shared memory, and the
//     block's strip of h = relu(rbf(rbf(.) + b1)) goes to device memory
//     as bf16 (1 KB a block; the reference's rounding point).
//   - The blocks of a group wait for one another (a counter in device
//     memory), read the group's h [16, 256] back from L2, and each
//     multiplies it with its piece of w2: the block's [16, 128] fp32
//     result is already summed over the group's 256 FFN columns, so the
//     partial sums that leave the block are F / 256 = 16 times the
//     output, 1 MB, which stays in L2.
//   - The 16 blocks that own the same 128 output columns, one of every
//     group, wait for one another, then share those columns: a thread
//     adds the 16 groups' partials of four columns in group order,
//     applies b2, the residual and the roundings, and writes y. Every
//     sum has a fixed order and no float is added atomically: the
//     result is the same on every run.
// Partial mode (tensor parallelism: this rank holds F / m columns of w1
// and the same rows of w2): with `sums` given, the blocks that own a
// slice stop after adding the groups' partials in group order and write
// that fp32 sum to sums [N, C], without b2, the residual or a rounding;
// the caller sums the ranks' partials and applies the epilogue. y is not
// written. With sums null the kernel is the whole one, unchanged.
// (Thread block clusters with the partials added through distributed
// shared memory were tried first: with 182 KB of shared memory a block,
// the card places only 14 of the 16 clusters of 8 at once, the other
// two start when the first finish, and the exchange of 64 KB a block
// took longer than the loads.)
// Shared memory holds weights as they lie in device memory ([k][n], n
// contiguous). So that the transposing ldmatrix reads hit distinct
// banks, the 16-byte chunks of a w1 row are XOR-swizzled by row, and a
// row of the w2 piece, which a bulk copy writes as it is, is followed by
// 16 bytes of padding.

#include "common.cuh"

namespace nic {

constexpr int FFN_THREADS = 256;
constexpr int FFN_WARPS = FFN_THREADS / 32;
constexpr int FFN_STRIP = 32;     // columns of w1 a block
constexpr int FFN_ROWS = 16;      // rows of x a launch (the mma's M)
constexpr int FFN_MAX_GROUP = 8;  // blocks that share their strips of h

// Dynamic shared memory of decode_ffn_kernel, in order: the w1 strip
// [C][32] bf16; the block's piece of w2 [group * 32][C / group + 8]
// bf16; x [16][C + 8] bf16; the warps' fc1 partials [8][16][32] fp32;
// the group's h [16][group * 32 + 8] bf16; the barrier of w2's copies.
__host__ __device__ constexpr int ffn_smem_bytes(int C, int group) {
  return C * FFN_STRIP * 2 + group * FFN_STRIP * (C / group + 8) * 2 +
         FFN_ROWS * (C + 8) * 2 + FFN_WARPS * FFN_ROWS * FFN_STRIP * 4 +
         FFN_ROWS * (group * FFN_STRIP + 8) * 2 + 16;
}

// grid = F / 32 blocks, launched cooperatively. hbuf [16][F] bf16 and
// ws [F / 32 / group][16][C] fp32 are scratch. counters [1 + 2 * slots],
// slots >= F / 32 / group + group, zero before the first launch, are the
// barriers' (barrier_set_begin in common.cuh).
__global__ void __launch_bounds__(FFN_THREADS, 1)
decode_ffn_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                  const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                  const bf16* __restrict__ b2, bf16* __restrict__ y,
                  bf16* hbuf, float* ws, unsigned* counters, int slots, int N,
                  int C, int F, int group, float* __restrict__ sums) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = blockIdx.x;
  const int gid = strip / group, rank = strip % group;
  const int ngroups = gridDim.x / group;
  const int slice = C / group;                    // output columns a block
  const int kdim = group * FFN_STRIP;             // FFN columns a group
  const int xs_stride = (C + 8) * 2;              // bytes
  const int w2_stride = (slice + 8) * 2;          // bytes
  const int hg_stride = (kdim + 8) * 2;           // bytes

  unsigned char* w1s = smem;
  unsigned char* w2s = w1s + C * FFN_STRIP * 2;
  unsigned char* xs = w2s + kdim * w2_stride;
  float* hpart = reinterpret_cast<float*>(xs + FFN_ROWS * xs_stride);
  unsigned char* hg = reinterpret_cast<unsigned char*>(
      hpart + FFN_WARPS * FFN_ROWS * FFN_STRIP);
  unsigned char* w2_bar = hg + FFN_ROWS * hg_stride;   // 16-byte aligned

  // Thread 0 alone touches the counters. Every block reads the count
  // of launches before its first barrier, and block 0 raises it after
  // its last, when every block has passed the first.
  unsigned launch = 0;
  unsigned* mine = nullptr;
  if (tid == 0) {
    mbarrier_init_expect(w2_bar, kdim * slice * 2);
    mine = barrier_set_begin(counters, slots, strip == 0, launch);
  }
  __syncthreads();

  // Every load, at once. A thread walks the 16-byte chunks tid,
  // tid + 256, ... of a [rows][chunks] array without dividing: (r, c)
  // advance by (dr, dc).
  auto walk = [&](int chunks, int rows, auto&& body) {
    const int dr = FFN_THREADS / chunks, dc = FFN_THREADS % chunks;
    for (int r = tid / chunks, c = tid % chunks; r < rows;) {
      body(r, c);
      r += dr, c += dc;
      if (c >= chunks) c -= chunks, ++r;
    }
  };
  // x (rows past N as zeros) and the w1 strip, row k at k * 64 bytes,
  // chunk c of a row at c ^ ((k / 2) % 4).
  walk(C / 8, FFN_ROWS, [&](int r, int c) {
    unsigned char* dst = xs + r * xs_stride + c * 16;
    if (r < N) cp_async16(dst, x + (size_t)r * C + c * 8);
    else zero16(dst);
  });
  for (int i = tid; i < C * 4; i += FFN_THREADS) {
    const int k = i >> 2, c = i & 3;
    cp_async16(w1s + k * 64 + ((c ^ ((k >> 1) & 3)) << 4),
               w1 + (size_t)k * F + strip * FFN_STRIP + c * 8);
  }
  cp_async_commit();
  // Rows gid * kdim.. of w2, columns rank * slice..: a row a thread.
  if (tid < kdim)
    bulk_copy(w2s + tid * w2_stride,
              w2 + (size_t)(gid * kdim + tid) * C + rank * slice, slice * 2,
              w2_bar);
  // The two biases of h this thread will add, ahead of their use.
  float bias1[FFN_ROWS * FFN_STRIP / FFN_THREADS];
#pragma unroll
  for (int j = 0; j < FFN_ROWS * FFN_STRIP / FFN_THREADS; ++j)
    bias1[j] = to_f(b1[strip * FFN_STRIP + (tid + j * FFN_THREADS) % FFN_STRIP]);
  NIC_PHASE(0);   // loads issued
  cp_async_wait<0>();
  __syncthreads();
  NIC_PHASE(1);   // x and w1 landed

  // fc1: warp w multiplies the 16-deep K steps w, w + 8, ... into a
  // [16, 32] fp32 partial (4 n tiles). The lane's row of a transposing
  // ldmatrix: k = k0 + klane; lanes 16-31 address the second n tile.
  const int klane = (lane & 7) + ((lane >> 3) & 1) * 8, nsel = lane >> 4;
  {
    float acc[4][4] = {};
#pragma unroll 4
    for (int s = warp; s < C / 16; s += FFN_WARPS) {
      const int k0 = s * 16;
      uint32_t a[4];
      load_a_frag(a, xs + g * xs_stride + (k0 + 2 * t) * 2, xs_stride);
      const int k = k0 + klane;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t f0, f1, f2, f3;
        const int c = 2 * p + nsel;
        ldmatrix_x4_trans(f0, f1, f2, f3,
                          w1s + k * 64 + ((c ^ ((k >> 1) & 3)) << 4));
        mma_bf16(acc[2 * p], a, f0, f1);
        mma_bf16(acc[2 * p + 1], a, f2, f3);
      }
    }
    float* mine = hpart + warp * FFN_ROWS * FFN_STRIP;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(mine + g * FFN_STRIP + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(mine + (g + 8) * FFN_STRIP + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  __syncthreads();
  NIC_PHASE(2);   // fc1 multiplied
#pragma unroll
  for (int j = 0; j < FFN_ROWS * FFN_STRIP / FFN_THREADS; ++j) {
    const int e = tid + j * FFN_THREADS;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < FFN_WARPS; ++w) sum += hpart[w * FFN_ROWS * FFN_STRIP + e];
    const int r = e / FFN_STRIP, c = strip * FFN_STRIP + e % FFN_STRIP;
    const float v = rbf(rbf(sum) + bias1[j]);
    hbuf[(size_t)r * F + c] = to_bf(fmaxf(v, 0.f));
  }
  blocks_barrier(mine + gid, group);
  NIC_PHASE(3);   // the group's h is in device memory

  // The group's h [16, kdim] from L2 into shared memory.
  walk(kdim / 8, FFN_ROWS, [&](int r, int c) {
    cp_async16(hg + r * hg_stride + c * 16,
               hbuf + (size_t)r * F + gid * kdim + c * 8);
  });
  cp_async_commit();
  cp_async_wait<0>();
  mbarrier_wait(w2_bar);   // the piece of w2 is in place
  __syncthreads();
  NIC_PHASE(4);   // h and w2 landed

  // fc2: warp w multiplies h [16, kdim] into the 16-column pairs of
  // n tiles w, w + 8, ... of the block's slice and writes them to the
  // group's partial.
  float* part = ws + (size_t)gid * FFN_ROWS * C + rank * slice;
  for (int np = warp; np < slice / 16; np += FFN_WARPS) {
    float acc[2][4] = {};
#pragma unroll 4
    for (int kk = 0; kk < kdim / 16; ++kk) {
      uint32_t a[4], f0, f1, f2, f3;
      load_a_frag(a, hg + g * hg_stride + (kk * 16 + 2 * t) * 2, hg_stride);
      const int k = kk * 16 + klane, c = 2 * np + nsel;
      ldmatrix_x4_trans(f0, f1, f2, f3, w2s + k * w2_stride + (c << 4));
      mma_bf16(acc[0], a, f0, f1);
      mma_bf16(acc[1], a, f2, f3);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = np * 16 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(part + (size_t)g * C + col) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(part + (size_t)(g + 8) * C + col) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  NIC_PHASE(5);   // fc2 multiplied
  // The blocks of every group that own this slice of the output wait
  // for one another, then share it: four columns a thread, the groups'
  // partials added in group order (all loads issued first), then b2,
  // the residual and the roundings.
  const int quads = slice / 4;
  const int share = (N * quads + ngroups - 1) / ngroups;   // quads a block
  blocks_barrier(mine + ngroups + rank, ngroups);
  if (tid == 0 && strip == 0) barrier_set_end(counters, launch);
  NIC_PHASE(6);   // every group's partial of this slice is in device memory
  for (int j = tid; j < share; j += FFN_THREADS) {
    const int i = gid * share + j;
    if (i >= N * quads) break;
    const int r = i / quads, col = rank * slice + (i % quads) * 4;
    // b2 and the residual (x is still in shared memory), ahead of use.
    uint2 b2v = make_uint2(0u, 0u), xv = make_uint2(0u, 0u);
    if (sums == nullptr) {
      b2v = __ldg(reinterpret_cast<const uint2*>(b2 + col));
      xv = *reinterpret_cast<const uint2*>(xs + r * xs_stride + col * 2);
    }
    const float* at_ws = ws + (size_t)r * C + col;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int g0 = 0; g0 < ngroups; g0 += 16) {
      float4 v[16];
#pragma unroll
      for (int j2 = 0; j2 < 16; ++j2)
        if (g0 + j2 < ngroups)
          v[j2] = __ldcg(reinterpret_cast<const float4*>(
              at_ws + (size_t)(g0 + j2) * FFN_ROWS * C));
#pragma unroll
      for (int j2 = 0; j2 < 16; ++j2)
        if (g0 + j2 < ngroups)
          sum.x += v[j2].x, sum.y += v[j2].y, sum.z += v[j2].z, sum.w += v[j2].w;
    }
    if (sums != nullptr) {
      *reinterpret_cast<float4*>(sums + (size_t)r * C + col) = sum;
      continue;
    }
    const float s4[4] = {sum.x, sum.y, sum.z, sum.w};
    const bf16* b2e = reinterpret_cast<const bf16*>(&b2v);
    const bf16* xe = reinterpret_cast<const bf16*>(&xv);
    __align__(8) bf16 o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[e] = to_bf(rbf(rbf(s4[e]) + to_f(b2e[e])) + to_f(xe[e]));
    *reinterpret_cast<uint2*>(y + (size_t)r * C + col) =
        *reinterpret_cast<const uint2*>(o);
  }
  NIC_PHASE(7);   // y written
}

}  // namespace nic

NIC_DEFINE_PHASE_READER(nic_decode_ffn_phases)

// y [N, C] = FFN block step for N <= 16 rows. x [N, C]; w1 [C, F],
// b1 [F]; w2 [F, C], b2 [C] (weight norm folded), all bf16 and 16-byte
// aligned. C % 64 == 0, F % 32 == 0. `group` (1, 2, 4 or 8) divides
// F / 32, and C / group is a multiple of 16; `smem` is the
// kernel's dynamic shared memory as the caller planned it, which must
// equal ffn_smem_bytes(C, group). The F / 32 blocks must fit on the
// card together, or the launch fails. sums: null for y, or fp32 [N, C]
// (16-byte aligned) for the partial mode's sums, y then unwritten and
// b2 unread (see the note above). Scratch: hbuf [16][F] bf16; ws
// [F / 32 / group][16][C] fp32; counters [1 + 2 * slots] unsigned ints,
// slots >= F / 32 / group + group, zeroed once and then left to the
// kernel's launches, which must follow one another. Returns a
// cudaError_t.
extern "C" int nic_decode_ffn_block(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, void* y, void* hbuf,
                                    void* ws, void* counters, int slots,
                                    int N, int C, int F, int group,
                                    int smem, void* sums, void* stream) {
  using nic::bf16;
  if (N < 1 || N > nic::FFN_ROWS || C < 64 || C % 64 != 0 ||
      F < nic::FFN_STRIP || F % nic::FFN_STRIP != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = F / nic::FFN_STRIP;
  if ((group != 1 && group != 2 && group != 4 && group != 8) ||
      group > nic::FFN_MAX_GROUP || blocks % group != 0 ||
      slots < blocks / group + group)
    return (int)cudaErrorInvalidValue;
  const int slice = C / group;
  if (slice % 16 != 0 || smem != nic::ffn_smem_bytes(C, group) ||
      smem > nic::MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nic::decode_ffn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(nic::FFN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nic::decode_ffn_kernel, (const bf16*)x,
                           (const bf16*)w1, (const bf16*)b1, (const bf16*)w2,
                           (const bf16*)b2, (bf16*)y, (bf16*)hbuf, (float*)ws,
                           (unsigned*)counters, slots, N, C, F, group,
                           (float*)sums);
  if (err != cudaSuccess) return (int)err;
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
