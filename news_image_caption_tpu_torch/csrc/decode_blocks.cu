// The conv block of a decode step of the dynamic-conv decoder layer,
// for one new token per row: linear1 -> GLU -> tap softmax -> ring
// combine -> linear2 + residual. One launch for up to 128 rows, in tiles
// of 16. (The layer's FFN block has its own source, decode_ffn.cu.)
//
// Replaces: news_image_caption_tpu/ops/pallas_decode.py
// decode_conv_block (_conv_block_kernel).
//
// What bounds it on the card: bytes. At decode batch N = 1..16 every
// weight is read once per step and used N times: w1 [C, 2C], w2 [C, C]
// and the tap predictor, about 6.5 MB of bf16 per layer at C = 1024
// (2 us at 3.35 TB/s), under the fixed cost of one launch. So the design
// is about one launch, every load requested at once, and as few waits
// between blocks as the data flow allows (two).
//
// Design. C / 16 blocks (64 at C = 1024), all on the card at once (a
// cooperative launch), block s owning output channels 16 s .. 16 s + 15
// of every stage, which all lie in one head.
//   - At entry a block requests everything it will read: x; of w1 the 16
//     `a` columns and the 16 `g` columns of its channels (so the GLU is
//     local), of w2 its 16 columns, its rows of the ring cache (16-byte
//     cp.async copies, 32-byte runs of a weight row: whole sectors); and
//     its head's taps, which the caller packs once a model load as
//     [H][taps padded to 8, 16 or 32][C], so a head's taps are contiguous
//     2 C-byte rows that the copy engine brings onto an mbarrier (in the
//     head-major [C, H * K] layout a head's columns start at byte
//     2 * head * K, which for odd K no 16-byte copy can fetch). The loads
//     of w2, the cache and the taps pass under linear1 and the first wait.
//   - Every product is whole-K on the tensor cores (mma.sync m16n8k16,
//     the N <= 16 rows zero-padded to the 16-row operand): the 8 warps
//     split the block's 8-column tiles and K between them (linear1: 4
//     tiles x 2 halves of K; taps: 1, 2 or 4 tiles; linear2: 2 tiles x 4
//     quarters), and the parts are added in a fixed order in shared
//     memory. No partial sum leaves the block.
//   - h must be whole before the tap logits, and the conv output before
//     linear2: the blocks write their 16 channels of h (the output
//     tensor) and of the conv output (1 KB each, bf16: the reference's
//     rounding points) to device memory, wait for one another
//     (blocks_barrier, common.cuh) and read the 32 KB back from L2. The
//     four blocks of a head each compute that head's tap logits and
//     softmax; the ring combine is elementwise in the block that owns
//     the channels, history summed in fp32 in tap order, rounded once.
//   - Each row reads its ring at its own position where the caller gives
//     `pos` (int32 [N], a slot pool whose rows sit at different depths),
//     else at the one step index `t`: tap k of row r is slot (pos_r + k)
//     mod (K - 1), its position read from device memory where its ring
//     rows are requested, never on the host.
//   - More than 16 rows (a beam step) stay in the launch, with the same
//     two waits: every stage walks the row tiles, 16 rows at a time, over
//     the weights and taps in shared memory. Where the card holds them,
//     `groups` sets of C / 16 blocks share the tiles (group g takes tiles
//     g, g + groups, ...), each set with the weights of its own.
// Every sum has a fixed order: the result is the same on every run.
// Shared memory holds w1 and w2 as they lie in device memory ([k][n], n
// contiguous), the 16-byte chunks of a row XOR-swizzled by row so the
// transposing ldmatrix reads hit distinct banks; the taps lie [tap][k],
// rows padded by 16 bytes.

#include "common.cuh"

namespace nic {

constexpr int CB_THREADS = 256;
constexpr int CB_WARPS = CB_THREADS / 32;
constexpr int CB_ROWS = 16;    // rows of x a tile (the mma's M)
constexpr int CB_MAX_ROWS = 128;   // rows of x a launch
constexpr int CB_STRIP = 16;   // channels a block
constexpr int CB_MAX_TAPS = 32;
constexpr int CB_PART_BYTES = CB_WARPS * CB_ROWS * 8 * 4;   // a tile a warp

// Dynamic shared memory of decode_conv_kernel, in order: the w1 strip
// [C][32] bf16; the w2 strip [C][16] bf16; the activations [16][C + 8]
// bf16 (x, then h, then the conv output); the head's taps [kp][C + 8]
// bf16; the warps' parts of a product, fp32; the block's ring rows
// [kp][16][16] bf16 in tap order; the tap logits, then weights,
// [16][32] fp32; the barrier of the taps' copies.
__host__ __device__ constexpr int conv_block_smem_bytes(int C, int kp) {
  return C * 2 * CB_STRIP * 2 + C * CB_STRIP * 2 + CB_ROWS * (C + 8) * 2 +
         kp * (C + 8) * 2 + CB_PART_BYTES + kp * CB_ROWS * CB_STRIP * 2 +
         CB_ROWS * CB_MAX_TAPS * 4 + 16;
}

// acc += A [16, 16 * ksteps] * B over the k steps kpart, kpart + kparts,
// ...: A row-major bf16 in shared memory (rows `a_stride` bytes apart),
// b_row(k0) the address this lane gives the B fragment's ldmatrix for the
// step at k0. TRANS: B lies [k][n] (a weight strip), else [n][k] (taps).
template <bool TRANS, class BRow>
__device__ __forceinline__ void strip_product(float (&acc)[4],
                                              const unsigned char* as,
                                              int a_stride, int ksteps,
                                              int kpart, int kparts,
                                              BRow b_row) {
  const int lane = threadIdx.x % 32;
  const unsigned char* a_at = as + (lane & 15) * a_stride + (lane >> 4) * 16;
#pragma unroll 4
  for (int ks = kpart; ks < ksteps; ks += kparts) {
    uint32_t a[4], b0, b1;
    ldmatrix_x4(a, a_at + ks * 32);
    if (TRANS)
      ldmatrix_x2_trans(b0, b1, b_row(ks * 16));
    else
      ldmatrix_x2(b0, b1, b_row(ks * 16));
    mma_bf16(acc, a, b0, b1);
  }
}

// The warp's [16, 8] tile of a product into part [kpart][16][ncols] at
// columns nt * 8 ..
__device__ __forceinline__ void store_part(float* part, const float (&acc)[4],
                                           int kpart, int nt, int ncols) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float* at = part + (kpart * CB_ROWS + g) * ncols + nt * 8 + 2 * t;
  *reinterpret_cast<float2*>(at) = make_float2(acc[0], acc[1]);
  *reinterpret_cast<float2*>(at + 8 * ncols) = make_float2(acc[2], acc[3]);
}

// grid = groups * C / 16 blocks, launched cooperatively; block b owns the
// channel strip b % (C / 16) for the row tiles of group b / (C / 16).
// taps [H][kp][C] bf16 is the packed tap predictor (taps >= K zero);
// cache [K - 1][n_total][C] with this launch's rows first; hconv [N][C]
// bf16 is scratch; counters [1 + 2 * 2] are the barriers'
// (barrier_set_begin, common.cuh); pos, if not null, the rows' positions
// (this launch's first), which take the place of t.
__global__ void __launch_bounds__(CB_THREADS, 1)
decode_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ cache,
                   const bf16* __restrict__ w1, const bf16* __restrict__ b1,
                   const bf16* __restrict__ taps, const bf16* __restrict__ w2,
                   const bf16* __restrict__ b2, bf16* h_out, bf16* hconv,
                   bf16* __restrict__ y, unsigned* counters,
                   const int* __restrict__ pos, int N, int n_total, int C,
                   int H, int K, int kp, int t) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int strips = C / CB_STRIP, strip = blockIdx.x % strips;
  const int group = blockIdx.x / strips, groups = gridDim.x / strips;
  const int ch0 = strip * CB_STRIP;
  const int head = ch0 / (C / H), Km1 = K - 1;
  const int a_stride = (C + 8) * 2;     // bytes
  const int cpr = C / 8;                // 16-byte pieces of a row
  const int tiles = cdiv(N, CB_ROWS);

  unsigned char* w1s = smem;
  unsigned char* w2s = w1s + C * 64;
  unsigned char* as = w2s + C * 32;
  unsigned char* taps_s = as + CB_ROWS * a_stride;
  float* part = reinterpret_cast<float*>(taps_s + kp * a_stride);
  bf16* cache_s = reinterpret_cast<bf16*>(
      reinterpret_cast<unsigned char*>(part) + CB_PART_BYTES);
  float* probs = reinterpret_cast<float*>(cache_s + kp * CB_ROWS * CB_STRIP);
  unsigned char* taps_bar =
      reinterpret_cast<unsigned char*>(probs + CB_ROWS * CB_MAX_TAPS);

  // Thread 0 alone touches the counters (see barrier_set_begin).
  unsigned launch = 0;
  unsigned* mine = nullptr;
  if (tid == 0) {
    mbarrier_init_expect(taps_bar, kp * C * 2);
    mine = barrier_set_begin(counters, 2, blockIdx.x == 0, launch);
  }
  __syncthreads();

  // The element this thread owns in every elementwise stage: row r of
  // the tile, channel ch0 + j; its biases.
  const int r = tid >> 4, j = tid & 15;
  const float b1a = to_f(b1[ch0 + j]), b1g = to_f(b1[C + ch0 + j]);
  const float b2v = to_f(b2[ch0 + j]);

  // Rows [row0, row0 + rows) of a [N, C] matrix into the activations.
  auto load_rows = [&](const bf16* src, int row0, int rows) {
    for (int i = tid; i < rows * cpr; i += CB_THREADS) {
      const int rr = i / cpr, c = i % cpr;
      cp_async16(as + rr * a_stride + c * 16,
                 src + (size_t)(row0 + rr) * C + c * 8);
    }
  };
  // A tile's x, rows past the last as zeros.
  auto load_x = [&](int row0, int rows) {
    for (int i = tid; i < (CB_ROWS - rows) * cpr; i += CB_THREADS)
      zero16(as + (rows + i / cpr) * a_stride + (i % cpr) * 16);
    load_rows(x, row0, rows);
  };
  // The block's channels of a tile's ring rows, tap k's row (slot (p + k)
  // mod (K - 1), p the row's position or t) at index k.
  auto load_ring = [&](int row0, int rows) {
    for (int i = tid; i < Km1 * CB_ROWS * 2; i += CB_THREADS) {
      const int k = i >> 5, rr = (i >> 1) & 15, half = i & 1;
      bf16* dst = cache_s + (k * CB_ROWS + rr) * CB_STRIP + half * 8;
      if (rr < rows) {
        const int p = pos != nullptr ? __ldg(pos + row0 + rr) : t;
        int slot = (p % Km1 + k) % Km1;
        if (slot < 0) slot += Km1;   // a negative position reads in bounds
        cp_async16(dst, cache + ((size_t)slot * n_total + row0 + rr) * C +
                            ch0 + half * 8);
      } else {
        zero16(dst);
      }
    }
  };

  // Every load, at once. Group 0 of the copies: the first tile's x and
  // ring rows and the w1 strip, row k at k * 64 bytes: chunks 0, 1 the `a`
  // columns, 2, 3 the `g` columns, chunk c at c ^ ((k / 2) % 4).
  {
    const int row0 = group * CB_ROWS;
    load_x(row0, min(CB_ROWS, N - row0));
    load_ring(row0, min(CB_ROWS, N - row0));
  }
  for (int i = tid; i < C * 4; i += CB_THREADS) {
    const int k = i >> 2, c = i & 3;
    const int col = (c < 2 ? 0 : C - 2 * 8) + ch0 + c * 8;
    cp_async16(w1s + k * 64 + ((c ^ ((k >> 1) & 3)) << 4),
               w1 + (size_t)k * 2 * C + col);
  }
  cp_async_commit();
  // The head's taps, a row of C a thread, through the copy engine.
  if (tid < kp)
    bulk_copy(taps_s + tid * a_stride, taps + ((size_t)head * kp + tid) * C,
              C * 2, taps_bar);
  // Group 1: the w2 strip, row k at k * 32 bytes, chunk c at
  // c ^ ((k / 4) % 2).
  for (int i = tid; i < C * 2; i += CB_THREADS) {
    const int k = i >> 1, c = i & 1;
    cp_async16(w2s + k * 32 + ((c ^ ((k >> 2) & 1)) << 4),
               w2 + (size_t)k * C + ch0 + c * 8);
  }
  cp_async_commit();
  NIC_PHASE(0);   // loads issued

  // The stamps inside a stage's walk are those of the block's last tile.
  // Stage 1, linear1 and the GLU: 4 column tiles (a, a, g, g) x 2 halves
  // of K.
  for (int tile = group; tile < tiles; tile += groups) {
    const int row0 = tile * CB_ROWS, rows = min(CB_ROWS, N - row0);
    if (tile == group) {
      cp_async_wait<1>();        // w2 may still be on its way
    } else {
      __syncthreads();           // the last tile's reads are done
      load_x(row0, rows);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    NIC_PHASE(1);   // x and w1 landed
    {
      float acc[4] = {};
      const int nt = warp & 3, kpart = warp >> 2;
      strip_product<true>(acc, as, a_stride, C / 16, kpart, 2, [&](int k0) {
        const int k = k0 + (lane & 15);
        return w1s + k * 64 + ((nt ^ ((k >> 1) & 3)) << 4);
      });
      store_part(part, acc, kpart, nt, 32);
    }
    __syncthreads();
    const float* p0 = part + r * 32, * p1 = part + (CB_ROWS + r) * 32;
    const float a = rbf(rbf(p0[j] + p1[j]) + b1a);
    const float gate = rbf(rbf(p0[16 + j] + p1[16 + j]) + b1g);
    if (r < rows)
      h_out[(size_t)(row0 + r) * C + ch0 + j] =
          to_bf(a * rbf(1.f / (1.f + expf(-gate))));
    NIC_PHASE(2);   // linear1, GLU
  }
  blocks_barrier(mine, gridDim.x);
  NIC_PHASE(3);   // every block's h is in device memory

  // Stage 2, the head's tap weights and the ring combine.
  for (int tile = group; tile < tiles; tile += groups) {
    const int row0 = tile * CB_ROWS, rows = min(CB_ROWS, N - row0);
    __syncthreads();
    load_rows(h_out, row0, rows);
    if (tile != group) load_ring(row0, rows);
    cp_async_commit();
    cp_async_wait<0>();          // h, and long since w2 and the ring rows
    mbarrier_wait(taps_bar);
    __syncthreads();
    NIC_PHASE(4);   // h and the taps landed
    // The tap logits: kp / 8 tiles, K split among the other warps.
    {
      const int ntiles = kp / 8, kparts = CB_WARPS / ntiles;
      float acc[4] = {};
      const int nt = warp % ntiles, kpart = warp / ntiles;
      strip_product<false>(acc, as, a_stride, C / 16, kpart, kparts, [&](int k0) {
        return taps_s + (nt * 8 + (lane & 7)) * a_stride +
               (k0 + ((lane >> 3) & 1) * 8) * 2;
      });
      store_part(part, acc, kpart, nt, kp);
      __syncthreads();
      for (int e = tid; e < CB_ROWS * kp; e += CB_THREADS) {
        float sum = 0.f;
        for (int p = 0; p < kparts; ++p) sum += part[p * CB_ROWS * kp + e];
        probs[(e / kp) * CB_MAX_TAPS + e % kp] = rbf(sum);
      }
    }
    __syncthreads();
    // Softmax over the K taps, rounded: a warp two rows, a lane a tap.
    for (int row = warp; row < CB_ROWS; row += CB_WARPS) {
      float* p = probs + row * CB_MAX_TAPS;
      const float logit = lane < K ? p[lane] : -INFINITY;
      const float e = expf(logit - warp_max(logit));
      p[lane] = rbf(e / warp_sum(e));
    }
    __syncthreads();
    NIC_PHASE(5);   // tap weights
    {
      const float* p = probs + r * CB_MAX_TAPS;
      float hist = 0.f;
      for (int k = 0; k < Km1; ++k)
        hist = fmaf(p[k], to_f(cache_s[(k * CB_ROWS + r) * CB_STRIP + j]), hist);
      const float hval =
          to_f(*reinterpret_cast<const bf16*>(as + r * a_stride + (ch0 + j) * 2));
      if (r < rows)
        hconv[(size_t)(row0 + r) * C + ch0 + j] =
            to_bf(rbf(hist) + rbf(p[Km1] * hval));
    }
    NIC_PHASE(6);   // ring combine
  }
  blocks_barrier(mine + 1, gridDim.x);
  if (tid == 0 && blockIdx.x == 0) barrier_set_end(counters, launch);
  NIC_PHASE(7);   // every block's conv output is in device memory

  // Stage 3, linear2 and the residual: 2 column tiles x 4 quarters of K.
  for (int tile = group; tile < tiles; tile += groups) {
    const int row0 = tile * CB_ROWS, rows = min(CB_ROWS, N - row0);
    __syncthreads();
    load_rows(hconv, row0, rows);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    NIC_PHASE(8);   // the conv output landed
    {
      float acc[4] = {};
      const int nt = warp & 1, kpart = warp >> 1;
      strip_product<true>(acc, as, a_stride, C / 16, kpart, 4, [&](int k0) {
        const int k = k0 + (lane & 15);
        return w2s + k * 32 + ((nt ^ ((k >> 2) & 1)) << 4);
      });
      store_part(part, acc, kpart, nt, 16);
    }
    __syncthreads();
    if (r < rows) {
      float sum = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) sum += part[(p * CB_ROWS + r) * 16 + j];
      const size_t at = (size_t)(row0 + r) * C + ch0 + j;
      y[at] = to_bf(rbf(rbf(sum) + b2v) + to_f(x[at]));
    }
    NIC_PHASE(9);   // y written
  }
}

}  // namespace nic

NIC_DEFINE_PHASE_READER(nic_decode_conv_phases)

// y, h = conv block step for N <= 128 rows. x [N, C]; cache
// [K - 1, n_total, C] ring-major, its first N rows of every slot this
// launch's; pos null (every row at step t >= 0) or int32 [N] on the card,
// each row's position (t is then not read); w1 [C, 2C], b1 [2C] (weight
// norm folded); taps [H, kp, C] the packed tap predictor, kp = 8, 16 or
// 32 >= K; w2 [C, C], b2 [C]; all bf16, 16-byte aligned. C % 16 == 0 and (C / H) % 16 == 0; `smem` is the
// kernel's dynamic shared memory as the caller planned it, which must
// equal conv_block_smem_bytes(C, kp). The C / 16 blocks must fit on the
// card together, `groups` (at most the row tiles) times, or the launch
// fails. Scratch: hconv [N, C] bf16; counters [5] unsigned ints, zeroed
// once and then left to the kernel's launches, which must follow one
// another. Returns a cudaError_t.
extern "C" int nic_decode_conv_block(const void* x, const void* cache,
                                     const void* w1, const void* b1,
                                     const void* taps, const void* w2,
                                     const void* b2, void* h, void* hconv,
                                     void* y, void* counters, const void* pos,
                                     int N, int n_total, int C, int H, int K,
                                     int kp, int t, int groups, int smem,
                                     void* stream) {
  using nic::bf16;
  if (N < 1 || N > nic::CB_MAX_ROWS || n_total < N || K < 2 ||
      K > nic::CB_MAX_TAPS || (kp != 8 && kp != 16 && kp != 32) || kp < K ||
      H < 1 || C < 16 || C % 16 != 0 || C % H != 0 || (C / H) % 16 != 0 ||
      (pos == nullptr && t < 0) || groups < 1 || groups > nic::cdiv(N, nic::CB_ROWS) ||
      smem != nic::conv_block_smem_bytes(C, kp) ||
      smem > nic::MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      nic::decode_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * (C / nic::CB_STRIP));
  cfg.blockDim = dim3(nic::CB_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, nic::decode_conv_kernel, (const bf16*)x,
                           (const bf16*)cache, (const bf16*)w1, (const bf16*)b1,
                           (const bf16*)taps, (const bf16*)w2, (const bf16*)b2,
                           (bf16*)h, (bf16*)hconv, (bf16*)y,
                           (unsigned*)counters, (const int*)pos, N, n_total,
                           C, H, K, kp, t);
  if (err != cudaSuccess) return (int)err;
  NIC_RETURN_IF_LAUNCH_FAILED();
  return 0;
}
