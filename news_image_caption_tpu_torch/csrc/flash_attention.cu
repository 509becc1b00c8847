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
// What bounds it on the card: bytes, by the count of the bound (at the
// flagship, B = 16, T = 63, E = 1024, 16 heads, the article K and V are
// 16.8 MB each per layer (S' = 514), so the forward moves 37.9 MB and
// the backward 73.7 MB, against 2.1 and 5.3 GFLOP). What the kernels
// spend their time on is the work a thread does for every one of the
// call's 8.3 M (t, s) slots, twice: an exponential, the dropout hash
// (11 integer instructions), a few products and a rounding. Two blocks
// of four warps a multiprocessor issue about one instruction every
// other cycle, so every instruction taken out of a slot shows.
//
// Design.
//   - grid (H, B, T tiles): a block of four warps owns 64 query rows of
//     one (head, item), a warp 16 whole rows. Row maxima, sums and
//     delta are reductions inside a quad of lanes: no block barrier, no
//     shared memory for them.
//   - No score matrix anywhere. The scores of one tile of 64 keys are
//     the accumulator fragments of mma.sync m16n8k16 (32 registers a
//     thread). The reference's whole-row softmax is kept by walking the
//     keys twice. Forward: walk 1 takes the row maximum and the sum of
//     exp(s - max) (rescaled as the maximum grows); walk 2 forms
//     p = exp(s - max) * (scale / sum) with the row's sum and the
//     dropout scale divided once a row, the mask and the bf16 rounding,
//     and adds p v. Backward: walk 1 forms probs = exp(s - lse),
//     dp = g v^T times the mask, adds delta = sum dp * probs and writes
//     dv; walk 2 forms both again (the same bits),
//     ds = bf16(probs * (dp - delta)), adds dq = ds k in registers and
//     writes dk.
//   - The bf16 probabilities (and ds) go from the accumulator layout
//     straight into the A operand of the next product: the two layouts
//     coincide for m16n8k16. Only the transposed products
//     (dv = dropped^T g, dk = ds^T q) pass a bf16 [64 rows][64 keys]
//     tile through shared memory, read back with the transposing
//     ldmatrix; a warp then owns 16 keys of the tile, rounds its
//     [16][dh] piece into a staging tile and writes it out as whole
//     16-byte chunks, a key's 2 dh bytes side by side.
//   - K, V and the key bias arrive as tiles of 64 keys through 16-byte
//     cp.async copies into a ring of `stages` slots, requested
//     stages - 1 tiles ahead of the product that reads them, one block
//     barrier a tile. Where all tiles of the context fit the ring (the
//     image's 51 keys: one tile) they are requested once and both walks
//     read them in place; otherwise the second walk requests them again
//     (they come from L2: K and V of a call are 33.7 MB of its 50 MB).
//     The host plans `stages` so that two blocks fit a multiprocessor
//     and the 256 blocks of a flagship call are on the card at once.
//   - Rows of q, g, K and V lie in shared memory as in device memory,
//     their 16-byte chunks XOR-swizzled by row (chunk ^ (row & 7)), so
//     that the eight rows of one ldmatrix hit distinct banks.
//   - exp(x) is one product and the hardware's base-2 exponential, of
//     x = s - max or s - lse subtracted first, so equal scores weigh
//     exactly the same. The mask of the ragged last tile is applied in
//     that tile only.
//   - A key past S' in the ragged last tile scores -inf: it is left out
//     of maximum and sum and weighs exactly 0 (its K and V rows are
//     zeros in shared memory). A padded key (bias -1e9) is a key like
//     any other, so an item whose keys are all padded gets the
//     reference's uniform row. Query rows past T are zeros, carry
//     lse = +inf in the backward (probs exactly 0) and are never
//     written.
//   - T > 64: each T tile is a block of its own. The forward's blocks
//     are independent; the backward's write their dk and dv as fp32
//     parts, which a second kernel adds in tile order and rounds once.
//     Every output element is written once after sums in a fixed order:
//     no atomics, a repeated call gives the same bits.
//
// Numerics follow the TPU kernel: fp32 scores plus the fp32 bias, fp32
// softmax and dropout, probabilities rounded to bf16 before the value
// product; in the backward dp is scaled by the mask, delta = sum of
// dp * probs, ds = probs * (dp - delta) rounded to bf16, dq = ds k,
// dk = ds^T q, dv = dropped^T g, every product accumulated in fp32.
//
// Dropout: the TPU draws from its hardware generator, which cannot be
// reproduced here. The seed is mixed as the TPU kernel mixes it,
// key = seed * 2654435761 + ((b + row0) * H_total + h0 + head) (mod 2^32):
// row0 the batch's first row in a data-parallel run's global batch and
// h0 a tensor-parallel rank's first head among H_total (0 and H
// otherwise), so that every rank drops the single process's slots; the bits of
// (key, t, s) come from a stateless hash (common.cuh: fmix32, row_key,
// drop_scale, one copy with flash_generic.cu): the murmur3 finalizer
// fmix32, row_key = fmix32(key ^ fmix32(t + 0x9e3779b9)), bits =
// fmix32(row_key + s). A slot is kept where bits >= threshold =
// floor(p 2^32). The lane that holds (t, s) evaluates the hash, once a
// walk; ops/flash_attention.py computes the same bits in torch integer
// ops. The seed is read from device memory, so drawing it needs no
// host round trip.

#include "common.cuh"

namespace nic {

constexpr int FLASH_THREADS = 128;
constexpr int FLASH_ROWS = 64;        // query rows a block, 16 a warp
constexpr int FLASH_KEYS = 64;        // keys a tile
constexpr int FLASH_MAX_STAGES = 3;   // slots of the K / V ring

// Dynamic shared memory of the two kernels for heads of dh, in order:
// q [64][dh] bf16; in the backward g [64][dh] bf16, the transposed
// products' tile [64][64] bf16 and the staging tile of dk and dv
// [64][dh] bf16; then `stages` slots of K [64][dh] bf16, V [64][dh] bf16
// and the key bias [64] fp32.
__host__ __device__ constexpr int flash_smem_bytes(bool backward, int stages, int dh) {
  return (backward ? 3 : 1) * FLASH_ROWS * dh * 2 +
         (backward ? FLASH_ROWS * FLASH_KEYS * 2 : 0) +
         stages * (2 * FLASH_KEYS * dh * 2 + FLASH_KEYS * 4);
}

// exp(x) as one product and the hardware's base-2 exponential (2 ulp;
// tiny results flush to 0; exp(-inf) = 0). The caller subtracts the
// row's maximum or logsumexp first, so equal scores give exactly 1.
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

struct FlashArgs {
  const bf16* q;      // [B, T, E]
  const bf16* k;      // [B, S, E]
  const bf16* v;      // [B, S, E]
  const float* bias;  // [B, S]
  const int* seed;    // [1]
  int T, S, E;
  int stages;         // slots of the ring; all key tiles where they fit
  uint32_t threshold;
  float scale;
  int row0;           // the batch's first row in the global batch (dropout hash)
  int h0;             // the first head among heads_total (dropout hash)
  int heads_total;
};

// Address of 16-byte chunk `chunk` of row `row` in a swizzled tile
// whose rows hold W bf16.
template <int W>
__device__ __forceinline__ unsigned char* tile_at(unsigned char* tile, int row,
                                                  int chunk) {
  constexpr int CHUNKS = W / 8;
  constexpr int SWZ = (CHUNKS < 8 ? CHUNKS : 8) - 1;
  return tile + row * (W * 2) + ((chunk ^ (row & SWZ)) << 4);
}

// Request the first `valid` of a tile's 64 rows of DH bf16, E apart in
// device memory; the other rows become zeros.
template <int DH>
__device__ __forceinline__ void request_tile(unsigned char* tile, const bf16* src,
                                             int E, int valid) {
  constexpr int CHUNKS = DH / 8;
  for (int i = threadIdx.x; i < 64 * CHUNKS; i += FLASH_THREADS) {
    const int row = i / CHUNKS, c = i % CHUNKS;
    unsigned char* dst = tile_at<DH>(tile, row, c);
    if (row < valid) cp_async16(dst, src + (size_t)row * E + c * 8);
    else zero16(dst);
  }
}

// acc[nt] += a[r0 .. r0 + 16] b^T for the 8 key tiles of 8: a is a
// [64][DH] tile of rows (q or g), b a [64][DH] tile of keys (K or V),
// acc[nt] the mma fragment of rows r0.., keys 8 nt .. 8 nt + 7.
template <int DH>
__device__ __forceinline__ void rows_times_keys(float (&acc)[8][4], unsigned char* a,
                                                int r0, unsigned char* b, int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    // Every fragment of the step is requested before the first product
    // waits for one: the loads' latencies overlap.
    uint32_t af[4], bf[8][2];
    ldmatrix_x4(af, tile_at<DH>(a, r0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      ldmatrix_x2(bf[nt][0], bf[nt][1],
                  tile_at<DH>(b, nt * 8 + (lane & 7), 2 * kk + ((lane >> 3) & 1)));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) mma_bf16(acc[nt], af, bf[nt][0], bf[nt][1]);
  }
}

// acc[nt] += p b over the tile's 64 keys: p [16 rows][64 keys] as A
// fragments (pa[kk] holds keys 16 kk .. 16 kk + 15), b a [64][DH] tile
// of keys (V or K), acc[nt] rows x columns 8 nt .. 8 nt + 7 of DH.
template <int DH>
__device__ __forceinline__ void frags_times_tile(float (&acc)[DH / 8][4],
                                                 const uint32_t (&pa)[4][4],
                                                 unsigned char* b, int lane) {
  const int klane = (lane & 7) + ((lane >> 3) & 1) * 8, nsel = lane >> 4;
#pragma unroll
  for (int kk = 0; kk < FLASH_KEYS / 16; ++kk) {
    uint32_t bf[DH / 16][4];
#pragma unroll
    for (int np = 0; np < DH / 16; ++np)
      ldmatrix_x4_trans(bf[np][0], bf[np][1], bf[np][2], bf[np][3],
                        tile_at<DH>(b, kk * 16 + klane, 2 * np + nsel));
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      mma_bf16(acc[2 * np], pa[kk], bf[np][0], bf[np][1]);
      mma_bf16(acc[2 * np + 1], pa[kk], bf[np][2], bf[np][3]);
    }
  }
}

// acc[nt] = tr^T x for keys key0 .. key0 + 15 of the tile: tr the
// [64 rows][64 keys] bf16 tile (dropped probabilities or ds), x a
// [64][DH] tile of rows (g or q), summed over the 64 rows.
template <int DH>
__device__ __forceinline__ void keys_times_rows(float (&acc)[DH / 8][4],
                                                unsigned char* tr, int key0,
                                                unsigned char* x, int lane) {
  const int klane = (lane & 7) + ((lane >> 3) & 1) * 8, nsel = lane >> 4;
  const int m = lane >> 3;   // which of the four 8 x 8 tiles this lane addresses
#pragma unroll
  for (int kk = 0; kk < FLASH_ROWS / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4_trans(a[0], a[1], a[2], a[3],
                      tile_at<FLASH_KEYS>(tr, kk * 16 + (lane & 7) + 8 * (m >> 1),
                                          key0 / 8 + (m & 1)));
    uint32_t bf[DH / 16][4];
#pragma unroll
    for (int np = 0; np < DH / 16; ++np)
      ldmatrix_x4_trans(bf[np][0], bf[np][1], bf[np][2], bf[np][3],
                        tile_at<DH>(x, kk * 16 + klane, 2 * np + nsel));
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      mma_bf16(acc[2 * np], a, bf[np][0], bf[np][1]);
      mma_bf16(acc[2 * np + 1], a, bf[np][2], bf[np][3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL_MASK, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL_MASK, v, 1);
  return v + __shfl_xor_sync(FULL_MASK, v, 2);
}

// What both kernels share: where the block's operands lie, the ring of
// K / V tiles and the scores of one tile.
template <int DH, bool BACKWARD>
struct FlashBlock {
  static constexpr int TILE = 64 * DH * 2;           // bytes of a q, g, K or V tile
  static constexpr int SLOT = 2 * TILE + FLASH_KEYS * 4;
  const FlashArgs a;
  unsigned char* qs;     // q [64][DH]
  unsigned char* ring;   // the slots
  const bf16* kb;        // this (head, item)'s K and V, key 0
  const bf16* vb;
  const float* bb;
  int n;                 // key tiles
  bool resident;         // every tile has a slot of its own
  int tid, lane, warp, g, t;

  __device__ FlashBlock(const FlashArgs& a_, unsigned char* smem)
      : a(a_), qs(smem), ring(smem + (BACKWARD ? 3 * TILE + FLASH_ROWS * FLASH_KEYS * 2 : TILE)) {
    tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
    const int head = blockIdx.x, b = blockIdx.y;
    const size_t koff = (size_t)b * a.S * a.E + head * DH;
    kb = a.k + koff;
    vb = a.v + koff;
    bb = a.bias + (size_t)b * a.S;
    n = cdiv(a.S, FLASH_KEYS);
    resident = a.stages >= n;
  }

  // Items 0 .. n - 1 are the key tiles of walk 1, n .. 2 n - 1 of walk 2.
  __device__ __forceinline__ int slot_of(int item) const {
    return resident ? item % n : item % a.stages;
  }
  __device__ __forceinline__ unsigned char* k_tile(int item) const {
    return ring + slot_of(item) * SLOT;
  }
  __device__ __forceinline__ int valid_keys(int j) const {
    return min(FLASH_KEYS, a.S - j * FLASH_KEYS);
  }

  // Request an item's tiles into its slot. The forward's first walk
  // reads no V.
  __device__ __forceinline__ void request(int item) const {
    const int j = item % n, valid = valid_keys(j);
    unsigned char* slot = k_tile(item);
    const size_t off = (size_t)j * FLASH_KEYS * a.E;
    request_tile<DH>(slot, kb + off, a.E, valid);
    if (BACKWARD || resident || item >= n)
      request_tile<DH>(slot + TILE, vb + off, a.E, valid);
    if (tid < valid)
      cp_async4(slot + 2 * TILE + tid * 4, bb + j * FLASH_KEYS + tid);
  }

  // The requests made before the walks: the whole context where it is
  // resident, else stages - 1 items, a group each; the caller's q (and
  // g) ride in the first group.
  __device__ __forceinline__ void request_first() const {
    if (resident) {
      for (int j = 0; j < n; ++j) request(j);
      cp_async_commit();
    } else {
      for (int i = 0; i < a.stages - 1; ++i) {
        request(i);
        cp_async_commit();
      }
    }
  }

  // Before item `it` is read: wait until it has landed, for every
  // thread, and request the item that takes the slot item it - 1 left.
  __device__ __forceinline__ void arrive(int it) const {
    cp_async_wait_upto(resident ? 0 : a.stages - 2);
    __syncthreads();
    if (!resident) {
      if (it + a.stages - 1 < 2 * n) request(it + a.stages - 1);
      cp_async_commit();
    }
  }

  // s[nt] = rows r0 .. of q times the item's K, plus the key bias;
  // -inf for a key past S'.
  __device__ __forceinline__ void scores(float (&s)[8][4], int item) const {
    unsigned char* slot = k_tile(item);
    rows_times_keys<DH>(s, qs, warp * 16, slot, lane);
    const float* bs = reinterpret_cast<const float*>(slot + 2 * TILE);
    const int valid = valid_keys(item % n);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      const float2 bias = *reinterpret_cast<const float2*>(bs + col);
      s[nt][0] += bias.x, s[nt][2] += bias.x;
      s[nt][1] += bias.y, s[nt][3] += bias.y;
    }
    if (valid < FLASH_KEYS) {   // the ragged last tile
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t;
        if (col >= valid) s[nt][0] = s[nt][2] = -INFINITY;
        if (col + 1 >= valid) s[nt][1] = s[nt][3] = -INFINITY;
      }
    }
  }
};

// grid = (H, B, T tiles), FLASH_THREADS threads, dynamic shared memory
// flash_smem_bytes(false, stages, DH).
template <int DH>
__global__ void __launch_bounds__(FLASH_THREADS, 2)
flash_fwd_kernel(FlashArgs a, bf16* __restrict__ out, float* __restrict__ lse) {
  extern __shared__ __align__(128) unsigned char smem[];
  FlashBlock<DH, false> blk(a, smem);
  const int lane = blk.lane, warp = blk.warp, g = blk.g, t = blk.t, n = blk.n;
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int t0 = blockIdx.z * FLASH_ROWS, rows = min(FLASH_ROWS, a.T - t0);
  const size_t qoff = ((size_t)b * a.T + t0) * a.E + head * DH;
  const uint32_t key = dropout_key(a.seed[0], b, a.row0, a.heads_total, a.h0, head);

  request_tile<DH>(blk.qs, a.q + qoff, a.E, rows);
  blk.request_first();
  NIC_PHASE(0);   // loads issued

  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const uint32_t rk[2] = {row_key(key, t0 + row[0]), row_key(key, t0 + row[1])};
  float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
  float weight[2];   // of a kept slot's exp(s - max): scale / sum
  float o[DH / 8][4] = {};
  for (int it = 0; it < 2 * n; ++it) {
    blk.arrive(it);
    if (it == 0) NIC_PHASE(1);   // first tile landed
    float s[8][4] = {};
    blk.scores(s, it);
    if (it < n) {
      // Walk 1: the row maximum so far, and the sum of exp(s - max),
      // rescaled where the maximum grew.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) m = fmaxf(m, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
        m = fmaxf(mx[h], quad_max(m));
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          part += fast_exp(s[nt][2 * h] - m) + fast_exp(s[nt][2 * h + 1] - m);
        sum[h] = sum[h] * fast_exp(mx[h] - m) + quad_sum(part);
        mx[h] = m;
      }
      if (it == n - 1) {
        if (t == 0) {
          float* lb = lse + ((size_t)b * H + head) * a.T + t0;
          if (row[0] < rows) lb[row[0]] = mx[0] + logf(sum[0]);
          if (row[1] < rows) lb[row[1]] = mx[1] + logf(sum[1]);
        }
        weight[0] = a.scale / sum[0];
        weight[1] = a.scale / sum[1];
        NIC_PHASE(2);   // walk 1: row maxima and sums
      }
    } else {
      // Walk 2: p = exp(s - max) * scale / sum where kept, rounded, times V.
      const int s0 = (it - n) * FLASH_KEYS;
      uint32_t pa[4][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float p[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int h = c >> 1;
          p[c] = fast_exp(s[nt][c] - mx[h]) *
                 drop_scale(rk[h], s0 + nt * 8 + 2 * t + (c & 1), a.threshold, weight[h]);
        }
        pa[nt / 2][(nt & 1) * 2] = pack_bf16(p[0], p[1]);
        pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
      frags_times_tile<DH>(o, pa, blk.k_tile(it) + blk.TILE, lane);
    }
  }
  NIC_PHASE(3);   // walk 2: p v

  bf16* ob = out + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row[h] * a.E + nt * 8 + 2 * t) =
          pack_bf16(o[nt][2 * h], o[nt][2 * h + 1]);
  }
  NIC_PHASE(4);   // out written
}

// The warp's 16 keys x DH of a dk or dv tile. One T tile: rounded into
// the warp's rows of the staging tile, then written to `to` as whole
// 16-byte chunks, a key's 2 DH bytes side by side. Several T tiles:
// as fp32 into `part`, to be added later. Both point at the tile's
// key 0, this head's column 0.
template <int DH>
__device__ __forceinline__ void store_keys(const float (&acc)[DH / 8][4],
                                           unsigned char* stage, bf16* to, float* part,
                                           int E, int key0, int valid, int lane) {
  const int g = lane / 4, t = lane % 4;
  if (part != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + g + 8 * h;
      if (key >= valid) continue;
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
        *reinterpret_cast<float2*>(part + (size_t)key * E + nt * 8 + 2 * t) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<uint32_t*>(tile_at<DH>(stage, key0 + g + 8 * h, nt) + 4 * t) =
          pack_bf16(acc[nt][2 * h], acc[nt][2 * h + 1]);
  __syncwarp();
  constexpr int CHUNKS = DH / 8;
#pragma unroll
  for (int i = lane; i < 16 * CHUNKS; i += 32) {
    const int key = key0 + i / CHUNKS, c = i % CHUNKS;
    if (key < valid)
      *reinterpret_cast<uint4*>(to + (size_t)key * E + c * 8) =
          *reinterpret_cast<const uint4*>(tile_at<DH>(stage, key, c));
  }
  __syncwarp();   // the rows are free for the warp's next tile
}

// grid = (H, B, T tiles), FLASH_THREADS threads, dynamic shared memory
// flash_smem_bytes(true, stages, DH). parts: null for one T tile, else
// fp32 [2 (dk, dv)][T tiles][B, S, E].
template <int DH>
__global__ void __launch_bounds__(FLASH_THREADS, 2)
flash_bwd_kernel(FlashArgs a, const float* __restrict__ lse,
                 const bf16* __restrict__ gout, bf16* __restrict__ dq,
                 bf16* __restrict__ dk, bf16* __restrict__ dv,
                 float* __restrict__ parts) {
  extern __shared__ __align__(128) unsigned char smem[];
  FlashBlock<DH, true> blk(a, smem);
  unsigned char* gs = smem + blk.TILE;       // g [64][DH]
  unsigned char* tr = smem + 2 * blk.TILE;   // [64 rows][64 keys] bf16
  unsigned char* stage = tr + FLASH_ROWS * FLASH_KEYS * 2;   // a dk or dv tile [64][DH]
  const int lane = blk.lane, warp = blk.warp, g = blk.g, t = blk.t, n = blk.n;
  const int head = blockIdx.x, b = blockIdx.y, H = gridDim.x, B = gridDim.y;
  const int t0 = blockIdx.z * FLASH_ROWS, rows = min(FLASH_ROWS, a.T - t0);
  const size_t qoff = ((size_t)b * a.T + t0) * a.E + head * DH;
  const size_t koff = (size_t)b * a.S * a.E + head * DH;
  const uint32_t key = dropout_key(a.seed[0], b, a.row0, a.heads_total, a.h0, head);
  const size_t kv_elems = (size_t)B * a.S * a.E;
  float* dk_part = parts == nullptr ? nullptr : parts + blockIdx.z * kv_elems + koff;
  float* dv_part = parts == nullptr ? nullptr
                                    : parts + (gridDim.z + blockIdx.z) * kv_elems + koff;

  request_tile<DH>(blk.qs, a.q + qoff, a.E, rows);
  request_tile<DH>(gs, gout + qoff, a.E, rows);
  blk.request_first();
  NIC_PHASE(0);   // loads issued

  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};
  const uint32_t rk[2] = {row_key(key, t0 + row[0]), row_key(key, t0 + row[1])};
  const float* lb = lse + ((size_t)b * H + head) * a.T + t0;
  // A row past T: probs = exp(s - inf) = 0.
  const float lrow[2] = {row[0] < rows ? lb[row[0]] : INFINITY,
                         row[1] < rows ? lb[row[1]] : INFINITY};
  float delta[2] = {0.f, 0.f};
  float dqa[DH / 8][4] = {};
  for (int it = 0; it < 2 * n; ++it) {
    blk.arrive(it);
    if (it == 0) NIC_PHASE(1);   // first tile landed
    const int j = it % n, s0 = j * FLASH_KEYS, valid = blk.valid_keys(j);
    unsigned char* slot = blk.k_tile(it);
    float pr[8][4] = {}, dp[8][4] = {};
    blk.scores(pr, it);
    rows_times_keys<DH>(dp, gs, warp * 16, slot + blk.TILE, lane);
    uint32_t da[4][4];   // walk 2: ds as A fragments
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float x[4];   // walk 1: the dropped probabilities; walk 2: ds
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        const float p = fast_exp(pr[nt][c] - lrow[h]);
        const float m = drop_scale(rk[h], s0 + nt * 8 + 2 * t + (c & 1), a.threshold, a.scale);
        const float d = dp[nt][c] * m;
        if (it < n) {
          delta[h] += d * p;
          x[c] = p * m;
        } else {
          x[c] = p * (d - delta[h]);
        }
      }
      const uint32_t top = pack_bf16(x[0], x[1]), bot = pack_bf16(x[2], x[3]);
      *reinterpret_cast<uint32_t*>(tile_at<FLASH_KEYS>(tr, row[0], nt) + 4 * t) = top;
      *reinterpret_cast<uint32_t*>(tile_at<FLASH_KEYS>(tr, row[1], nt) + 4 * t) = bot;
      da[nt / 2][(nt & 1) * 2] = top;
      da[nt / 2][(nt & 1) * 2 + 1] = bot;
    }
    if (it >= n) frags_times_tile<DH>(dqa, da, slot, lane);   // dq += ds k
    __syncthreads();   // the tile of dropped probabilities or ds is whole
    float acc[DH / 8][4] = {};
    if (it < n) {
      keys_times_rows<DH>(acc, tr, warp * 16, gs, lane);       // dv = dropped^T g
      store_keys<DH>(acc, stage, dv + koff + (size_t)s0 * a.E,
                     dv_part == nullptr ? nullptr : dv_part + (size_t)s0 * a.E, a.E,
                     warp * 16, valid, lane);
    } else {
      keys_times_rows<DH>(acc, tr, warp * 16, blk.qs, lane);   // dk = ds^T q
      store_keys<DH>(acc, stage, dk + koff + (size_t)s0 * a.E,
                     dk_part == nullptr ? nullptr : dk_part + (size_t)s0 * a.E, a.E,
                     warp * 16, valid, lane);
    }
    if (it == n - 1) {
      // The lanes of a quad hold a row's columns: its delta, in a
      // fixed order.
      delta[0] = quad_sum(delta[0]);
      delta[1] = quad_sum(delta[1]);
      NIC_PHASE(2);   // walk 1: probs, dp, delta, dv
    }
  }
  NIC_PHASE(3);   // walk 2: ds, dq, dk

  bf16* dqb = dq + qoff;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= rows) continue;
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt)
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row[h] * a.E + nt * 8 + 2 * t) =
          pack_bf16(dqa[nt][2 * h], dqa[nt][2 * h + 1]);
  }
  NIC_PHASE(4);   // dq written
}

// dk and dv of a backward over several T tiles: the tiles' fp32 parts
// [2][tiles][pairs] added in tile order and rounded once. grid.y = 2.
__global__ void flash_add_parts_kernel(const float2* __restrict__ parts,
                                       uint32_t* __restrict__ dk,
                                       uint32_t* __restrict__ dv, int tiles,
                                       size_t pairs) {
  const float2* src = parts + (size_t)blockIdx.y * tiles * pairs;
  uint32_t* dst = blockIdx.y == 0 ? dk : dv;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < pairs;
       i += (size_t)gridDim.x * blockDim.x) {
    float2 sum = src[i];
    for (int z = 1; z < tiles; ++z) {
      const float2 part = src[(size_t)z * pairs + i];
      sum.x += part.x, sum.y += part.y;
    }
    dst[i] = pack_bf16(sum.x, sum.y);
  }
}

inline bool flash_plan_ok(int B, int T, int S, int E, int H, int stages, int smem,
                          bool backward) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || E % H != 0) return false;
  const int n = cdiv(S, FLASH_KEYS);
  if (stages < 1 || stages > FLASH_MAX_STAGES || stages > n) return false;
  if (stages < n && stages < 2) return false;   // a ring needs two slots
  if (B > 65535 || cdiv(T, FLASH_ROWS) > 65535) return false;
  return smem == flash_smem_bytes(backward, stages, E / H) && smem <= MAX_SMEM_BYTES;
}

template <int DH>
static cudaError_t launch_flash_fwd(const FlashArgs& a, bf16* out, float* lse, int B,
                                    int H, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DH><<<dim3(H, B, cdiv(a.T, FLASH_ROWS)), FLASH_THREADS, smem, stream>>>(
      a, out, lse);
  return cudaGetLastError();
}

template <int DH>
static cudaError_t launch_flash_bwd(const FlashArgs& a, const float* lse, const bf16* g,
                                    bf16* dq, bf16* dk, bf16* dv, float* parts, int B,
                                    int H, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = cdiv(a.T, FLASH_ROWS);
  flash_bwd_kernel<DH><<<dim3(H, B, tiles), FLASH_THREADS, smem, stream>>>(
      a, lse, g, dq, dk, dv, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return err;
  const size_t pairs = (size_t)B * a.S * a.E / 2;
  const int blocks = (int)((pairs + 255) / 256 < 4096 ? (pairs + 255) / 256 : 4096);
  flash_add_parts_kernel<<<dim3(blocks, 2), 256, 0, stream>>>(
      (const float2*)parts, (uint32_t*)dk, (uint32_t*)dv, tiles, pairs);
  return cudaGetLastError();
}

}  // namespace nic

NIC_DEFINE_PHASE_READER(nic_flash_phases)

#define NIC_FLASH_SWITCH(dh, CALL) \
  switch (dh) {                    \
    case 16: err = CALL(16); break;   \
    case 32: err = CALL(32); break;   \
    case 64: err = CALL(64); break;   \
    case 128: err = CALL(128); break; \
    default: return (int)cudaErrorInvalidValue; \
  }

// out [B, T, E] (bf16) and lse [B, H, T] (fp32) of flash cross-attention
// of q over k, v [B, S, E] (bf16, 16-byte aligned) with key bias [B, S]
// and the int32 seed at `seed` (device memory). E / H in {16, 32, 64,
// 128}. threshold = floor(p 2^32) (0: no dropout), scale = 1 / (1 - p).
// The caller plans `stages` slots of 64 keys (1..3, at most the key
// tiles; all of them or at least 2) and `smem`, which must equal
// flash_smem_bytes(false, stages, E / H). row0: the batch's first row in
// the global batch, h0 the first of the H heads among heads_total (>= h0 +
// H), for the dropout hash. Returns a cudaError_t.
extern "C" int nic_flash_fwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, void* out,
                             void* lse, int B, int T, int S, int E, int H,
                             unsigned threshold, float scale, int stages, int smem,
                             int row0, int h0, int heads_total, void* stream) {
  using namespace nic;
  if (!flash_plan_ok(B, T, S, E, H, stages, smem, false) || h0 < 0 ||
      heads_total < h0 + H)
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                    (const int*)seed, T, S, E, stages, threshold, scale, row0,
                    h0, heads_total};
  cudaError_t err;
#define NIC_FLASH_FWD(DH) \
  launch_flash_fwd<DH>(a, (bf16*)out, (float*)lse, B, H, smem, (cudaStream_t)stream)
  NIC_FLASH_SWITCH(E / H, NIC_FLASH_FWD)
#undef NIC_FLASH_FWD
  return (int)err;
}

// dq [B, T, E], dk, dv [B, S, E] (bf16) of the above, from its saved
// lse and the output gradient g [B, T, E] (bf16, 16-byte aligned).
// `smem` must equal flash_smem_bytes(true, stages, E / H). `parts`:
// fp32 scratch of 2 * ceil(T / 64) * B * S * E elements where T > 64,
// else null.
extern "C" int nic_flash_bwd(const void* q, const void* k, const void* v,
                             const void* bias, const void* seed, const void* lse,
                             const void* g, void* dq, void* dk, void* dv,
                             void* parts, int B, int T, int S, int E, int H,
                             unsigned threshold, float scale, int stages, int smem,
                             int row0, int h0, int heads_total, void* stream) {
  using namespace nic;
  if (!flash_plan_ok(B, T, S, E, H, stages, smem, true) ||
      ((T > FLASH_ROWS) != (parts != nullptr)) || h0 < 0 || heads_total < h0 + H)
    return (int)cudaErrorInvalidValue;
  const FlashArgs a{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias,
                    (const int*)seed, T, S, E, stages, threshold, scale, row0,
                    h0, heads_total};
  cudaError_t err;
#define NIC_FLASH_BWD(DH)                                                     \
  launch_flash_bwd<DH>(a, (const float*)lse, (const bf16*)g, (bf16*)dq, (bf16*)dk, \
                       (bf16*)dv, (float*)parts, B, H, smem, (cudaStream_t)stream)
  NIC_FLASH_SWITCH(E / H, NIC_FLASH_BWD)
#undef NIC_FLASH_BWD
  return (int)err;
}
