// Few-query cross-attention over per-item context K/V, for decode:
// out[b, q, head] = softmax(q_h k_h^T + bias[b]) v_h, fp32 scores and
// softmax over the whole context, probabilities rounded to bf16 before
// the value product, the fp32 output rounded once.
//
// Replaces: news_image_caption_tpu/ops/pallas_kernels.py
// decode_cross_attention (_decode_xattn_kernel).
//
// What bounds it on the card: bytes. A decode step at batch 16 reads
// the article context (S' = 514 keys x 1024 x bf16) as 16.8 MB of K and
// as much of V a layer, 10 us at 3.35 TB/s, against 34 MFLOP. A head's
// K and V of one item are 2 x 514 rows of 128 contiguous bytes. The
// card reaches its memory rate only with a few MB of loads in flight,
// so nothing may wait for anything else to arrive.
//
// Design.
//   - grid (H, B, splits): `splits` blocks, one cluster, share the keys
//     of one (head, item) in contiguous runs of `per` keys. The host
//     picks splits so that every multiprocessor holds several blocks
//     (2 splits at batch 16, about 4 blocks a multiprocessor; 7 splits
//     at batch 1; 1 for a short context). A
//     block requests q and every one of its K rows with 16-byte
//     cp.async copies in its first instructions: no tile walk, one
//     memory round trip for K. As soon as the scores are taken it
//     requests every V row into K's place, and V arrives while the
//     softmax is computed. (K and V of a call, 33.7 MB, are more than
//     the card's 30 MB of shared memory: with both requested at entry
//     the blocks came in two rounds, one waiting for the other's whole
//     life. With V in K's place all blocks of a call are on the card
//     at once, and the rounds of blocks overlap instead.)
//   - Scores for all Q <= 16 query rows at once on the tensor cores
//     (mma.sync m16n8k16, q zero-padded to the 16-row operand, read
//     straight from device memory into registers), plus the fp32 key
//     bias, kept in shared memory. Keys past S' score -inf and weigh
//     exactly 0; their K and V rows are zeros in shared memory.
//   - The reference's softmax, not an online one: every block takes its
//     row maxima and sums and writes them into the shared memory of
//     every block of its cluster (distributed shared memory; one
//     cluster barrier), and p = exp(s - max) / sum with the max and sum
//     of the whole S' is rounded to bf16, as the reference rounds it.
//   - p V on the tensor cores, V read k-major through a transposing
//     ldmatrix. A block writes each pair of its fp32 partial output
//     from registers into the shared memory of the block that adds that
//     pair (one more cluster barrier, none before the exit); the parts
//     are added in rank order and rounded once: the result is the same
//     on every run.
// Rows of K and V lie in shared memory as in device memory, 16-byte
// chunks XOR-swizzled by key so that ldmatrix hits distinct banks.
//
// The int8 variant (nic_decode_attention_int8, the same kernel with Q8
// set) takes int8 K and V with one scale a (item, key, head), the
// layout of ops/attention.py::quantize_kv. It replaces no TPU kernel of
// its own: the reference computes its quantized route in XLA
// (news_image_caption_tpu/ops/attention.py::attend_flat_beam over
// QuantDecodeKV), and on the card a tensor launches a kernel or raises.
// Bound: bytes, as the bf16 kernel, with K and V half as many (8.4 MB
// each a layer at batch 16) and the scales beside them (0.5 MB). Design:
// the bf16 kernel's plan, loads, softmax and cluster reduction; the
// int8 rows land in shared memory as they are (a row padded by 16 bytes,
// so that the 8 keys a fragment reads fall in distinct banks) and are
// turned into bf16 where a fragment is built (exact for |q| <= 127).
// The scales factor out of both products in the reference's order
// (ops/attention.py:295-317): the fp32 score of a key times its K
// scale, before the key bias and the softmax; the probability, rounded
// to bf16, times the key's V scale, rounded to bf16 again, before the
// value product.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace nic {

constexpr int ATTN_THREADS = 128;
constexpr int ATTN_WARPS = ATTN_THREADS / 32;
constexpr int ATTN_MAX_Q = 16;    // the mma's M
constexpr int ATTN_PAD = 8;       // elements added to a row of s and p
constexpr int ATTN_MAX_SPLITS = 8;   // blocks a cluster

// Bytes a K / V row of one head takes in shared memory: dh bf16, or
// dh int8 and 16 bytes of padding.
__host__ __device__ constexpr int attn_row_bytes(int dh, bool q8) {
  return q8 ? dh + 16 : dh * 2;
}

// Dynamic shared memory of decode_attention_kernel for Q query rows
// and `per` keys a block (a multiple of 16), in order: K [per] rows
// (attn_row_bytes), which V replaces; scores [Q][per + 8] fp32; p
// [Q][per + 8] bf16; the key bias [per] fp32 and, for int8 K/V, the K
// and V scales [per] fp32 each; the warps' row maxima and sums
// [2][4][16], every block's row maximum and sum [8][2][16] and the
// context's [2][16], fp32; every block's share of the output this
// block adds, Q * dh / 2 + 8 pairs of fp32.
__host__ __device__ constexpr int attn_smem_bytes(int Q, int per, int dh,
                                                  bool q8) {
  return per * attn_row_bytes(dh, q8) + Q * (per + ATTN_PAD) * (4 + 2) +
         per * 4 * (q8 ? 3 : 1) +
         (2 * ATTN_WARPS + 2 * ATTN_MAX_SPLITS + 2) * ATTN_MAX_Q * 4 +
         (Q * dh / 2 + ATTN_MAX_SPLITS) * 8;
}

// The two halves of the cluster's barrier. What a block wrote into
// another's shared memory before it arrived is there after the wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// grid = (H, B, splits), one cluster of `splits` blocks along z. Q8:
// k and v are int8 with the scales k_scale, v_scale [B, S, H] bf16;
// otherwise bf16, and the scales are not read.
template <int DH, bool Q8>
__global__ void __launch_bounds__(ATTN_THREADS)
decode_attention_kernel(const bf16* __restrict__ q, const void* __restrict__ k,
                        const void* __restrict__ v,
                        const bf16* __restrict__ k_scale,
                        const bf16* __restrict__ v_scale,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        int Q, int S, int E, int per) {
  // 16-byte chunks a K / V row in device memory.
  constexpr int CHUNKS = Q8 ? DH / 16 : DH / 8;
  // bf16 rows: chunk ^ (key & SWZ); int8 rows are padded instead.
  constexpr int SWZ = Q8 ? 0 : (CHUNKS < 8 ? CHUNKS : 8) - 1;
  constexpr int ROW = attn_row_bytes(DH, Q8);          // bytes a row
  constexpr int ESIZE = Q8 ? 1 : 2;                     // bytes an element
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int head = blockIdx.x, b = blockIdx.y;
  const int nsplit = (int)cluster.num_blocks(), split = (int)cluster.block_rank();
  const int s_lo = split * per;
  const int n = min(per, S - s_lo);          // keys of this block, >= 1
  const int n16 = (n + 15) & ~15;            // as whole mma steps
  const int ss = per + ATTN_PAD;             // elements a row of s and p
  // The cluster's blocks must all have started before one writes into
  // another's shared memory: arrive now, wait before the first write.
  if (nsplit > 1) cluster_arrive();

  unsigned char* kv = smem;                  // K, then V in its place
  float* sc = reinterpret_cast<float*>(kv + per * ROW);
  bf16* ps = reinterpret_cast<bf16*>(sc + Q * ss);
  float* bs = reinterpret_cast<float*>(ps + Q * ss);
  float* ksc = bs + per;                     // int8 K/V: scales [per] each
  float* vsc = ksc + per;
  float* wmax = bs + per * (Q8 ? 3 : 1);                // [4][16]
  float* wsum = wmax + ATTN_WARPS * ATTN_MAX_Q;         // [4][16]
  float* stats = wsum + ATTN_WARPS * ATTN_MAX_Q;        // [8][2][16]
  float* fin = stats + 2 * ATTN_MAX_SPLITS * ATTN_MAX_Q;  // [2][16]
  float2* recv = reinterpret_cast<float2*>(fin + 2 * ATTN_MAX_Q);

  // q first, as the A operand (rows past Q as zeros): the scores need
  // it as soon as K is there, and a load issued after K's and V's
  // would arrive after them.
  uint32_t qa[DH / 16][4];
  {
    const bf16* qb = q + (size_t)b * Q * E + head * DH;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const int col = kk * 16 + 2 * t;
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(qb + (size_t)g * E + col);
      const uint32_t* hi = reinterpret_cast<const uint32_t*>(qb + (size_t)(g + 8) * E + col);
      qa[kk][0] = g < Q ? __ldg(lo) : 0u;
      qa[kk][1] = g + 8 < Q ? __ldg(hi) : 0u;
      qa[kk][2] = g < Q ? __ldg(lo + 4) : 0u;
      qa[kk][3] = g + 8 < Q ? __ldg(hi + 4) : 0u;
    }
  }
  // The key bias and every row of K, at once; rows past the block's
  // keys are zeros, and stay zeros when V takes K's place.
  const unsigned char* kb = static_cast<const unsigned char*>(k) +
                            (((size_t)b * S + s_lo) * E + head * DH) * ESIZE;
  const unsigned char* vb = static_cast<const unsigned char*>(v) +
                            (((size_t)b * S + s_lo) * E + head * DH) * ESIZE;
  const size_t key_bytes = (size_t)E * ESIZE;   // from one key to the next
  for (int i = tid; i < n; i += ATTN_THREADS)
    cp_async4(bs + i, bias + (size_t)b * S + s_lo + i);
  for (int i = tid; i < n16 * CHUNKS; i += ATTN_THREADS) {
    const int key = i / CHUNKS, c = i % CHUNKS;
    unsigned char* dst = kv + key * ROW + ((c ^ (key & SWZ)) << 4);
    if (key < n) cp_async16(dst, kb + key * key_bytes + c * 16);
    else zero16(dst);
  }
  cp_async_commit();
  if constexpr (Q8) {
    // The keys' scales of this head, fp32 (each read once: the host
    // waits for nothing here, the loads overlap K's copies).
    const int H = gridDim.x;
    for (int i = tid; i < n; i += ATTN_THREADS) {
      const size_t o = ((size_t)b * S + s_lo + i) * H + head;
      ksc[i] = to_f(k_scale[o]);
      vsc[i] = to_f(v_scale[o]);
    }
  }
  NIC_PHASE(0);   // loads issued
  cp_async_wait<0>();
  __syncthreads();   // K and the bias are in place
  NIC_PHASE(1);   // K landed

  // Scores: warp w takes the 8-key tiles w, w + 4, ...
  for (int nt = warp; nt < n16 / 8; nt += ATTN_WARPS) {
    float c4[4] = {};
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t b0, b1;
      if constexpr (Q8) {
        // Dims kk * 16 + 2t, + 1 and + 8, + 9 of key g of the tile.
        const unsigned char* row = kv + (nt * 8 + g) * ROW + kk * 16 + 2 * t;
        b0 = i8pair_to_bf16x2(row);
        b1 = i8pair_to_bf16x2(row + 8);
      } else {
        const int key = nt * 8 + (lane & 7);
        const int c = 2 * kk + ((lane >> 3) & 1);
        ldmatrix_x2(b0, b1, kv + key * ROW + ((c ^ (key & SWZ)) << 4));
      }
      mma_bf16(c4, qa[kk], b0, b1);
    }
    const int col = nt * 8 + 2 * t;
    const float bias0 = col < n ? bs[col] : 0.f;
    const float bias1 = col + 1 < n ? bs[col + 1] : 0.f;
    if constexpr (Q8) {
      const float ks0 = col < n ? ksc[col] : 0.f;
      const float ks1 = col + 1 < n ? ksc[col + 1] : 0.f;
      c4[0] *= ks0;
      c4[1] *= ks1;
      c4[2] *= ks0;
      c4[3] *= ks1;
    }
    const float2 top = make_float2(col < n ? c4[0] + bias0 : -INFINITY,
                                   col + 1 < n ? c4[1] + bias1 : -INFINITY);
    const float2 bot = make_float2(col < n ? c4[2] + bias0 : -INFINITY,
                                   col + 1 < n ? c4[3] + bias1 : -INFINITY);
    if (g < Q) *reinterpret_cast<float2*>(sc + g * ss + col) = top;
    if (g + 8 < Q) *reinterpret_cast<float2*>(sc + (g + 8) * ss + col) = bot;
  }
  __syncthreads();
  // K is spent: every row of V, at once, into its place. It arrives
  // while the softmax is computed.
  for (int i = tid; i < n * CHUNKS; i += ATTN_THREADS) {
    const int key = i / CHUNKS, c = i % CHUNKS;
    cp_async16(kv + key * ROW + ((c ^ (key & SWZ)) << 4),
               vb + key * key_bytes + c * 16);
  }
  cp_async_commit();
  NIC_PHASE(2);   // scores, V requested

  // The block's row maxima and sums. A thread takes the keys tid,
  // tid + 128, ... of every row; warps, then the block, combine.
  for (int r = 0; r < Q; ++r) {
    float mx = -INFINITY;
    for (int i = tid; i < n16; i += ATTN_THREADS) mx = fmaxf(mx, sc[r * ss + i]);
    mx = warp_max(mx);
    if (lane == 0) wmax[warp * ATTN_MAX_Q + r] = mx;
  }
  __syncthreads();
  for (int r = 0; r < Q; ++r) {
    float mx = wmax[r];
#pragma unroll
    for (int w = 1; w < ATTN_WARPS; ++w) mx = fmaxf(mx, wmax[w * ATTN_MAX_Q + r]);
    float sum = 0.f;
    for (int i = tid; i < n16; i += ATTN_THREADS) sum += expf(sc[r * ss + i] - mx);
    sum = warp_sum(sum);
    if (lane == 0) wsum[warp * ATTN_MAX_Q + r] = sum;
  }
  __syncthreads();
  NIC_PHASE(3);   // row maxima and sums
  // Thread (z, r) writes this block's maximum and sum of row r into
  // block z's shared memory.
  if (nsplit > 1) cluster_wait();
  if (tid < nsplit * Q) {
    const int z = tid / Q, r = tid % Q;
    float mx = wmax[r], sum = wsum[r];
#pragma unroll
    for (int w = 1; w < ATTN_WARPS; ++w) {
      mx = fmaxf(mx, wmax[w * ATTN_MAX_Q + r]);
      sum += wsum[w * ATTN_MAX_Q + r];
    }
    float* theirs = nsplit > 1 ? cluster.map_shared_rank(stats, z) : stats;
    theirs[(2 * split) * ATTN_MAX_Q + r] = mx;
    theirs[(2 * split + 1) * ATTN_MAX_Q + r] = sum;
  }
  if (nsplit > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  NIC_PHASE(4);   // cluster barrier

  // The max and sum of the whole S', blocks in rank order, then p.
  if (tid < Q) {
    float mx = -INFINITY;
    for (int z = 0; z < nsplit; ++z) mx = fmaxf(mx, stats[2 * z * ATTN_MAX_Q + tid]);
    float sum = 0.f;
    for (int z = 0; z < nsplit; ++z)
      sum += stats[(2 * z + 1) * ATTN_MAX_Q + tid] *
             expf(stats[2 * z * ATTN_MAX_Q + tid] - mx);
    fin[tid] = mx;
    fin[ATTN_MAX_Q + tid] = sum;
  }
  __syncthreads();
  for (int r = 0; r < Q; ++r) {
    const float mx = fin[r], sum = fin[ATTN_MAX_Q + r];
    for (int i = tid; i < n16; i += ATTN_THREADS) {
      const float p = expf(sc[r * ss + i] - mx) / sum;
      if constexpr (Q8)   // keys past n weigh 0 (their scale is not set)
        ps[r * ss + i] = to_bf(i < n ? rbf(p) * vsc[i] : 0.f);
      else
        ps[r * ss + i] = to_bf(p);
    }
  }
  NIC_PHASE(5);   // p
  cp_async_wait<0>();
  __syncthreads();   // p and V are in place
  NIC_PHASE(6);   // V landed

  // p V: warp w takes the 16-column pairs of d tiles w, w + 4, ... and
  // writes each pair of output columns into the shared memory of the
  // block that adds it: pair u of the [Q, dh / 2] pairs goes to block
  // u % splits, place u / splits of this block's part there.
  const int klane = (lane & 7) + ((lane >> 3) & 1) * 8, nsel = lane >> 4;
  const int share = (Q * (DH / 2) + nsplit - 1) / nsplit;   // pairs a block adds
  for (int np = warp; np < DH / 16; np += ATTN_WARPS) {
    float o[2][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < n16 / 16; ++kk) {
      uint32_t a[4], b0, b1, b2, b3;
      const uint32_t* lo = reinterpret_cast<const uint32_t*>(ps + g * ss + kk * 16 + 2 * t);
      const uint32_t* hi = lo + 4 * ss;     // row g + 8
      a[0] = g < Q ? lo[0] : 0u;
      a[1] = g + 8 < Q ? hi[0] : 0u;
      a[2] = g < Q ? lo[4] : 0u;
      a[3] = g + 8 < Q ? hi[4] : 0u;
      if constexpr (Q8) {
        // Keys kk * 16 + 2t, + 1 (and + 8, + 9) at dim np * 16 + g (and
        // + 8): two rows' bytes a pair.
        const unsigned char* at = kv + (kk * 16 + 2 * t) * ROW + np * 16 + g;
        b0 = i8x2_to_bf16x2((int8_t)at[0], (int8_t)at[ROW]);
        b1 = i8x2_to_bf16x2((int8_t)at[8 * ROW], (int8_t)at[9 * ROW]);
        b2 = i8x2_to_bf16x2((int8_t)at[8], (int8_t)at[ROW + 8]);
        b3 = i8x2_to_bf16x2((int8_t)at[8 * ROW + 8], (int8_t)at[9 * ROW + 8]);
      } else {
        const int key = kk * 16 + klane, c = 2 * np + nsel;
        ldmatrix_x4_trans(b0, b1, b2, b3,
                          kv + key * ROW + ((c ^ (key & SWZ)) << 4));
      }
      mma_bf16(o[0], a, b0, b1);
      mma_bf16(o[1], a, b2, b3);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g + 8 * half;
        if (r >= Q) continue;
        const int u = r * (DH / 2) + np * 8 + nt * 4 + t;
        float2* theirs = nsplit > 1 ? cluster.map_shared_rank(recv, u % nsplit) : recv;
        theirs[split * share + u / nsplit] =
            make_float2(o[nt][2 * half], o[nt][2 * half + 1]);
      }
    }
  }
  NIC_PHASE(7);   // p V
  if (nsplit > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  NIC_PHASE(8);   // cluster barrier

  // This block's share of the output: the blocks' parts added in rank
  // order and rounded once.
  bf16* ob = out + (size_t)b * Q * E + head * DH;
  for (int j = tid; j < share; j += ATTN_THREADS) {
    const int u = j * nsplit + split;
    if (u >= Q * (DH / 2)) continue;
    float2 sum = make_float2(0.f, 0.f);
    for (int z = 0; z < nsplit; ++z) {
      const float2 part = recv[z * share + j];
      sum.x += part.x, sum.y += part.y;
    }
    const int r = u / (DH / 2), col = (u % (DH / 2)) * 2;
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * E + col) =
        __floats2bfloat162_rn(sum.x, sum.y);
  }
  NIC_PHASE(9);   // out written
}

template <int DH, bool Q8>
static cudaError_t launch_decode_attention(const bf16* q, const void* k,
                                           const void* v, const bf16* k_scale,
                                           const bf16* v_scale,
                                           const float* bias, bf16* out,
                                           int B, int Q, int S, int E, int H,
                                           int splits, int per, int smem,
                                           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<DH, Q8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(H, B, splits);
  cfg.blockDim = dim3(ATTN_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_attention_kernel<DH, Q8>, q, k, v,
                           k_scale, v_scale, bias, out, Q, S, E, per);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Checks the caller's plan and launches the variant of its head size.
template <bool Q8>
static int decode_attention_entry(const void* q, const void* k,
                                  const void* k_scale, const void* v,
                                  const void* v_scale, const void* bias,
                                  void* out, int B, int Q, int S, int E,
                                  int H, int splits, int per, int smem,
                                  void* stream) {
  if (B < 1 || Q < 1 || Q > ATTN_MAX_Q || S < 1 || H < 1 || E % H != 0 ||
      splits < 1 || splits > ATTN_MAX_SPLITS || per < 16 || per % 16 != 0 ||
      (long long)(splits - 1) * per >= S || (long long)splits * per < S)
    return (int)cudaErrorInvalidValue;
  const int dh = E / H;
  if (smem != attn_smem_bytes(Q, per, dh, Q8) || smem > MAX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
#define NIC_ATTN_CASE(DH)                                                   \
  case DH:                                                                  \
    err = launch_decode_attention<DH, Q8>(                                  \
        (const bf16*)q, k, v, (const bf16*)k_scale, (const bf16*)v_scale,   \
        (const float*)bias, (bf16*)out, B, Q, S, E, H, splits, per, smem,   \
        (cudaStream_t)stream);                                              \
    break;
  switch (dh) {
    NIC_ATTN_CASE(16)
    NIC_ATTN_CASE(32)
    NIC_ATTN_CASE(64)
    NIC_ATTN_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef NIC_ATTN_CASE
  return (int)err;
}

}  // namespace nic

NIC_DEFINE_PHASE_READER(nic_decode_attention_phases)

// out [B, Q, E] = decode cross-attention of q [B, Q, E] (pre-scaled)
// over k, v [B, S, E] (bf16, 16-byte aligned) with fp32 key bias
// [B, S]. 1 <= Q <= 16, S >= 1, E / H in {16, 32, 64, 128}. The caller
// plans `splits` (1..8) blocks of `per` keys (a multiple of 16) for
// each (head, item), with (splits - 1) * per < S <= splits * per, and
// `smem`, which must equal attn_smem_bytes(Q, per, E / H, false).
// Returns a cudaError_t.
extern "C" int nic_decode_attention(const void* q, const void* k,
                                    const void* v, const void* bias,
                                    void* out, int B, int Q, int S, int E,
                                    int H, int splits, int per, int smem,
                                    void* stream) {
  return nic::decode_attention_entry<false>(q, k, nullptr, v, nullptr, bias,
                                            out, B, Q, S, E, H, splits, per,
                                            smem, stream);
}

// The same over int8 k, v [B, S, E] (16-byte aligned) with bf16 scales
// k_scale, v_scale [B, S, H]: scores (q . k_q) * k_scale + bias, and
// p V as round_bf16(round_bf16(p) * v_scale) . v_q. `smem` must equal
// attn_smem_bytes(Q, per, E / H, true). Returns a cudaError_t.
extern "C" int nic_decode_attention_int8(const void* q, const void* k,
                                         const void* k_scale, const void* v,
                                         const void* v_scale,
                                         const void* bias, void* out, int B,
                                         int Q, int S, int E, int H,
                                         int splits, int per, int smem,
                                         void* stream) {
  return nic::decode_attention_entry<true>(q, k, k_scale, v, v_scale, bias,
                                           out, B, Q, S, E, H, splits, per,
                                           smem, stream);
}
