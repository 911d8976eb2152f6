// Flash attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_fwd
// (_fa_kernel): blockwise online-softmax attention over q (B,T,H,D) and
// k/v (B,Tk,G,D), causal, chunked-local (`chunk`) or full, GQA through the
// kv-head index (h / (H/G)), fp32 running (m, l, acc), rows with l == 0
// return 0.
//
// Bound on the H100: operations at prefill widths (T in the hundreds to
// thousands), where each K/V byte staged on chip is used by 64-128 query
// rows, far above the card's ~295 flop/B ridge; bytes where few query rows
// meet many keys (whisper-small's cross-attention at a short prompt: 64
// queries over 1500 frames).  The TPU kernel walked K/V tiles as the
// sequential innermost grid axis with (m, l, acc) in VMEM scratch; Hopper
// runs CTAs in parallel and in no order, so here one CTA owns a query tile
// and loops over K/V tiles itself -- or over a slice of them, when the
// query tiles are too few to fill the card and the D = 64 body cuts their
// key ranges (the slices' partials merged by the last CTA).  Tiles past the
// causal diagonal or outside the chunk band are never loaded; the ragged
// T / Tk edges are masked in the kernel, so the caller pads nothing.  Query
// tiles are issued longest-first so causal work balances across SMs.
//
// Head dims 32, 64, 112 (zamba2-7b's shared block: 3584 / 32 heads) and 128.
//
// Four bodies:
// * bf16 at D = 112 and 128 (granite-8b's prefill, zamba2-7b's shared
//   block) -- TMA ring, warp specialisation, wgmma (flash_attention_wgmma);
// * bf16 at D = 64 (whisper-small, internvl2-1b) -- TMA ring, wgmma with
//   m64n64 products, a CTA sized for the shape and a split key range
//   (flash_attention_d64);
// * bf16 at D = 32, which no model runs (the tests cover it): mma.sync
//   m16n8k16 in the FlashAttention-2 register layout -- each of 4 warps
//   owns 16 rows of a 64-row query tile, K is staged row-major and V
//   transposed in padded shared memory;
// * fp32: scalar FMA on fp32 tiles in shared memory (each thread a 4x8
//   block of the score tile and a 4 x D/8 block of the output), for the
//   fp32 parity runs.
#include "common.cuh"
#include "hopper.cuh"

constexpr int FA_THREADS = 128;
constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;

template <int D>
struct FaSmem {
  static constexpr int QS = D + 1;                 // padded row strides: no bank conflicts
  static constexpr int KS = D + 1;
  static constexpr int SS = FA_BK + 1;
  static constexpr size_t floats = FA_BQ * QS + FA_BK * KS + FA_BK * D + FA_BQ * SS + 3 * FA_BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int T_q, int T_k, int H,
                           int G, int causal, int chunk, float scale) {
  using L = FaSmem<D>;
  constexpr int DC = D / 8;                        // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + FA_BQ * L::QS;
  float* sV = sK + FA_BK * L::KS;
  float* sS = sV + FA_BK * D;
  float* sM = sS + FA_BQ * L::SS;
  float* sL = sM + FA_BQ;
  float* sC = sL + FA_BQ;

  const int iq = gridDim.x - 1 - blockIdx.x;       // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;
  const int q0 = iq * FA_BQ;
  const int q_last = min(q0 + FA_BQ, T_q) - 1;

  for (int idx = tid; idx < FA_BQ * D; idx += FA_THREADS) {
    const int r = idx / D, d = idx % D;
    sQ[r * L::QS + d] = q0 + r < T_q ? to_f32(q[(((size_t)b * T_q + q0 + r) * H + h) * D + d]) : 0.f;
  }
  if (tid < FA_BQ) {
    sM[tid] = -INFINITY;
    sL[tid] = 0.f;
  }
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  // K/V range that can be live for this query tile
  int k_lo = 0, k_hi = T_k;
  if (chunk > 0) {
    k_lo = (q0 / chunk) * chunk;
    k_hi = min(T_k, (q_last / chunk + 1) * chunk);
  }
  if (causal) k_hi = min(k_hi, q_last + 1);

  for (int k0 = (k_lo / FA_BK) * FA_BK; k0 < k_hi; k0 += FA_BK) {
    __syncthreads();                               // previous tile fully consumed
    for (int idx = tid; idx < FA_BK * D; idx += FA_THREADS) {
      const int r = idx / D, d = idx % D;
      const bool in = k0 + r < T_k;
      const size_t off = (((size_t)b * T_k + k0 + r) * G + g) * D + d;
      sK[r * L::KS + d] = in ? to_f32(k[off]) : 0.f;
      sV[r * D + d] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for this thread's rows ty*4+i and columns tx+8*j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * L::QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tx + 8 * j) * L::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + tx + 8 * j;
        bool live = qpos < T_q && kpos < T_k;
        if (causal) live = live && kpos <= qpos;
        if (chunk > 0) live = live && (qpos / chunk) == (kpos / chunk);
        sS[(ty * 4 + i) * L::SS + tx + 8 * j] = live ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one thread per row (guards as in the reference: a row
    // with nothing live yet keeps l = acc = 0)
    if (tid < FA_BQ) {
      float* row = sS + tid * L::SS;
      float mx = -INFINITY;
      for (int j = 0; j < FA_BK; ++j) mx = fmaxf(mx, row[j]);
      const float m_prev = sM[tid];
      const float m_new = fmaxf(m_prev, mx);
      const bool dead = m_new == -INFINITY;
      const float m_safe = dead ? 0.f : m_new;
      float sum = 0.f;
      for (int j = 0; j < FA_BK; ++j) {
        const float p = dead ? 0.f : expf(row[j] - m_safe);
        row[j] = p;
        sum += p;
      }
      const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
      sL[tid] = sL[tid] * corr + sum;
      sM[tid] = m_new;
      sC[tid] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = sC[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= c;
    }
    for (int kk = 0; kk < FA_BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(ty * 4 + i) * L::SS + kk];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = sV[kk * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= T_q) continue;
    float l = sL[r];
    l = l == 0.f ? 1.f : l;
    T* o = out + (((size_t)b * T_q + q0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j) o[tx + 8 * j] = from_f32<T>(acc[i][j] / l);
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core body on mma.sync, D = 32 only
// ---------------------------------------------------------------------------

using hopper::mma_bf16;
using hopper::pack_bf16;

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                              int T_q, int T_k, int H, int G, int causal, int chunk, float scale) {
  constexpr int KS = D + 8;                        // padded bf16 row of K (bank spread)
  constexpr int VS = FA_BK + 8;                    // padded bf16 row of V^T
  constexpr int NK = D / 16;                       // k-steps of Q.K^T
  constexpr int NO = D / 8;                        // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 sK[FA_BK * KS];
  __shared__ __align__(16) __nv_bfloat16 sVt[D * VS];

  const int iq = gridDim.x - 1 - blockIdx.x;       // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;         // fragment row group / quad index
  const int q0 = iq * FA_BQ;
  const int q_last = min(q0 + FA_BQ, T_q) - 1;
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8; // this thread's two query rows

  // Q fragments for all of D, straight from device memory into registers
  uint32_t qf[NK][4];
  const __nv_bfloat16* q_r0 = q + (((size_t)b * T_q + r0) * H + h) * D;
  const __nv_bfloat16* q_r1 = q + (((size_t)b * T_q + r1) * H + h) * D;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const int c = kk * 16 + tq * 2;
    qf[kk][0] = r0 < T_q ? *reinterpret_cast<const uint32_t*>(q_r0 + c) : 0u;
    qf[kk][1] = r1 < T_q ? *reinterpret_cast<const uint32_t*>(q_r1 + c) : 0u;
    qf[kk][2] = r0 < T_q ? *reinterpret_cast<const uint32_t*>(q_r0 + c + 8) : 0u;
    qf[kk][3] = r1 < T_q ? *reinterpret_cast<const uint32_t*>(q_r1 + c + 8) : 0u;
  }
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  int k_lo = 0, k_hi = T_k;
  if (chunk > 0) {
    k_lo = (q0 / chunk) * chunk;
    k_hi = min(T_k, (q_last / chunk + 1) * chunk);
  }
  if (causal) k_hi = min(k_hi, q_last + 1);

  for (int k0 = (k_lo / FA_BK) * FA_BK; k0 < k_hi; k0 += FA_BK) {
    __syncthreads();                               // previous tile fully consumed
    // stage K row-major and V transposed, 16 bytes (8 dims of one key) a
    // load; neighbouring threads take neighbouring keys, so the transposed
    // V stores of a warp fall in distinct banks
    for (int idx = tid; idx < FA_BK * D / 8; idx += FA_THREADS) {
      const int r = idx % FA_BK, c = (idx / FA_BK) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < T_k) {
        const size_t off = (((size_t)b * T_k + k0 + r) * G + g) * D + c;
        kv4 = *reinterpret_cast<const uint4*>(k + off);
        vv4 = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&sK[r * KS + c]) = kv4;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) sVt[(c + e) * VS + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys, accumulated over D in k-steps of 16
    float sc[FA_BK / 8][4];
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const __nv_bfloat16* krow = &sK[(j * 8 + gr) * KS + tq * 2];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_bf16(sc[j], qf[kk], b0, b1);
      }
    }
    // scale + mask; this thread holds rows r0 (elements 0,1) and r1 (2,3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = e < 2 ? r0 : r1;
        const int kpos = k0 + j * 8 + tq * 2 + (e & 1);
        bool live = qpos < T_q && kpos < T_k;
        if (causal) live = live && kpos <= qpos;
        if (chunk > 0) live = live && (qpos / chunk) == (kpos / chunk);
        sc[j][e] = live ? sc[j][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
    // a row lives in the 4 threads of a quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const bool dead0 = mn0 == -INFINITY, dead1 = mn1 == -INFINITY;
    const float ms0 = dead0 ? 0.f : mn0, ms1 = dead1 ? 0.f : mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < FA_BK / 8; ++j) {
      sc[j][0] = dead0 ? 0.f : expf(sc[j][0] - ms0);
      sc[j][1] = dead0 ? 0.f : expf(sc[j][1] - ms0);
      sc[j][2] = dead1 ? 0.f : expf(sc[j][2] - ms1);
      sc[j][3] = dead1 ? 0.f : expf(sc[j][3] - ms1);
      sum0 += sc[j][0] + sc[j][1];
      sum1 += sc[j][2] + sc[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float c0 = m0 == -INFINITY ? 0.f : expf(m0 - ms0);
    const float c1 = m1 == -INFINITY ? 0.f : expf(m1 - ms1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= c0;
      o[n][1] *= c0;
      o[n][2] *= c1;
      o[n][3] *= c1;
    }
    // O += P V: the score accumulator, rounded to bf16, is P's A fragment
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vrow = &sVt[(n * 8 + gr) * VS + kk * 16 + tq * 2];
        mma_bf16(o[n], a, *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
  }

  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* o_r0 = out + (((size_t)b * T_q + r0) * H + h) * D;
  __nv_bfloat16* o_r1 = out + (((size_t)b * T_q + r1) * H + h) * D;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + tq * 2;
    if (r0 < T_q) *reinterpret_cast<uint32_t*>(o_r0 + c) = pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    if (r1 < T_q) *reinterpret_cast<uint32_t*>(o_r1 + c) = pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// bf16 body at D = 112 and 128: TMA ring, warp specialisation, wgmma
// ---------------------------------------------------------------------------
//
// A CTA is 3 warpgroups.  Warpgroup 2 is the producer: it gives up its
// registers (setmaxnreg 40) and one elected thread issues every TMA load.
// Warpgroups 0 and 1 are consumers (setmaxnreg 232); each owns 64 query rows
// and runs both products on wgmma with fp32 accumulators in registers:
//   S (64 x 64) = Q (64 x D) . K^T, A and B from shared memory, K-major;
//   O (64 x 128) += P (64 x 64, bf16 in registers) . V, V read MN-major
//   through the descriptor's transpose bit, so no thread transposes V.
// The S accumulator's layout is the A-register layout of the next product,
// so P goes from softmax to the tensor cores without a shuffle.  A consumer
// pipelines its tiles: it issues S(i) and P(i-1).V(i-1) together and runs
// the softmax of tile i while the second product is on the tensor cores.
//
// Why 64-key tiles: ptxas fits the consumer path into the 168 registers a
// thread that __launch_bounds__(384, 1) gives it, whatever setmaxnreg asks
// at run time.  With 96- or 128-key tiles the pipeline's S, P and O (and
// its descriptors) outgrow that; ptxas then spills and serialises the
// wgmmas (C7512), and so it did with a lone producer warp (288 threads, 224
// registers) and with Q's fragments held in registers.  All measured slower
// (`chip_smoke.py --phases build,baseline`, PERF.md).
//
// Rows of a consumer: with GQA the nh = 4, 2 or 1 query heads of one KV
// head (the largest that divides H / G) share the CTA, so each staged K/V
// tile serves all of them: a consumer's 64 rows are 64 / nh positions x nh
// heads, loaded as one TMA box (64 cols, nh heads, 64 / nh positions), row
// m = position * nh + head.  granite-8b (32 / 8): 16 positions x 4 heads per
// consumer, a 32-position query tile per CTA, so a 16-token prefill bucket
// fills 64 rows; zamba2-7b (32 / 32): 64 positions of one head.
//
// Shared memory (1024-byte aligned tiles, each 128-byte row swizzled 128 B
// by TMA): Q 2 x 16 KB; a ring of FW_STAGES = 4 stages of K (64 keys x 128
// bf16, 16 KB) and V (16 KB): 32 + 4 x 32 = 160 KB, with 1 KB of alignment
// slack, inside the 227 KB a CTA may take (a stage is released only after
// the next tile's softmax, so the ring runs 2 tiles ahead of the loads).
// One CTA an SM.
//
// D = 112 (zamba2: 224 B a row, not a 128-byte swizzle span): every tile is
// 128 wide in shared memory and D wide in device memory.  TMA loads two
// 64-wide boxes and fills the columns past D with zeros, which add nothing
// to Q.K^T and give output columns that the TMA store clips; S takes D / 16
// k-steps.  Ragged T and Tk edges are zero-filled the same way and masked in
// the softmax; nothing is padded or copied by the caller.
//
// Barriers: q_full (the Q boxes), full[s] (K and V of stage s, counted in
// bytes), empty[s] (8 consumer warps release stage s once the product that
// read it has retired, wgmma.wait_group).  Tiles no row of the CTA can see
// are never loaded; a consumer skips the products of a tile none of its rows
// can see; the mask runs only on edge tiles (the causal diagonal, chunk
// edges, the ragged Tk), full tiles take no mask code.  Softmax on the
// accumulator: the row max over the 4 threads of a quad, 2^x on the SFU of
// s * scale * log2(e) - m * scale * log2(e) as one FMA, the row sums kept
// per thread and reduced once at the end; O is rescaled only when a row of
// the warp raised its max.  Epilogue: O / l in bf16 through the consumer's
// Q tile (swizzled as TMA expects) and one TMA store.

constexpr int FW_BK = 64;                         // keys per K/V tile: S is m64n64
constexpr int FW_STAGES = 4;
constexpr int FW_SN = FW_BK / 8;                  // 8-key column groups of S
constexpr int FW_PK = FW_BK / 16;                 // k-steps of P.V
constexpr int FW_THREADS = 384;                   // 2 consumer warpgroups + 1 producer
constexpr int FW_Q_BOX = 64 * 128;                // bytes of one 64-row x 64-col box
constexpr int FW_Q_BYTES = 4 * FW_Q_BOX;          // 2 consumers x 2 column boxes
constexpr int FW_KV_BOX = FW_BK * 128;            // one 64-col box of a K or V tile
constexpr int FW_STAGE_BYTES = 4 * FW_KV_BOX;     // K and V, 2 column boxes each
constexpr size_t FW_SMEM = 1024 + FW_Q_BYTES + (size_t)FW_STAGES * FW_STAGE_BYTES;

// a position in a K/V ring of STAGES stages: the stage, and the parity of
// its barriers' phase
template <int STAGES>
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};
using Ring = RingPos<FW_STAGES>;

using hopper::ex2;

// live keys of a query at position tq: [lo, hi)
__device__ __forceinline__ void key_range(int tq, int T_k, int causal, int chunk, int& lo,
                                          int& hi) {
  lo = chunk > 0 ? (tq / chunk) * chunk : 0;
  hi = T_k;
  if (causal) hi = min(hi, tq + 1);
  if (chunk > 0) hi = min(hi, lo + chunk);
}

template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
    flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap omap, int T_q, int T_k, int H, int G,
                    int causal, int chunk, float scale_log2, int nh_log2) {
  using namespace hopper;
  constexpr int NK = D / 16;                      // k-steps of Q.K^T
  extern __shared__ uint8_t fw_smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[FW_STAGES], empty[FW_STAGES];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(fw_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                             // consumer w: sQ + w * 2 * FW_Q_BOX
  uint8_t* sKV = smem + FW_Q_BYTES;               // stage s: K boxes, then V boxes

  const int rows_w = 64 >> nh_log2;               // query positions per consumer
  const int iq = gridDim.x - 1 - blockIdx.x;      // longest causal rows first
  const int hb = blockIdx.y << nh_log2, b = blockIdx.z;
  const int g = hb / (H / G);
  const int q0 = iq * 2 * rows_w;
  const int q_last = min(q0 + 2 * rows_w, T_q) - 1;
  int k_lo, k_hi, unused;
  key_range(q0, T_k, causal, chunk, k_lo, unused);
  key_range(q_last, T_k, causal, chunk, unused, k_hi);
  const int kt0 = (k_lo / FW_BK) * FW_BK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + FW_BK - 1) / FW_BK : 0;

  // warpgroup index, warp-uniform as the compiler sees it (a broadcast)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                    // the 8 consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ---------------------------------------------------------
    regs_dealloc<40>();
    if (threadIdx.x == 256) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(&q_full, FW_Q_BYTES);
      for (int w = 0; w < 2; ++w)
        for (int c = 0; c < 2; ++c)
          tma_load_4d(sQ + (2 * w + c) * FW_Q_BOX, &qmap, &q_full, 64 * c, hb, q0 + w * rows_w, b);
      Ring ring;
      for (int i = 0; i < n_tiles; ++i, ring.advance()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);  // the first round passes at once
        uint8_t* st = sKV + ring.stage * FW_STAGE_BYTES;
        const int k0 = kt0 + i * FW_BK;
        mbar_expect_tx(&full[ring.stage], FW_STAGE_BYTES);
        for (int c = 0; c < 2; ++c) {
          tma_load_4d(st + c * FW_KV_BOX, &kmap, &full[ring.stage], 64 * c, g, k0, b);
          tma_load_4d(st + (2 + c) * FW_KV_BOX, &vmap, &full[ring.stage], 64 * c, g, k0, b);
        }
      }
    }
  } else {
    // ---- consumers --------------------------------------------------------
    regs_alloc<232>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int t4 = lane % 4;
    const int m0 = warp * 16 + lane / 4, m1 = m0 + 8;  // this thread's two rows
    const int q0w = q0 + wg * rows_w;
    const int last_w = min(q0w + rows_w, T_q) - 1;    // last valid position (< q0w: none)
    const bool live_w = q0w < T_q;
    // per-row live key ranges, and the tiles that need no mask for any row
    int lo0, hi0, lo1, hi1, wk_lo, wk_hi, full_lo, full_hi;
    key_range(q0w + (m0 >> nh_log2), T_k, causal, chunk, lo0, hi0);
    key_range(q0w + (m1 >> nh_log2), T_k, causal, chunk, lo1, hi1);
    key_range(q0w, T_k, causal, chunk, wk_lo, full_hi);
    key_range(max(last_w, q0w), T_k, causal, chunk, full_lo, wk_hi);
    // a positive factor leaves the running max in raw units; otherwise the
    // scores are scaled first
    const bool prescale = !(scale_log2 > 0.f);
    const float f = prescale ? 1.f : scale_log2;

    const uint32_t aQ = smem_u32(sQ + wg * 2 * FW_Q_BOX);
    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float mr0 = -INFINITY, mr1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    // the tiles this consumer computes, [i_lo, i_hi) of the CTA's n_tiles;
    // the others it only waits for and releases
    int i_lo = 0, i_hi = 0;
    if (live_w && wk_hi > wk_lo) {
      i_lo = (wk_lo - kt0) / FW_BK;
      i_hi = min(n_tiles, (wk_hi - kt0 + FW_BK - 1) / FW_BK);
    }
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    // S = Q.K^T of the tile in `stage`
    auto issue_s = [&](float (&sc)[4 * FW_SN], int stage) {
      const uint32_t aK = smem_u32(sKV + stage * FW_STAGE_BYTES);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        const uint32_t off = (kk & 3) * 32;           // 16 columns of a 128-byte row
        wgmma_m64n64k16_ss(sc, desc_sw128(aQ + (kk >> 2) * FW_Q_BOX + off, 16, 1024),
                           desc_sw128(aK + (kk >> 2) * FW_KV_BOX + off, 16, 1024), kk > 0);
      }
    };
    // O += P.V of the tile in `stage`, 16 keys (2048 bytes of V) a k-step
    auto issue_pv = [&](const uint32_t (&pa)[FW_PK][4], int stage) {
      const uint32_t aV = smem_u32(sKV + stage * FW_STAGE_BYTES) + 2 * FW_KV_BOX;
#pragma unroll
      for (int kk = 0; kk < FW_PK; ++kk)
        wgmma_m64n128k16_rs_tb(o, pa[kk], desc_sw128(aV + kk * 2048, FW_KV_BOX, 1024));
    };
    // scores of the tile at key k0 -> probabilities in place, (m, l) updated;
    // c0, c1 rescale the rows' O
    auto softmax = [&](float (&sc)[4 * FW_SN], int k0, float& c0, float& c1) {
      if (prescale) {
#pragma unroll
        for (int j = 0; j < 4 * FW_SN; ++j) sc[j] *= scale_log2;
      }
      if (!(k0 >= full_lo && k0 + FW_BK <= full_hi)) {  // an edge tile
#pragma unroll
        for (int n = 0; n < FW_SN; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + n * 8 + t4 * 2 + e;
            if (!(kp >= lo0 && kp < hi0)) sc[4 * n + e] = -INFINITY;
            if (!(kp >= lo1 && kp < hi1)) sc[4 * n + 2 + e] = -INFINITY;
          }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < FW_SN; ++n) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(mr0, mx0), mn1 = fmaxf(mr1, mx1);
      // a row with nothing live yet keeps l = O = 0 (exp2(-inf) = 0)
      const float b0 = mn0 == -INFINITY ? 0.f : mn0 * f;
      const float b1 = mn1 == -INFINITY ? 0.f : mn1 * f;
      c0 = mr0 == -INFINITY ? 0.f : ex2(fmaf(mr0, f, -b0));
      c1 = mr1 == -INFINITY ? 0.f : ex2(fmaf(mr1, f, -b1));
      mr0 = mn0;
      mr1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < FW_SN; ++n) {
        sc[4 * n] = ex2(fmaf(sc[4 * n], f, -b0));
        sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], f, -b0));
        sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], f, -b1));
        sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], f, -b1));
        sum0 += sc[4 * n] + sc[4 * n + 1];
        sum1 += sc[4 * n + 2] + sc[4 * n + 3];
      }
      l0 = l0 * c0 + sum0;                            // per-thread partial row sums
      l1 = l1 * c1 + sum1;
    };
    auto to_bf16 = [&](const float (&sc)[4 * FW_SN], uint32_t (&pa)[FW_PK][4]) {
#pragma unroll
      for (int kk = 0; kk < FW_PK; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };

    Ring ring;
    mbar_wait(&q_full, 0);
    for (int i = 0; i < i_lo; ++i, ring.advance()) {
      mbar_wait(&full[ring.stage], ring.phase);
      release(ring.stage);
    }
    if (i_hi > i_lo) {
      // Software pipeline: P(i-1).V(i-1) runs on the tensor cores while this
      // warpgroup computes the softmax of tile i; no wgmma is issued on a
      // branch inside the loop.
      uint32_t pa[FW_PK][4];                          // P of the previous tile, bf16
      float sc[4 * FW_SN], c0, c1;
      mbar_wait(&full[ring.stage], ring.phase);
      wg_fence();
      issue_s(sc, ring.stage);
      wg_commit();
      wg_wait<0>();
      fence_regs(sc);
      softmax(sc, kt0 + i_lo * FW_BK, c0, c1);        // O is 0: nothing to rescale
      to_bf16(sc, pa);
      int prev = ring.stage;
      ring.advance();
      for (int i = i_lo + 1; i < i_hi; ++i, ring.advance()) {
        mbar_wait(&full[ring.stage], ring.phase);
        wg_fence();
        issue_s(sc, ring.stage);
        wg_commit();
        issue_pv(pa, prev);
        wg_commit();
        wg_wait<1>();                                 // S done; P.V may still run
        fence_regs(sc);
        softmax(sc, kt0 + i * FW_BK, c0, c1);
        wg_wait<0>();                                 // P(i-1).V(i-1) done: O is ours
        fence_regs(o);
        release(prev);
        if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
          for (int n = 0; n < 16; ++n) {
            o[4 * n] *= c0;
            o[4 * n + 1] *= c0;
            o[4 * n + 2] *= c1;
            o[4 * n + 3] *= c1;
          }
        }
        to_bf16(sc, pa);
        prev = ring.stage;
      }
      wg_fence();                                     // the last tile's P.V
      issue_pv(pa, prev);
      wg_commit();
      wg_wait<0>();
      fence_regs(o);
      release(prev);
    }
    for (int i = max(i_hi, i_lo); i < n_tiles; ++i, ring.advance()) {
      mbar_wait(&full[ring.stage], ring.phase);
      release(ring.stage);
    }

    // ---- epilogue: O / l in bf16 into this consumer's Q tile, TMA store ----
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
    uint8_t* sO = sQ + wg * 2 * FW_Q_BOX;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      uint8_t* box = sO + (n >> 3) * FW_Q_BOX + t4 * 4;
      const int j = n & 7;
      *reinterpret_cast<uint32_t*>(box + m0 * 128 + ((j ^ (m0 & 7)) << 4)) =
          pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
      *reinterpret_cast<uint32_t*>(box + m1 * 128 + ((j ^ (m1 & 7)) << 4)) =
          pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tid == 0 && live_w) {
      tma_store_4d(&omap, sO, 0, hb, q0w, b);
      tma_store_4d(&omap, sO + FW_Q_BOX, 64, hb, q0w, b);
      tma_store_commit_and_wait();
    }
  }
}

template <int D>
static cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                                int T_q, int T_k, int H, int G, int causal, int chunk,
                                float scale, cudaStream_t st) {
  const int rep = H / G;
  const int nh_log2 = rep % 4 == 0 ? 2 : rep % 2 == 0 ? 1 : 0;
  const uint32_t nh = 1u << nh_log2, rows_w = 64u >> nh_log2;
  CUtensorMap qm, km, vm, om;
  if (!hopper::encode_bf16_4d(&qm, q, D, H, T_q, B, nh, rows_w) ||
      !hopper::encode_bf16_4d(&om, out, D, H, T_q, B, nh, rows_w) ||
      !hopper::encode_bf16_4d(&km, k, D, G, T_k, B, 1, FW_BK) ||
      !hopper::encode_bf16_4d(&vm, v, D, G, T_k, B, 1, FW_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FW_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((T_q + 2 * rows_w - 1) / (2 * rows_w), H >> nh_log2, B);
  flash_attention_wgmma<D><<<grid, FW_THREADS, FW_SMEM, st>>>(
      qm, km, vm, om, T_q, T_k, H, G, causal, chunk, scale * 1.4426950408889634f, nh_log2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 body at D = 64: TMA ring, wgmma, a split key range
// ---------------------------------------------------------------------------
//
// What bounds it: at whisper-small's encoder (T = Tk = 1500, 12 heads) and
// internvl2-1b's prefill (1088 rows, causal) the work is operations, and at
// D = 64 the softmax's exponentials (one MUFU.EX2 a score, 16 a clock an SM)
// cost about as much as the two products on the tensor cores; at whisper's
// cross-attention with a short prompt (T = 64 queries over Tk = 1500 frames)
// it is bytes, a stream over K and V with 12 query tiles to read it.
//
// A CTA is one consumer warpgroup and one producer warp (160 threads), and
// three CTAs share an SM, so one CTA's softmax overlaps another's products
// and the query tiles are small enough to balance.  (Two and three consumer
// warpgroups a CTA over one ring, 128-key tiles, and two CTAs an SM with a
// 3-stage ring all measured slower at every path's shape on the H100:
// `chip_smoke.py --phases build,baseline`, PERF.md.)
// One elected producer thread issues every TMA load: the Q tile, then a ring
// of D64_STAGES stages of 64-key K and V tiles, 128-byte swizzled and guarded
// by mbarriers.  At D = 64 a row is one 128-byte swizzle span, so Q, K and V
// are one box each.  The consumer owns 64 query rows and runs, per tile,
//   S (64 x 64) = Q (64 x 64) . K^T, SS wgmma over 4 k-steps, both K-major;
//   O (64 x 64) += P (64 x 64, bf16 in registers) . V, RS wgmma m64n64k16,
//   V read MN-major through the transpose bit, so no thread transposes V.
// O is 32 fp32 registers a thread, so nothing asks for setmaxnreg: the whole
// CTA fits in the 136 registers a thread that three CTAs an SM leave.  The
// consumer pipelines its tiles as the D = 112/128 body does (S(i) and
// P(i-1).V(i-1) issued together, the softmax of tile i while the second
// product runs).  Softmax as there: masks on edge tiles only (the causal
// diagonal, chunk edges, the ragged Tk), 2^x of s * scale * log2(e) -
// m * scale * log2(e) as one FMA, O rescaled only when a row of the warp
// raised its max; a row with nothing live keeps l = O = 0 and returns 0.
//
// Query heads: the nh = 4, 2 or 1 query heads of one KV head (the largest
// that divides H / G) share the consumer's 64 rows (64 / nh positions x nh
// heads, row m = position * nh + head), so one staged K/V tile serves them
// all.  whisper-small (H / G = 1) and internvl2-1b (H / G = 7) take nh = 1.
//
// Order: the (query tile, head group, batch) units are ranked longest
// first (the last query tiles of a causal call see the most keys).  Where
// the mask makes them differ, the grid hands them out in rounds of `wave`
// CTAs (the SM count), every other round reversed, so the CTAs that share
// an SM pair long units with short ones (internvl2-1b's prefill on the
// H100: 0.0137 -> 0.0129 ms of device time); an unmasked call's units are
// equal and go in order (wave = all of them).
//
// The split (kernels/flash_attention.py: split_plan): where the units are
// fewer than the SMs, each one's live key tiles [t_lo, t_lo + n_tiles) are
// cut into n_split slices of `per` tiles (split_slices there mirrors this
// arithmetic), the slice index the grid's y; a CTA whose slice would be
// empty exits at once.  With more than one slice, each CTA leaves its fp32
// partial (per thread: its 32 O accumulators and the (m, l) of its two rows,
// in thread order so the writes and reads are whole float4s of neighbouring
// threads) in the wrapper's scratch and counts itself on its unit's counter
// (acquire-release, at gpu scope); the last CTA to count merges every slice
// in slice order, so the result is the same whichever CTA merges, writes the
// output and returns the counter to 0.  The wrapper therefore never clears
// the counters; the kernel allocates nothing.

constexpr int D64_BK = 64;                                // keys a K/V tile
constexpr int D64_STAGES = 4;
constexpr int D64_THREADS = 160;                          // a consumer warpgroup + a producer warp
constexpr int D64_CTAS_PER_SM = 3;
constexpr int D64_BOX = 64 * 128;                         // 64 rows x 64 bf16: Q, K or V
constexpr int D64_STAGE_BYTES = 2 * D64_BOX;              // K, then V
constexpr int D64_SN = D64_BK / 8;                        // 8-key column groups of S
constexpr int D64_PK = D64_BK / 16;                       // k-steps of P.V
constexpr int D64_PART_F4 = 9;                            // float4s a thread leaves in a slot
constexpr size_t D64_SMEM = 1024 + D64_BOX + (size_t)D64_STAGES * D64_STAGE_BYTES;

__global__ void __launch_bounds__(D64_THREADS, D64_CTAS_PER_SM)
    flash_attention_d64(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap, int T_q, int T_k, int rep,
                        int n_hg, int n_b, int causal, int chunk, float scale_log2, int nh_log2,
                        int wave, float4* __restrict__ part, int* __restrict__ counters) {
  using namespace hopper;
  using RingD64 = RingPos<D64_STAGES>;
  extern __shared__ uint8_t d64_smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[D64_STAGES], empty[D64_STAGES];
  __shared__ int s_last;
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(d64_smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sQ = smem;                                     // Q, then O on its way out
  uint8_t* sKV = smem + D64_BOX;                          // stage s: K box, then V box

  // this CTA's unit: rounds of `wave`, every other one reversed
  const int n_units = gridDim.x, r = blockIdx.x;
  const int rnd = r / wave, rnd_len = min(wave, n_units - rnd * wave);
  const int unit = rnd & 1 ? rnd * wave + rnd_len - 1 - r % wave : r;
  const int rows_w = 64 >> nh_log2;                       // query positions a CTA
  const int iq = (T_q + rows_w - 1) / rows_w - 1 - unit / (n_hg * n_b);   // longest first
  const int hb = (unit % n_hg) << nh_log2, b = unit / n_hg % n_b;
  const int g = hb / rep;
  const int n_split = gridDim.y, split = blockIdx.y;
  const int q0 = iq * rows_w;
  const int q_last = min(q0 + rows_w, T_q) - 1;
  int k_lo, k_hi, full_lo, full_hi;
  key_range(q0, T_k, causal, chunk, k_lo, full_hi);
  key_range(q_last, T_k, causal, chunk, full_lo, k_hi);
  const int kt0 = (k_lo / D64_BK) * D64_BK;
  const int n_tiles = k_hi > kt0 ? (k_hi - kt0 + D64_BK - 1) / D64_BK : 0;
  // this CTA's slice [s_lo, s_hi) of the n_tiles (flash_attention.py: split_slices)
  const int per = n_tiles > 0 ? (n_tiles + n_split - 1) / n_split : 0;
  const int n_items = n_tiles > 0 ? (n_tiles + per - 1) / per : 1;
  if (split >= n_items) return;                           // the whole CTA, before any barrier
  const int s_lo = split * per, s_hi = min(n_tiles, s_lo + per);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < D64_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                            // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer ---------------------------------------------------------
    if (threadIdx.x == 128) {
      tma_prefetch_map(&kmap);
      tma_prefetch_map(&vmap);
      mbar_expect_tx(&q_full, D64_BOX);
      tma_load_4d(sQ, &qmap, &q_full, 0, hb, q0, b);
      RingD64 ring;
      for (int i = s_lo; i < s_hi; ++i, ring.advance()) {
        mbar_wait(&empty[ring.stage], ring.phase ^ 1);    // the first round passes at once
        uint8_t* st = sKV + ring.stage * D64_STAGE_BYTES;
        const int k0 = kt0 + i * D64_BK;
        mbar_expect_tx(&full[ring.stage], D64_STAGE_BYTES);
        tma_load_4d(st, &kmap, &full[ring.stage], 0, g, k0, b);
        tma_load_4d(st + D64_BOX, &vmap, &full[ring.stage], 0, g, k0, b);
      }
    }
    return;
  }

  // ---- consumer -----------------------------------------------------------
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int m0 = warp * 16 + lane / 4, m1 = m0 + 8;       // this thread's two rows
  // per-row live key ranges; [full_lo, full_hi) above: the keys no row masks
  int lo0, hi0, lo1, hi1;
  key_range(q0 + (m0 >> nh_log2), T_k, causal, chunk, lo0, hi0);
  key_range(q0 + (m1 >> nh_log2), T_k, causal, chunk, lo1, hi1);
  // a positive factor leaves the running max in raw units; otherwise the
  // scores are scaled first
  const bool prescale = !(scale_log2 > 0.f);
  const float f = prescale ? 1.f : scale_log2;

  const uint32_t aQ = smem_u32(sQ);
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float mr0 = -INFINITY, mr1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };
  // S = Q.K^T of the tile in `stage`: 16 columns (32 bytes of a row) a k-step
  auto issue_s = [&](float (&sc)[4 * D64_SN], int stage) {
    const uint32_t aK = smem_u32(sKV + stage * D64_STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(sc, desc_sw128(aQ + kk * 32, 16, 1024),
                         desc_sw128(aK + kk * 32, 16, 1024), kk > 0);
  };
  // O += P.V of the tile in `stage`, 16 keys (2048 bytes of V) a k-step
  auto issue_pv = [&](const uint32_t (&pa)[D64_PK][4], int stage) {
    const uint32_t aV = smem_u32(sKV + stage * D64_STAGE_BYTES) + D64_BOX;
#pragma unroll
    for (int kk = 0; kk < D64_PK; ++kk)
      wgmma_m64n64k16_rs_tb(o, pa[kk], desc_sw128(aV + kk * 2048, D64_BOX, 1024));
  };
  // scores of the tile at key k0 -> probabilities in place, (m, l) updated;
  // c0, c1 rescale the rows' O
  auto softmax = [&](float (&sc)[4 * D64_SN], int k0, float& c0, float& c1) {
    if (prescale) {
#pragma unroll
      for (int j = 0; j < 4 * D64_SN; ++j) sc[j] *= scale_log2;
    }
    if (!(k0 >= full_lo && k0 + D64_BK <= full_hi)) {    // an edge tile
#pragma unroll
      for (int n = 0; n < D64_SN; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + n * 8 + t4 * 2 + e;
          if (!(kp >= lo0 && kp < hi0)) sc[4 * n + e] = -INFINITY;
          if (!(kp >= lo1 && kp < hi1)) sc[4 * n + 2 + e] = -INFINITY;
        }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < D64_SN; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(mr0, mx0), mn1 = fmaxf(mr1, mx1);
    // a row with nothing live yet keeps l = O = 0 (exp2(-inf) = 0)
    const float b0 = mn0 == -INFINITY ? 0.f : mn0 * f;
    const float b1 = mn1 == -INFINITY ? 0.f : mn1 * f;
    c0 = mr0 == -INFINITY ? 0.f : ex2(fmaf(mr0, f, -b0));
    c1 = mr1 == -INFINITY ? 0.f : ex2(fmaf(mr1, f, -b1));
    mr0 = mn0;
    mr1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < D64_SN; ++n) {
      sc[4 * n] = ex2(fmaf(sc[4 * n], f, -b0));
      sc[4 * n + 1] = ex2(fmaf(sc[4 * n + 1], f, -b0));
      sc[4 * n + 2] = ex2(fmaf(sc[4 * n + 2], f, -b1));
      sc[4 * n + 3] = ex2(fmaf(sc[4 * n + 3], f, -b1));
      sum0 += sc[4 * n] + sc[4 * n + 1];
      sum1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
    l0 = l0 * c0 + sum0;                                  // per-thread partial row sums
    l1 = l1 * c1 + sum1;
  };
  auto to_bf16 = [&](const float (&sc)[4 * D64_SN], uint32_t (&pa)[D64_PK][4]) {
#pragma unroll
    for (int kk = 0; kk < D64_PK; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  };

  RingD64 ring;
  mbar_wait(&q_full, 0);
  if (s_hi > s_lo) {
    // Software pipeline: P(i-1).V(i-1) runs on the tensor cores while this
    // warpgroup computes the softmax of tile i; no wgmma is issued on a
    // branch inside the loop.
    uint32_t pa[D64_PK][4];                               // P of the previous tile, bf16
    float sc[4 * D64_SN], c0, c1;
    mbar_wait(&full[ring.stage], ring.phase);
    wg_fence();
    issue_s(sc, ring.stage);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    softmax(sc, kt0 + s_lo * D64_BK, c0, c1);             // O is 0: nothing to rescale
    to_bf16(sc, pa);
    int prev = ring.stage;
    ring.advance();
    for (int i = s_lo + 1; i < s_hi; ++i, ring.advance()) {
      mbar_wait(&full[ring.stage], ring.phase);
      wg_fence();
      issue_s(sc, ring.stage);
      wg_commit();
      issue_pv(pa, prev);
      wg_commit();
      wg_wait<1>();                                       // S done; P.V may still run
      fence_regs(sc);
      softmax(sc, kt0 + i * D64_BK, c0, c1);
      wg_wait<0>();                                       // P(i-1).V(i-1) done: O is ours
      fence_regs(o);
      release(prev);
      if (__any_sync(0xffffffffu, c0 != 1.f || c1 != 1.f)) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[4 * n] *= c0;
          o[4 * n + 1] *= c0;
          o[4 * n + 2] *= c1;
          o[4 * n + 3] *= c1;
        }
      }
      to_bf16(sc, pa);
      prev = ring.stage;
    }
    wg_fence();                                           // the last tile's P.V
    issue_pv(pa, prev);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    release(prev);
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  if (n_items > 1) {
    // ---- split: leave this slice's partial; the last CTA merges them all ----
    const size_t stride = (size_t)D64_PART_F4 * 128;      // float4s of a slot
    const float4* slots = part + (size_t)r * n_split * stride + tid;
    float4* mine = part + ((size_t)r * n_split + split) * stride + tid;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      mine[j * 128] = make_float4(o[4 * j], o[4 * j + 1], o[4 * j + 2], o[4 * j + 3]);
    mine[8 * 128] = make_float4(mr0, l0, mr1, l1);
    __threadfence();
    named_barrier(1, 128);
    if (tid == 0) {
      // release this CTA's partial (ordered by the fences and the barrier),
      // acquire the others' if this is the last CTA of the unit
      int prev;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(&counters[r])
                   : "memory");
      const int last = prev == n_items - 1;
      if (last) counters[r] = 0;                          // every slice has counted
      s_last = last;
    }
    named_barrier(1, 128);
    if (!s_last) return;
    __threadfence();
    // every slice in slice order, this CTA's own from its registers (the
    // same values it wrote): the sums do not depend on which CTA merges
    float acc[32], ma0 = -INFINITY, ma1 = -INFINITY, la0 = 0.f, la1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int sp = 0; sp < n_items; ++sp) {
      float os[32], ms0, ls0, ms1, ls1;
      if (sp == split) {
#pragma unroll
        for (int i = 0; i < 32; ++i) os[i] = o[i];
        ms0 = mr0, ls0 = l0, ms1 = mr1, ls1 = l1;
      } else {
        const float4* src = slots + sp * stride;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 x = __ldcg(src + j * 128);
          os[4 * j] = x.x, os[4 * j + 1] = x.y, os[4 * j + 2] = x.z, os[4 * j + 3] = x.w;
        }
        const float4 x = __ldcg(src + 8 * 128);
        ms0 = x.x, ls0 = x.y, ms1 = x.z, ls1 = x.w;
      }
      // a slice with no live key for a row adds nothing to it
      if (ms0 != -INFINITY) {
        const float mn = fmaxf(ma0, ms0);
        const float c = ex2((ma0 - mn) * f), w = ex2((ms0 - mn) * f);   // ex2(-inf) = 0
        la0 = la0 * c + ls0 * w;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[4 * n] = acc[4 * n] * c + os[4 * n] * w;
          acc[4 * n + 1] = acc[4 * n + 1] * c + os[4 * n + 1] * w;
        }
        ma0 = mn;
      }
      if (ms1 != -INFINITY) {
        const float mn = fmaxf(ma1, ms1);
        const float c = ex2((ma1 - mn) * f), w = ex2((ms1 - mn) * f);
        la1 = la1 * c + ls1 * w;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          acc[4 * n + 2] = acc[4 * n + 2] * c + os[4 * n + 2] * w;
          acc[4 * n + 3] = acc[4 * n + 3] * c + os[4 * n + 3] * w;
        }
        ma1 = mn;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = acc[i];
    l0 = la0;
    l1 = la1;
  }

  // ---- epilogue: O / l in bf16 into the Q tile, TMA store ------------------
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0), inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    uint8_t* box = sQ + t4 * 4;
    *reinterpret_cast<uint32_t*>(box + m0 * 128 + ((n ^ (m0 & 7)) << 4)) =
        pack_bf16(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    *reinterpret_cast<uint32_t*>(box + m1 * 128 + ((n ^ (m1 & 7)) << 4)) =
        pack_bf16(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
  fence_proxy_async();
  named_barrier(2, 128);
  if (tid == 0) {
    tma_store_4d(&omap, sQ, 0, hb, q0, b);
    tma_store_commit_and_wait();
  }
}

static cudaError_t launch_d64(const void* q, const void* k, const void* v, void* out, int B,
                              int T_q, int T_k, int H, int G, int causal, int chunk, float scale,
                              int n_split, int n_sms, void* part, void* counters,
                              cudaStream_t st) {
  const int rep = H / G;
  const int nh_log2 = rep % 4 == 0 ? 2 : rep % 2 == 0 ? 1 : 0;
  const uint32_t nh = 1u << nh_log2, rows_w = 64u >> nh_log2;
  const long long units = (long long)((T_q + rows_w - 1) / rows_w) * (H >> nh_log2) * B;
  if (units > 0x7fffffff || n_split < 1 || n_split > 65535 || n_sms < 1 ||
      (n_split > 1 && (part == nullptr || counters == nullptr)))
    return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm, om;
  if (!hopper::encode_bf16_4d(&qm, q, 64, H, T_q, B, nh, rows_w) ||
      !hopper::encode_bf16_4d(&om, out, 64, H, T_q, B, nh, rows_w) ||
      !hopper::encode_bf16_4d(&km, k, 64, G, T_k, B, 1, D64_BK) ||
      !hopper::encode_bf16_4d(&vm, v, 64, G, T_k, B, 1, D64_BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_d64,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)D64_SMEM);
  if (err == cudaSuccess)     // three CTAs an SM take 3 x 74 KB of shared memory
    err = cudaFuncSetAttribute(flash_attention_d64,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)units, n_split);
  flash_attention_d64<<<grid, D64_THREADS, D64_SMEM, st>>>(
      qm, km, vm, om, T_q, T_k, rep, H >> nh_log2, B, causal, chunk, scale * hopper::LOG2E,
      nh_log2, causal || chunk > 0 ? n_sms : (int)units, static_cast<float4*>(part),
      static_cast<int*>(counters));
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int T_q,
                          int T_k, int H, int G, int causal, int chunk, float scale,
                          cudaStream_t st) {
  using L = FaSmem<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((T_q + FA_BQ - 1) / FA_BQ, H, B);
  flash_attention_kernel<T, D><<<grid, FA_THREADS, L::bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), T_q, T_k, H, G, causal, chunk, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
                              int B, int T_q, int T_k, int H, int G, int causal, int chunk,
                              float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
    case 64: return launch<T, 64>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
    case 112: return launch<T, 112>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
    case 128: return launch<T, 128>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// n_split (split_plan) and n_sms are for the bf16 D = 64 body; with
// n_split > 1, `part` holds n_split fp32 partials of 9 x 128 float4s for
// every (query tile, head group, batch) unit and `counters` one int a unit,
// all 0 (the kernel leaves them so).  Other bodies ignore the four.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                   int T_q, int T_k, int H, int G, int D, int causal, int chunk,
                                   float scale, int dtype, int n_split, int n_sms, void* part,
                                   void* counters, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_q <= 0 || T_k <= 0 || G <= 0 || H % G != 0 || H > 65535 || B > 65535 ||
      chunk < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    switch (D) {
      case 32: {
        dim3 grid((T_q + FA_BQ - 1) / FA_BQ, H, B);
        flash_attention_tc_kernel<32><<<grid, FA_THREADS, 0, st>>>(
            static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), T_q, T_k, H,
            G, causal, chunk, scale);
        return (int)cudaGetLastError();
      }
      case 64:
        return (int)launch_d64(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, n_split,
                               n_sms, part, counters, st);
      case 112: return (int)launch_wgmma<112>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
      case 128: return (int)launch_wgmma<128>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == DT_F32)
    return (int)dispatch_d<float>(D, q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}
