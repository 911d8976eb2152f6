// Flash attention forward (prefill) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_fwd
// (_fa_kernel): blockwise online-softmax attention over q (B,T,H,D) and
// k/v (B,Tk,G,D), causal, chunked-local (`chunk`) or full, GQA through the
// kv-head index (h / (H/G)), fp32 running (m, l, acc), rows with l == 0
// return 0.
//
// Bound on the H100: operations.  At prefill widths (T in the hundreds to
// thousands, D = 128) each K/V byte staged on chip is used by a whole
// 64-row query tile, so the work is far above the card's ~295 flop/B ridge.
// The TPU kernel walked K/V tiles as the sequential innermost grid axis with
// (m, l, acc) in VMEM scratch; Hopper runs CTAs in parallel and in no order,
// so here one CTA owns one (batch, head, 64-row query tile) and loops over
// K/V tiles itself.  Tiles past the causal diagonal or outside the chunk
// band are never loaded; the ragged T / Tk edges are masked in the kernel,
// so the caller pads nothing.  Query tiles are issued longest-first so
// causal work balances across SMs.
//
// Two bodies, chosen by the input dtype:
// * bf16 (the serving path): tensor cores through mma.sync m16n8k16 with
//   fp32 accumulate, the FlashAttention-2 register layout -- each of the 4
//   warps owns 16 query rows, keeps its Q fragments, the 16x64 score tile
//   and the 16xD output accumulator in registers, and feeds the score
//   accumulator back as the A operand of P.V without a trip through shared
//   memory.  K is staged row-major and V transposed in shared memory, with
//   padded rows so fragment loads hit distinct banks.  (wgmma/TMA and a
//   pipelined K/V ring are later work.)
// * fp32: scalar FMA on fp32 tiles in shared memory (each thread a 4x8
//   block of the score tile and a 4 x D/8 block of the output), for the
//   fp32 parity runs.
#include "common.cuh"

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
// bf16 tensor-core body
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);            // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

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
    case 128: return launch<T, 128>(q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out, int B,
                                   int T_q, int T_k, int H, int G, int D, int causal, int chunk,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_q <= 0 || T_k <= 0 || G <= 0 || H % G != 0 || H > 65535 || B > 65535 ||
      chunk < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16) {
    dim3 grid((T_q + FA_BQ - 1) / FA_BQ, H, B);
    const __nv_bfloat16 *qb = static_cast<const __nv_bfloat16*>(q),
                        *kb = static_cast<const __nv_bfloat16*>(k),
                        *vb = static_cast<const __nv_bfloat16*>(v);
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
    switch (D) {
      case 32: flash_attention_tc_kernel<32><<<grid, FA_THREADS, 0, st>>>(qb, kb, vb, ob, T_q, T_k, H, G, causal, chunk, scale); break;
      case 64: flash_attention_tc_kernel<64><<<grid, FA_THREADS, 0, st>>>(qb, kb, vb, ob, T_q, T_k, H, G, causal, chunk, scale); break;
      case 128: flash_attention_tc_kernel<128><<<grid, FA_THREADS, 0, st>>>(qb, kb, vb, ob, T_q, T_k, H, G, causal, chunk, scale); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  if (dtype == DT_F32)
    return (int)dispatch_d<float>(D, q, k, v, out, B, T_q, T_k, H, G, causal, chunk, scale, st);
  return (int)cudaErrorInvalidValue;
}
