// Decode attention (one query token over a dense KV cache) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_fwd
// (_dec_kernel): q (B,1,H,D) against ck/cv (B,S,G,D), masked per lane by
// valid (B,S), online softmax in fp32, H/G query heads per KV head (GQA).
//
// Bound on the H100: bytes.  Every live cache position is read once (K and
// V) for ~4 flops per byte, so the kernel is a KV stream at ~1 flop/B.  The
// TPU walked the span in order inside one grid row per lane; here that would
// give B*G CTAs (64 at serving batch 8 x 8 KV heads) on 132 SMs, half the
// card idle.  Design (flash-decoding): the span is cut into n_split slices,
// one CTA per (lane, KV head, slice), so the H/G heads that share a KV head
// read it once; each CTA keeps running (m, l, acc) for its heads and writes
// them to scratch.  The last CTA of a (lane, KV head) to finish -- found with
// an atomic counter after a __threadfence -- merges the slices and writes
// the output, so one launch does the whole op.  Each warp issues the K
// loads of all its positions before reducing any, and V is staged with
// 16-byte loads, so loads are in flight together.  Tiles of 64 positions with
// no live position are skipped before K/V is touched, so bytes scale with
// each lane's filled length, not the cache span.  A lane with no live
// position at all returns 0 (the flash kernel's l == 0 rule).
#include "common.cuh"

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_TILE = 64;
constexpr int MAX_NREP = 8;
constexpr int DEC_PPW = DEC_TILE / DEC_WARPS;    // positions per warp in a tile

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const uint8_t* __restrict__ valid,
                            T* __restrict__ out, float* __restrict__ part_m,
                            float* __restrict__ part_l, float* __restrict__ part_acc,
                            int* __restrict__ counters, int S, int H, int G, int split_len,
                            int n_split, float scale) {
  constexpr int EPL = D / 32;                                   // dot-product slice per lane
  constexpr int ACC_N = (MAX_NREP * D + DEC_THREADS - 1) / DEC_THREADS;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nrep = H / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  __shared__ float s_p[MAX_NREP][DEC_TILE];
  __shared__ float s_v[DEC_TILE][D];
  __shared__ float s_m[MAX_NREP], s_l[MAX_NREP], s_corr[MAX_NREP];
  __shared__ uint8_t s_valid[DEC_TILE];
  __shared__ int s_last;

  // this KV head's query heads, the lane's slice of D, in registers
  float qr[MAX_NREP][EPL];
#pragma unroll
  for (int r = 0; r < MAX_NREP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[r][e] = r < nrep ? to_f32(q[((size_t)b * H + g * nrep + r) * D + lane * EPL + e]) : 0.f;
  float acc[ACC_N];
#pragma unroll
  for (int i = 0; i < ACC_N; ++i) acc[i] = 0.f;
  if (tid < MAX_NREP) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  const int s_begin = split * split_len;
  const int s_end = min(S, s_begin + split_len);
  for (int t0 = s_begin; t0 < s_end; t0 += DEC_TILE) {
    const int n = min(DEC_TILE, s_end - t0);
    int flag = 0;
    if (tid < DEC_TILE) {
      flag = tid < n ? (valid[(size_t)b * S + t0 + tid] != 0) : 0;
      s_valid[tid] = (uint8_t)flag;
    }
    if (!__syncthreads_or(flag)) continue;       // whole tile masked: skip its K/V

    // scores: each warp owns DEC_PPW consecutive positions, lanes split D;
    // all of the warp's K loads are issued before the first reduction
    float kv[DEC_PPW][EPL];
#pragma unroll
    for (int jj = 0; jj < DEC_PPW; ++jj) {
      const int j = warp * DEC_PPW + jj;
      if (s_valid[j]) {
        const Pack<T, EPL> p = *reinterpret_cast<const Pack<T, EPL>*>(
            k + (((size_t)b * S + t0 + j) * G + g) * D + lane * EPL);
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[jj][e] = to_f32(p.v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[jj][e] = 0.f;
      }
    }
    // stage the live V rows in shared memory (zeros elsewhere), 16 B a load
    constexpr int VPL = 16 / sizeof(T);                 // elements per 16-byte load
#pragma unroll
    for (int i = 0; i < DEC_TILE * D / VPL / DEC_THREADS; ++i) {
      const int idx = tid + i * DEC_THREADS;
      const int j = idx / (D / VPL), c = (idx % (D / VPL)) * VPL;
      Pack<T, VPL> p;
      if (s_valid[j]) {
        p = *reinterpret_cast<const Pack<T, VPL>*>(v + (((size_t)b * S + t0 + j) * G + g) * D + c);
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) p.v[e] = from_f32<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < VPL; ++e) s_v[j][c + e] = to_f32(p.v[e]);
    }
#pragma unroll
    for (int jj = 0; jj < DEC_PPW; ++jj) {
      const int j = warp * DEC_PPW + jj;
#pragma unroll
      for (int r = 0; r < MAX_NREP; ++r) {
        if (r < nrep) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot += qr[r][e] * kv[jj][e];
          dot = warp_sum(dot);
          if (lane == 0) s_p[r][j] = s_valid[j] ? dot * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online-softmax update, one warp per head; the tile has a live position
    // so the new running max is finite
    for (int r = warp; r < nrep; r += DEC_WARPS) {
      const float a = s_p[r][lane], c = s_p[r][lane + 32];
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      s_p[r][lane] = pa;
      s_p[r][lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);             // 0 when m_prev = -inf
        s_l[r] = s_l[r] * corr + sum;
        s_m[r] = m_new;
        s_corr[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < ACC_N; ++i) {
      const int e = tid + i * DEC_THREADS, r = e / D, dd = e % D;
      if (r < nrep) {
        float a = acc[i] * s_corr[r];
        for (int j = 0; j < DEC_TILE; ++j) a += s_p[r][j] * s_v[j][dd];
        acc[i] = a;
      }
    }
    __syncthreads();                              // s_p / s_v are rewritten next tile
  }

  // this slice's partial (m, l, acc) -> scratch
  const size_t slot = ((size_t)b * G + g) * n_split + split;
  if (tid < nrep) {
    part_m[slot * nrep + tid] = s_m[tid];
    part_l[slot * nrep + tid] = s_l[tid];
  }
#pragma unroll
  for (int i = 0; i < ACC_N; ++i) {
    const int e = tid + i * DEC_THREADS, r = e / D, dd = e % D;
    if (r < nrep) part_acc[(slot * nrep + r) * D + dd] = acc[i];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[b * G + g], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // last CTA of this (lane, KV head): merge the slices
  const size_t base = ((size_t)b * G + g) * n_split;
#pragma unroll
  for (int i = 0; i < ACC_N; ++i) {
    const int e = tid + i * DEC_THREADS, r = e / D, dd = e % D;
    if (r >= nrep) continue;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_split; ++sp) mx = fmaxf(mx, __ldcg(&part_m[(base + sp) * nrep + r]));
    float l = 0.f, a = 0.f;
    if (mx != -INFINITY) {
      for (int sp = 0; sp < n_split; ++sp) {
        const float w = expf(__ldcg(&part_m[(base + sp) * nrep + r]) - mx);
        l += w * __ldcg(&part_l[(base + sp) * nrep + r]);
        a += w * __ldcg(&part_acc[((base + sp) * nrep + r) * D + dd]);
      }
    }
    out[((size_t)b * H + g * nrep + r) * D + dd] = from_f32<T>(l == 0.f ? 0.f : a / l);
  }
}

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* valid,
                          void* out, void* part_m, void* part_l, void* part_acc, void* counters,
                          int B, int S, int H, int G, int split_len, int n_split, float scale,
                          cudaStream_t st) {
  dim3 grid(n_split, G, B);
  decode_attention_kernel<T, D><<<grid, DEC_THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const uint8_t*>(valid), static_cast<T*>(out), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), static_cast<int*>(counters), S,
      H, G, split_len, n_split, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                              const void* valid, void* out, void* pm, void* pl, void* pa,
                              void* cnt, int B, int S, int H, int G, int split_len, int n_split,
                              float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, valid, out, pm, pl, pa, cnt, B, S, H, G, split_len, n_split, scale, st);
    case 64: return launch<T, 64>(q, k, v, valid, out, pm, pl, pa, cnt, B, S, H, G, split_len, n_split, scale, st);
    case 128: return launch<T, 128>(q, k, v, valid, out, pm, pl, pa, cnt, B, S, H, G, split_len, n_split, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, void* part_m, void* part_l,
                                    void* part_acc, void* counters, int B, int S, int H, int G,
                                    int D, int split_len, int n_split, float scale, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || G <= 0 || H % G != 0 || H / G > MAX_NREP || n_split <= 0 ||
      split_len % DEC_TILE != 0 || (long long)split_len * n_split < S || B > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, valid, out, part_m, part_l, part_acc,
                                          counters, B, S, H, G, split_len, n_split, scale, st);
  if (dtype == DT_F32)
    return (int)dispatch_d<float>(D, q, k, v, valid, out, part_m, part_l, part_acc, counters, B,
                                  S, H, G, split_len, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
