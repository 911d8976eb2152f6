// One query token against a KV cache, for Hopper (sm_90a): the body shared
// by the dense decode kernel (decode_attention.cu) and the paged one
// (paged_attention.cu).  The two differ only in where a lane's cache
// positions live, which a Layout says:
//
//   void   slice(int b, int split, int n_split, int& begin, int& end)
//              the positions [begin, end) that CTA `split` of lane b walks
//   int    span()              logical positions per lane
//   bool   live(int b, int p)  position p of lane b takes part in the softmax
//   size_t row(int b, int p)   row of position p in the (rows, G, D) K/V arrays
//
// Bound on the H100: bytes.  Every live cache position is read once (K and
// V) for ~4 flops per byte, so the kernel is a KV stream at ~1 flop/B.  A
// CTA per (lane, KV head) would give B*G CTAs (64 at 8 lanes x 8 KV heads)
// on 132 SMs, half the card idle, so each lane's positions are cut into
// n_split slices (flash-decoding): one CTA per (lane, KV head, slice), so
// the H/G query heads that share a KV head read it once.  Each CTA keeps
// running (m, l, acc) for its heads and writes them to scratch; the last CTA
// of a (lane, KV head) to finish -- found with an atomic counter after a
// __threadfence -- merges the slices and writes the output, so one launch
// does the whole op.  Each warp issues the K loads of all its positions
// (D/32 elements a lane, one whole row per warp instruction) before reducing
// any, and V is staged with 16-byte loads, so loads are in flight together.
// Tiles of 64 positions with no live position are skipped before K/V is
// touched.
//
// A (lane, KV head) with no live position at all writes the mean of V over
// the lane's whole span: the TPU kernels mask with a finite -1e30, so their
// softmax over an all-masked span is uniform.  Only such a lane takes that
// branch of the merge.
#pragma once

#include "common.cuh"

constexpr int DEC_THREADS = 128;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_TILE = 64;
constexpr int MAX_NREP = 8;
constexpr int DEC_PPW = DEC_TILE / DEC_WARPS;    // positions per warp in a tile

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_kernel(const Layout lay, const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int* __restrict__ counters, int H, int G, int n_split, float scale) {
  constexpr int EPL = D / 32;                                   // dot-product slice per lane
  constexpr int ACC_N = (MAX_NREP * D + DEC_THREADS - 1) / DEC_THREADS;
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nrep = H / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  __shared__ float s_p[MAX_NREP][DEC_TILE];
  __shared__ float s_v[DEC_TILE][D];
  __shared__ float s_m[MAX_NREP], s_l[MAX_NREP], s_corr[MAX_NREP];
  __shared__ size_t s_row[DEC_TILE];
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

  int s_begin, s_end;
  lay.slice(b, split, n_split, s_begin, s_end);
  for (int t0 = s_begin; t0 < s_end; t0 += DEC_TILE) {
    const int n = min(DEC_TILE, s_end - t0);
    int flag = 0;
    if (tid < DEC_TILE) {
      flag = tid < n ? (int)lay.live(b, t0 + tid) : 0;
      s_valid[tid] = (uint8_t)flag;
      s_row[tid] = flag ? lay.row(b, t0 + tid) : 0;
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
            k + (s_row[j] * G + g) * D + lane * EPL);
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
        p = *reinterpret_cast<const Pack<T, VPL>*>(v + (s_row[j] * G + g) * D + c);
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
    float res;
    if (mx != -INFINITY) {
      float l = 0.f, a = 0.f;
      for (int sp = 0; sp < n_split; ++sp) {
        const float w = expf(__ldcg(&part_m[(base + sp) * nrep + r]) - mx);
        l += w * __ldcg(&part_l[(base + sp) * nrep + r]);
        a += w * __ldcg(&part_acc[((base + sp) * nrep + r) * D + dd]);
      }
      res = a / l;              // l >= 1: the slice holding the max adds exp(0)
    } else {
      // no live position in the span: the uniform softmax of the finite mask
      const int span = lay.span();
      float a = 0.f;
      for (int p = 0; p < span; ++p) a += to_f32(v[(lay.row(b, p) * G + g) * D + dd]);
      res = a / (float)span;
    }
    out[((size_t)b * H + g * nrep + r) * D + dd] = from_f32<T>(res);
  }
}
