// One query token against a KV cache, for Hopper (sm_90a): the body shared
// by the dense decode kernel (decode_attention.cu) and the paged one
// (paged_attention.cu).  The two differ only in where a lane's cache
// positions live, which a Layout says:
//
//   int  end(int b)                  lane b's positions lie in [0, end(b))
//   int  n_items(int b, int n_split) CTAs of lane b that take part (the rest
//                                    exit at once and are not waited for)
//   int  span()                      logical positions per lane
//   bool live(int b, int p)          position p takes part in the softmax if p < end(b)
//   uint32_t chunk_mask(int b, int p0, int end)
//                                    bit j: position p0 + j < end is live (j < 16)
//   int  row(int b, int p)           row of position p in the (rows, G, D) K/V arrays
//
// row reads only the layout's own arrays (the block table), so it is asked
// for any position of the span; K/V rows are read only for live positions
// below end(b).
//
// Bound on the H100: bytes.  Every live cache position is read once (K and
// V, 4*D bytes in bf16) for ~4*H/G flops a byte pair, so the kernel is a KV
// stream; at serving batch the whole op is ~10-30 MB, a few microseconds of
// the card's bandwidth, so what counts is that the loads are asked for
// early and together and that few round trips (barriers, layout reads, the
// cross-CTA merge, launches) stand in series with them.
//
// Grid (G, B, n_split): CTA (g, b, split) takes positions [split*split_len,
// (split+1)*split_len) of lane b and KV head g, so the H/G query heads of a
// KV head read it once.  A CTA's ring fills most of an SM's shared memory,
// so the wrapper cuts a lane into slices only while the (lane, KV head)
// pairs are fewer than the SMs (one CTA an SM); the split index varies
// slowest, so CTAs past a short lane's end, which exit at once, come last.
// Each of the 8 warps takes every 8th chunk of 16 positions and walks its
// chunks alone, with no CTA barrier.  It first reads the live mask of all its
// (at most 32) chunks in one round trip and then walks only chunks with a
// live position.  Each chunk's K and V rows go by 16-byte cp.async (a masked
// position's row zero-filled, never read) into the warp's own DEC_STAGES-deep
// ring of bf16 tiles in shared memory, rows padded by 16 bytes so ldmatrix
// is free of bank conflicts; one chunk is computed while the next are in
// flight, and a paged row's table entry is read a chunk ahead.  Scores and
// P.V run on mma.sync (m16n8k16, bf16 in, fp32 out) with the query heads as
// the 16 rows (H/G <= 8 of them used): Q's fragments stay in registers, K's
// come from ldmatrix and V's from ldmatrix.trans, and the score accumulators
// become P's A fragments in registers, so P.V never touches shared memory.
// Each warp keeps its own running (m, l, acc) in registers (exp2 domain);
// the warps merge once through shared memory at the end, and the CTAs of a
// (lane, KV head) through fp32 scratch: the last CTA to finish (an
// acquire-release atomic counter) merges and resets the counter to 0, so
// the wrapper needs no memset and one launch does the op.
//
// fp32 inputs (the reduced configurations' parity runs) take a simple body
// with the same slices and merge: lanes split D, V staged in fp32.
//
// A (lane, KV head) with no live position at all writes the mean of V over
// the lane's whole span: the TPU kernels mask with a finite -1e30, so their
// softmax over an all-masked span is uniform.  Only such a lane takes that
// branch of the merge.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

using hopper::LOG2E;
using hopper::cp_async16;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::ex2;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::pack_bf16;

constexpr int DEC_THREADS = 256;
constexpr int DEC_WARPS = DEC_THREADS / 32;
constexpr int DEC_TILE = 64;       // slices are whole multiples of this many positions
constexpr int MAX_NREP = 8;
constexpr int DEC_CHUNK = 16;      // positions a warp loads and computes at once
constexpr int DEC_STAGES = 2;      // chunks in flight per warp
constexpr int DEC_MAX_SPLIT = 32 * DEC_CHUNK * DEC_WARPS;   // a warp walks at most 32 chunks

// ---- the merge, shared by both bodies -----------------------------------------

// The CTA's result for its slice lies in shared memory: (m, l) per head in
// s_m / s_l (exp2 domain, m = -inf for a slice with no live position) and the
// unnormalised acc (nrep x D) in s_acc.  Write it as this slice's partial and,
// in the last CTA of the (lane, KV head), merge the partials into `out`; with
// one slice, write `out` directly.
template <typename T, int D, typename Layout>
__device__ __forceinline__ void finish_slice(const Layout& lay, const T* __restrict__ v,
                                             T* __restrict__ out, float* __restrict__ part_m,
                                             float* __restrict__ part_l,
                                             float* __restrict__ part_acc,
                                             int* __restrict__ counters, int H, int G,
                                             int n_split, int b, int g, int split,
                                             const float* s_m, const float* s_l,
                                             const float* s_acc, int* s_last) {
  const int nrep = H / G, tid = threadIdx.x;
  const int n_items = lay.n_items(b, n_split);
  const size_t bg = (size_t)b * G + g;
  if (n_items > 1) {
    const size_t slot = bg * n_split + split;
    for (int e = tid; e < nrep * D; e += DEC_THREADS) part_acc[slot * nrep * D + e] = s_acc[e];
    if (tid < nrep) {
      part_m[slot * nrep + tid] = s_m[tid];
      part_l[slot * nrep + tid] = s_l[tid];
    }
    __syncthreads();
    if (tid == 0) {
      // release this CTA's partial (ordered by the barrier above), acquire the
      // others' if this is the last CTA of the pair
      int prev;
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                   : "=r"(prev)
                   : "l"(&counters[bg])
                   : "memory");
      const int last = prev == n_items - 1;
      if (last) counters[bg] = 0;            // every CTA of this pair has counted
      *s_last = last;
    }
    __syncthreads();
    if (!*s_last) return;
  }
  const size_t base = bg * n_split;
  for (int e = tid; e < nrep * D; e += DEC_THREADS) {
    const int r = e / D, dd = e % D;
    float mx, l, a;
    if (n_items == 1) {
      mx = s_m[r];
      l = s_l[r];
      a = s_acc[e];
    } else {
      // one pass, online: the loads of several slices are in flight together
      mx = -INFINITY;
      l = a = 0.f;
#pragma unroll 8
      for (int sp = 0; sp < n_items; ++sp) {
        const size_t i = (base + sp) * nrep + r;
        const float m_sp = __ldcg(&part_m[i]), l_sp = __ldcg(&part_l[i]);
        const float a_sp = __ldcg(&part_acc[i * D + dd]);
        if (m_sp == -INFINITY) continue;                  // a slice with no live position
        const float m_new = fmaxf(mx, m_sp);
        const float c = ex2(mx - m_new), w = ex2(m_sp - m_new);   // c = 0 at first
        l = l * c + w * l_sp;
        a = a * c + w * a_sp;
        mx = m_new;
      }
    }
    float res;
    if (mx != -INFINITY) {
      res = a / l;              // l >= 1: the slice holding the max adds exp(0)
    } else {
      // no live position in the span: the uniform softmax of the finite mask
      const int span = lay.span();
      float s = 0.f;
      for (int p = 0; p < span; ++p) s += to_f32(v[((size_t)lay.row(b, p) * G + g) * D + dd]);
      res = s / (float)span;
    }
    out[((size_t)b * H + g * nrep + r) * D + dd] = from_f32<T>(res);
  }
}

// ---- the bf16 body: per-warp cp.async ring, mma.sync -------------------------

// d (16 x 8, fp32) += A (16 x 16) . B (16 x 8), bf16; A's rows 8-15 are zero
// (a1 = a3 = 0): only the query heads' rows 0-7 exist
__device__ __forceinline__ void mma_rows8(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// the lowest chunk index left in `todo`, taken out of it; -1 when it is empty
__device__ __forceinline__ int pop_chunk(uint32_t& todo) {
  const int c = __ffs(todo) - 1;
  todo &= todo - 1;
  return c;
}

template <int D>
struct MmaGeom {
  static constexpr int ROW_BYTES = D * 2;                 // one K or V row in bf16
  static constexpr int ROW = ROW_BYTES + 16;              // padded smem row, bytes
  static constexpr int SEGS = ROW_BYTES / 16;             // 16-byte segments of a row
  static constexpr int TILE_BYTES = DEC_CHUNK * ROW;      // K or V of one chunk
  static constexpr int RING = DEC_WARPS * DEC_STAGES * 2 * TILE_BYTES;
  // after the loop: per-warp (m, l, acc), then the CTA's
  static constexpr int MERGE = (DEC_WARPS * MAX_NREP * (D + 2) + MAX_NREP * (D + 2)) * 4;
  static constexpr int SMEM = RING > MERGE ? RING : MERGE;
};

template <int D, typename Layout>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_mma_kernel(const Layout lay, const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_acc,
                      int* __restrict__ counters, int H, int G, int n_split, int split_len,
                      float scale) {
  using Geo = MmaGeom<D>;
  constexpr int KSTEPS = D / 16, NT = D / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r16 = lane & 15;
  const int begin = split * split_len, last_p = lay.span() - 1;
  // position r16 of this warp's c-th chunk, and its K/V row in the arrays;
  // row reads only the layout (the table), so it may be asked for any
  // position of the span, and the first chunks' rows are asked for before
  // the lane's end is known
  auto pos_of = [&](int c) { return begin + (warp + c * DEC_WARPS) * DEC_CHUNK + r16; };
  int rows0[DEC_STAGES];
#pragma unroll
  for (int s = 0; s < DEC_STAGES; ++s) rows0[s] = lay.row(b, min(pos_of(s), last_p));
  auto row_of = [&](int c) {
#pragma unroll
    for (int s = 0; s < DEC_STAGES; ++s)
      if (c == s) return rows0[s];
    return lay.row(b, min(pos_of(c), last_p));
  };
  if (split >= lay.n_items(b, n_split)) return;     // past the lane's end: nothing to merge
  const int nrep = H / G;
  const int qr = lane >> 2, qc = (lane & 3) * 2;    // fragment row (query head) and column pair
  const float sl2 = scale * LOG2E;

  // the live positions of each of this warp's (at most 32) chunks: lane c
  // holds chunk c's mask, read in one round trip; only live chunks are walked
  const int end = min(lay.end(b), begin + split_len);
  const int c0 = begin + (warp + lane * DEC_WARPS) * DEC_CHUNK;
  const uint32_t my_mask = c0 < end ? lay.chunk_mask(b, c0, end) : 0u;
  const uint32_t live_chunks = __ballot_sync(0xffffffffu, my_mask != 0);

  // this KV head's query heads as the rows of mma's A (rows 8-15 are zero)
  uint32_t qa[KSTEPS][2];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    qa[ks][0] = qa[ks][1] = 0u;
    if (qr < nrep) {
      const __nv_bfloat16* qp = q + ((size_t)b * H + g * nrep + qr) * D + ks * 16 + qc;
      qa[ks][0] = *reinterpret_cast<const uint32_t*>(qp);
      qa[ks][1] = *reinterpret_cast<const uint32_t*>(qp + 8);
    }
  }

  // this warp's ring: per stage a K and a V tile of 16 padded rows
  const uint32_t ring = static_cast<uint32_t>(__cvta_generic_to_shared(smem)) +
                        warp * DEC_STAGES * 2 * Geo::TILE_BYTES;
  // chunk c into stage st by 16-byte cp.async, consecutive lanes on
  // consecutive segments of a row; a masked position's row is zero-filled
  // and never read
  auto issue = [&](int c, int row, int st) {
    const uint32_t m = __shfl_sync(0xffffffffu, my_mask, c);
    const int r = (m >> r16) & 1u ? row : -1;
    const uint32_t dst0 = ring + st * 2 * Geo::TILE_BYTES;
#pragma unroll
    for (int it = 0; it < DEC_CHUNK * Geo::SEGS / 32; ++it) {
      const int idx = lane + it * 32, pr = idx / Geo::SEGS, sg = idx % Geo::SEGS;
      const int rr = __shfl_sync(0xffffffffu, r, pr);
      const size_t off = rr >= 0 ? ((size_t)rr * G + g) * D + sg * 8 : 0;
      const uint32_t dst = dst0 + pr * Geo::ROW + sg * 16;
      cp_async16(dst, k + off, rr >= 0);
      cp_async16(dst + Geo::TILE_BYTES, v + off, rr >= 0);
    }
    cp_async_commit();
  };

  float m_run = -INFINITY, l_run = 0.f;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  uint32_t to_issue = live_chunks, to_use = live_chunks;
#pragma unroll
  for (int s = 0; s < DEC_STAGES; ++s) {
    if (to_issue) {
      const int c = pop_chunk(to_issue);
      issue(c, row_of(c), s);
    } else {
      cp_async_commit();                       // an empty group keeps the count
    }
  }
  int next_c = to_issue ? pop_chunk(to_issue) : -1;        // the next chunk to load, its row
  int next_row = next_c >= 0 ? row_of(next_c) : 0;
  for (int use = 0; to_use; ++use) {
    const int c = pop_chunk(to_use), st = use % DEC_STAGES;
    const uint32_t mask = __shfl_sync(0xffffffffu, my_mask, c);
    // the row of the chunk after next is read while this one is computed
    const int after_c = to_issue ? pop_chunk(to_issue) : -1;
    const int after_row = after_c >= 0 ? row_of(after_c) : 0;
    cp_async_wait<DEC_STAGES - 1>();
    __syncwarp();
    const uint32_t kt = ring + st * 2 * Geo::TILE_BYTES, vt = kt + Geo::TILE_BYTES;
    // S (heads x 16 positions) = Q K^T, two n-tiles of 8 positions
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int mat = lane >> 3;
    const uint32_t k_addr = kt + ((mat >> 1) * 8 + (lane & 7)) * Geo::ROW + (mat & 1) * 16;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t kb[4];
      ldmatrix_x4(kb, k_addr + ks * 32);
      mma_rows8(s[0], qa[ks][0], qa[ks][1], kb[0], kb[1]);
      mma_rows8(s[1], qa[ks][0], qa[ks][1], kb[2], kb[3]);
    }
    // online softmax over this chunk, per head (the quad of lanes of a row)
    float x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = (j >> 1) * 8 + qc + (j & 1);
      x[j] = (mask >> p) & 1u ? s[j >> 1][j & 1] * sl2 : -INFINITY;
    }
    float mc = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
    mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
    const float m_new = fmaxf(m_run, mc);          // finite: the chunk has a live position
    const float corr = ex2(m_run - m_new);   // 0 when m_run = -inf
    m_run = m_new;
    float pr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) pr[j] = ex2(x[j] - m_new);
    l_run = l_run * corr + (pr[0] + pr[1]) + (pr[2] + pr[3]);   // this lane's columns
    const uint32_t pa0 = pack_bf16(pr[0], pr[1]), pa2 = pack_bf16(pr[2], pr[3]);
    // acc (heads x D) = acc * corr + P V, V's fragments by ldmatrix.trans
    const uint32_t v_addr = vt + ((mat & 1) * 8 + (lane & 7)) * Geo::ROW + (mat >> 1) * 16;
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, v_addr + n2 * 32);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[2 * n2 + h][0] *= corr;
        acc[2 * n2 + h][1] *= corr;
        mma_rows8(acc[2 * n2 + h], pa0, pa2, vb[2 * h], vb[2 * h + 1]);
      }
    }
    __syncwarp();                                    // stage st is free again
    if (next_c >= 0)
      issue(next_c, next_row, st);
    else
      cp_async_commit();
    next_c = after_c;
    next_row = after_row;
  }
  cp_async_wait<0>();
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);

  // merge the warps through shared memory (the ring is no longer read)
  __syncthreads();
  float* w_acc = reinterpret_cast<float*>(smem);                 // [warp][head][D]
  float* w_m = w_acc + DEC_WARPS * MAX_NREP * D;                  // [warp][head]
  float* w_l = w_m + DEC_WARPS * MAX_NREP;
  float* c_acc = w_l + DEC_WARPS * MAX_NREP;                      // the CTA's [head][D]
  float* c_m = c_acc + MAX_NREP * D;
  float* c_l = c_m + MAX_NREP;
  if (qr < nrep) {
    float* row_acc = w_acc + (warp * MAX_NREP + qr) * D + qc;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(row_acc + n * 8) = make_float2(acc[n][0], acc[n][1]);
    if ((lane & 3) == 0) {
      w_m[warp * MAX_NREP + qr] = m_run;
      w_l[warp * MAX_NREP + qr] = l_run;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nrep * D; e += DEC_THREADS) {
    const int r = e / D, dd = e % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) mx = fmaxf(mx, w_m[w * MAX_NREP + r]);
    float a = 0.f, l = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < DEC_WARPS; ++w) {
        const float wt = ex2(w_m[w * MAX_NREP + r] - mx);
        a += wt * w_acc[(w * MAX_NREP + r) * D + dd];
        l += wt * w_l[w * MAX_NREP + r];
      }
    }
    c_acc[e] = a;
    if (dd == 0) {
      c_m[r] = mx;
      c_l[r] = l;
    }
  }
  __syncthreads();
  finish_slice<__nv_bfloat16, D>(lay, v, out, part_m, part_l, part_acc, counters, H, G, n_split,
                                 b, g, split, c_m, c_l, c_acc, &s_last);
}

// ---- the simple body (fp32): lanes split D, V staged in shared memory --------

template <typename T, int D, typename Layout>
__global__ void __launch_bounds__(DEC_THREADS)
    decode_simple_kernel(const Layout lay, const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out, float* __restrict__ part_m,
                         float* __restrict__ part_l, float* __restrict__ part_acc,
                         int* __restrict__ counters, int H, int G, int n_split, int split_len,
                         float scale) {
  constexpr int EPL = (D + 31) / 32;                            // dot-product slice per lane
  constexpr int PPW = DEC_TILE / DEC_WARPS;                     // positions per warp in a tile
  constexpr int ACC_N = (MAX_NREP * D + DEC_THREADS - 1) / DEC_THREADS;
  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  if (split >= lay.n_items(b, n_split)) return;
  const int nrep = H / G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_d = lane * EPL < D;
  const float sl2 = scale * LOG2E;

  __shared__ float s_p[MAX_NREP][DEC_TILE];
  __shared__ float s_v[DEC_TILE][D];
  __shared__ float s_m[MAX_NREP], s_l[MAX_NREP], s_corr[MAX_NREP];
  __shared__ float s_acc[MAX_NREP * D];
  __shared__ int s_row[DEC_TILE];
  __shared__ int s_last;

  float qv[MAX_NREP][EPL];
#pragma unroll
  for (int r = 0; r < MAX_NREP; ++r)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[r][e] = r < nrep && has_d ? to_f32(q[((size_t)b * H + g * nrep + r) * D + lane * EPL + e])
                                   : 0.f;
  float acc[ACC_N];
#pragma unroll
  for (int i = 0; i < ACC_N; ++i) acc[i] = 0.f;
  if (tid < MAX_NREP) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }

  const int s_begin = split * split_len, s_end = min(lay.end(b), s_begin + split_len);
  for (int t0 = s_begin; t0 < s_end; t0 += DEC_TILE) {
    const int n = min(DEC_TILE, s_end - t0);
    int flag = 0;
    if (tid < DEC_TILE) {
      flag = tid < n ? (int)lay.live(b, t0 + tid) : 0;
      s_row[tid] = flag ? lay.row(b, t0 + tid) : -1;
    }
    if (!__syncthreads_or(flag)) continue;       // whole tile masked: skip its K/V

    float kv[PPW][EPL];
#pragma unroll
    for (int jj = 0; jj < PPW; ++jj) {
      const int j = warp * PPW + jj;
      if (s_row[j] >= 0 && has_d) {
        const Pack<T, EPL> p = *reinterpret_cast<const Pack<T, EPL>*>(
            k + ((size_t)s_row[j] * G + g) * D + lane * EPL);
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[jj][e] = to_f32(p.v[e]);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kv[jj][e] = 0.f;
      }
    }
    constexpr int VPL = 16 / sizeof(T);
    for (int idx = tid; idx < DEC_TILE * D / VPL; idx += DEC_THREADS) {
      const int j = idx / (D / VPL), c = (idx % (D / VPL)) * VPL;
      Pack<T, VPL> p;
      if (s_row[j] >= 0) {
        p = *reinterpret_cast<const Pack<T, VPL>*>(v + ((size_t)s_row[j] * G + g) * D + c);
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) p.v[e] = from_f32<T>(0.f);
      }
#pragma unroll
      for (int e = 0; e < VPL; ++e) s_v[j][c + e] = to_f32(p.v[e]);
    }
#pragma unroll
    for (int jj = 0; jj < PPW; ++jj) {
      const int j = warp * PPW + jj;
#pragma unroll
      for (int r = 0; r < MAX_NREP; ++r) {
        if (r < nrep) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot += qv[r][e] * kv[jj][e];
          dot = warp_sum(dot);
          if (lane == 0) s_p[r][j] = s_row[j] >= 0 ? dot * sl2 : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online-softmax update, one warp per head; the tile has a live position
    for (int r = warp; r < nrep; r += DEC_WARPS) {
      const float a = s_p[r][lane], c = s_p[r][lane + 32];
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = exp2f(a - m_new), pc = exp2f(c - m_new);
      s_p[r][lane] = pa;
      s_p[r][lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float corr = exp2f(m_prev - m_new);            // 0 when m_prev = -inf
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
#pragma unroll
  for (int i = 0; i < ACC_N; ++i) {
    const int e = tid + i * DEC_THREADS;
    if (e < nrep * D) s_acc[e] = acc[i];
  }
  __syncthreads();
  finish_slice<T, D>(lay, v, out, part_m, part_l, part_acc, counters, H, G, n_split, b, g, split,
                     s_m, s_l, s_acc, &s_last);
}

// ---- host: one launcher for both layouts --------------------------------------

template <int D, typename Layout>
static cudaError_t launch_mma(const Layout& lay, const void* q, const void* k, const void* v,
                              void* out, void* pm, void* pl, void* pa, void* cnt, int B, int H,
                              int G, int n_split, int split_len, float scale, cudaStream_t st) {
  constexpr int SMEM = MmaGeom<D>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(decode_mma_kernel<D, Layout>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  decode_mma_kernel<D, Layout><<<dim3(G, B, n_split), DEC_THREADS, SMEM, st>>>(
      lay, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(pm), static_cast<float*>(pl), static_cast<float*>(pa),
      static_cast<int*>(cnt), H, G, n_split, split_len, scale);
  return cudaGetLastError();
}

template <int D, typename Layout>
static cudaError_t launch_simple(const Layout& lay, const void* q, const void* k, const void* v,
                                 void* out, void* pm, void* pl, void* pa, void* cnt, int B, int H,
                                 int G, int n_split, int split_len, float scale,
                                 cudaStream_t st) {
  decode_simple_kernel<float, D, Layout><<<dim3(G, B, n_split), DEC_THREADS, 0, st>>>(
      lay, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), static_cast<float*>(pm),
      static_cast<float*>(pl), static_cast<float*>(pa), static_cast<int*>(cnt), H, G, n_split,
      split_len, scale);
  return cudaGetLastError();
}

template <typename Layout>
static cudaError_t launch_decode(const Layout& lay, int D, int dtype, const void* q,
                                 const void* k, const void* v, void* out, void* pm, void* pl,
                                 void* pa, void* cnt, int B, int H, int G, int n_split,
                                 int split_len, float scale, cudaStream_t st) {
  if (B <= 0 || G <= 0 || H % G != 0 || H / G > MAX_NREP || n_split <= 0 || split_len <= 0 ||
      split_len % DEC_TILE != 0 || split_len > DEC_MAX_SPLIT || B > 65535 || n_split > 65535)
    return cudaErrorInvalidValue;
#define DEC_ARGS lay, q, k, v, out, pm, pl, pa, cnt, B, H, G, n_split, split_len, scale, st
  if (dtype == DT_BF16) {
    switch (D) {
      case 32: return launch_mma<32>(DEC_ARGS);
      case 64: return launch_mma<64>(DEC_ARGS);
      case 112: return launch_mma<112>(DEC_ARGS);
      case 128: return launch_mma<128>(DEC_ARGS);
    }
  } else if (dtype == DT_F32) {
    switch (D) {
      case 32: return launch_simple<32>(DEC_ARGS);
      case 64: return launch_simple<64>(DEC_ARGS);
      case 112: return launch_simple<112>(DEC_ARGS);
      case 128: return launch_simple<128>(DEC_ARGS);
    }
  }
#undef DEC_ARGS
  return cudaErrorInvalidValue;
}
