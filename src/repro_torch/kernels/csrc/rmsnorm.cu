// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_fwd (_rms_kernel):
// y = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32, cast back to
// x's dtype.
//
// Bound on the H100: bytes.  Per element it reads x once and writes y once
// (4 B per element in bf16) for ~4 flops, far below the ~295 flop/B where the
// card stops being memory-bound.  Design (rmsnorm_rows_kernel): the row stays
// in registers between the two sweeps, so x is read from device memory once
// and never from L1 again.
// * Narrow rows (up to 512 16-byte packs: d <= 4096 in bf16, 2048 in fp32),
//   when there are enough rows to fill the card: one warp per row, each lane
//   holding up to 16 packs; the sum of squares is reduced by shuffles only,
//   no shared memory and no CTA barrier.  A CTA of 8 warps walks rows
//   grid-stride, as many CTAs an SM as the registers allow (4 with up to 8
//   packs a lane).
// * Wider rows (zamba2-7b's gated norm at 7168, up to 1024 packs), and few
//   rows (a decode step's 8): one CTA of 256 threads per row, the warps'
//   partial sums meeting in a double-buffered shared array, one barrier a row.
// x is read and y written with streaming hints (ld.global.cs, st.global.cs):
// neither is touched again, so they do not push `scale` out of the caches.
// A thread holding 16 packs, or a CTA per row, loads its slice of `scale`
// once and keeps it packed in registers; with up to 8 packs a lane it
// re-reads the slice from L1 each row, since holding it would cost the
// occupancy of 4 CTAs an SM.  (Measured with `chip_smoke.py --phases
// build,baseline`: at (4096, 2048) in bf16, 0.0135 ms against 0.0147 for the
// slice held in registers; PERF.md.)  y is rounded once from x * inv * scale
// in fp32, as the plain version rounds.  Rows that are not 16-byte aligned, d
// that is not a multiple of the pack, and rows wider than 1024 packs take
// the generic kernel (rmsnorm_kernel: a CTA per row, a second sweep that
// re-reads x from L1).
#include "common.cuh"

template <typename T, typename S, int VEC>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                               T* __restrict__ out, int d, float eps) {
  const size_t row = blockIdx.x;
  const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * d);
  Pack<T, VEC>* orow = reinterpret_cast<Pack<T, VEC>*>(out + row * d);
  const int nvec = d / VEC;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Pack<T, VEC> p = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float f = to_f32(p.v[j]);
      ss += f * f;
    }
  }

  __shared__ float red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / (float)d + eps);

  for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
    Pack<T, VEC> p = xr[i];
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      o.v[j] = from_f32<T>(to_f32(p.v[j]) * inv * to_f32(scale[i * VEC + j]));
    }
    orow[i] = o;
  }
}

constexpr int RMS_THREADS = 256;

// x and y are touched once: 16-byte loads and stores that stream past the caches
template <typename P> __device__ __forceinline__ P load_stream(const P* p) {
  uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<P*>(&u);
}
template <typename P> __device__ __forceinline__ void store_stream(P* p, const P& v) {
  __stcs(reinterpret_cast<uint4*>(p), *reinterpret_cast<const uint4*>(&v));
}

template <typename T, typename S, int NP, int WPR>
__global__ void __launch_bounds__(RMS_THREADS, (WPR == 1 && NP <= 8) ? 4 : 1)
    rmsnorm_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                        T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int V = 16 / sizeof(T);               // elements of one 16-byte pack of x
  constexpr int TPR = 32 * WPR;                   // threads per row
  constexpr int RPC = RMS_THREADS / TPR;          // rows a CTA takes at once
  using XP = Pack<T, V>;
  using SP = Pack<S, V>;                          // the matching elements of scale
  const int nvec = d / V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tr = threadIdx.x % TPR;

  constexpr bool HOLD = !(WPR == 1 && NP <= 8);   // the scale slice lives in registers
  SP sc[HOLD ? NP : 1];
#pragma unroll
  for (int i = 0; i < (HOLD ? NP : 0); ++i)
    if (i * TPR + tr < nvec) sc[i] = reinterpret_cast<const SP*>(scale)[i * TPR + tr];

  __shared__ float red[2][WPR];
  int buf = 0;
  for (long long row = (long long)blockIdx.x * RPC + threadIdx.x / TPR; row < rows;
       row += (long long)gridDim.x * RPC) {
    // a held slice stays packed in its own type and is converted at each use
    // (a shift or a move an element): converted once, 16 packs of bf16 would
    // take 128 registers
#pragma unroll
    for (int i = 0; i < (HOLD ? NP : 0); ++i)
#pragma unroll
      for (int w = 0; w < (int)(sizeof(SP) / 4); ++w)
        asm volatile("" : "+r"(reinterpret_cast<uint32_t*>(&sc[i])[w]));
    const XP* xr = reinterpret_cast<const XP*>(x + row * d);
    XP xv[NP];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i * TPR + tr < nvec) {
        xv[i] = load_stream(xr + i * TPR + tr);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f32(xv[i].v[j]);
          ss += f * f;
        }
      }
    // the packs, not their fp32 values, stay live into the second sweep
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) asm volatile("" : "+r"(reinterpret_cast<uint32_t*>(&xv[i])[w]));
    ss = warp_sum(ss);
    if (WPR > 1) {                                // every thread of the CTA is on this row
      if (lane == 0) red[buf][warp] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < WPR; ++w) ss += red[buf][w];
      buf ^= 1;
    }
    const float inv = rsqrtf(ss / (float)d + eps);
    XP* orow = reinterpret_cast<XP*>(out + row * d);
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i * TPR + tr < nvec) {
        XP o;
        const SP sv = HOLD ? sc[HOLD ? i : 0] : reinterpret_cast<const SP*>(scale)[i * TPR + tr];
#pragma unroll
        for (int j = 0; j < V; ++j)
          o.v[j] = from_f32<T>(to_f32(xv[i].v[j]) * inv * to_f32(sv.v[j]));
        store_stream(orow + i * TPR + tr, o);
      }
  }
}

// grid: enough CTAs for every row, at most what the SMs hold at once
template <typename T, typename S, int NP, int WPR>
static cudaError_t launch_rows(const T* x, const S* scale, T* out, long long rows, int d,
                              float eps, int sms, cudaStream_t st) {
  static int per_sm = 0;
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rmsnorm_rows_kernel<T, S, NP, WPR>, RMS_THREADS, 0);
    if (err != cudaSuccess) return err;
    per_sm = per_sm < 1 ? 1 : per_sm;
  }
  constexpr int RPC = RMS_THREADS / (32 * WPR);
  long long grid = (rows + RPC - 1) / RPC;
  grid = grid < (long long)per_sm * sms ? grid : (long long)per_sm * sms;
  rmsnorm_rows_kernel<T, S, NP, WPR><<<(unsigned)grid, RMS_THREADS, 0, st>>>(x, scale, out, rows,
                                                                              d, eps);
  return cudaGetLastError();
}

static int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return count[dev];
}

// the row held in registers: a warp per row while that fills every SM, else
// a CTA per row; the fewest packs a thread holds (NP) that cover the row.
// `done` is false when the row is too wide for the registers.
template <typename T, typename S>
static cudaError_t launch_in_registers(const T* x, const S* scale, T* out, long long rows, int d,
                                      float eps, cudaStream_t st, bool& done) {
  constexpr int V = 16 / sizeof(T);
  const int nvec = d / V, sms = sm_count();
  done = true;
  if (nvec <= 512 && rows >= 8LL * sms) {         // a warp per row still fills every SM
    if (nvec <= 32) return launch_rows<T, S, 1, 1>(x, scale, out, rows, d, eps, sms, st);
    if (nvec <= 64) return launch_rows<T, S, 2, 1>(x, scale, out, rows, d, eps, sms, st);
    if (nvec <= 128) return launch_rows<T, S, 4, 1>(x, scale, out, rows, d, eps, sms, st);
    if (nvec <= 256) return launch_rows<T, S, 8, 1>(x, scale, out, rows, d, eps, sms, st);
    return launch_rows<T, S, 16, 1>(x, scale, out, rows, d, eps, sms, st);
  }
  if (nvec <= 256) return launch_rows<T, S, 1, 8>(x, scale, out, rows, d, eps, sms, st);
  if (nvec <= 512) return launch_rows<T, S, 2, 8>(x, scale, out, rows, d, eps, sms, st);
  if (nvec <= 1024) return launch_rows<T, S, 4, 8>(x, scale, out, rows, d, eps, sms, st);
  done = false;
  return cudaSuccess;
}

template <typename T, typename S>
static cudaError_t launch(const void* x, const void* scale, void* out, long long rows, int d,
                          float eps, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (d % V == 0) && ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const int nvec = vec ? d / V : d;
  int threads = ((nvec + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const T* xp = static_cast<const T*>(x);
  const S* sp = static_cast<const S*>(scale);
  T* op = static_cast<T*>(out);
  if (vec && (uintptr_t)scale % sizeof(Pack<S, V>) == 0) {
    bool done = false;
    cudaError_t err = launch_in_registers<T, S>(xp, sp, op, rows, d, eps, st, done);
    if (done) return err;
  }
  if (vec)
    rmsnorm_kernel<T, S, V><<<(unsigned)rows, threads, 0, st>>>(xp, sp, op, d, eps);
  else
    rmsnorm_kernel<T, S, 1><<<(unsigned)rows, threads, 0, st>>>(xp, sp, op, d, eps);
  return cudaGetLastError();
}

extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out, long long rows, int d,
                           float eps, int x_dtype, int scale_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 0x7fffffffLL || d <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == DT_BF16 && scale_dtype == DT_BF16)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, st);
  if (x_dtype == DT_BF16 && scale_dtype == DT_F32)
    return (int)launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, st);
  if (x_dtype == DT_F32 && scale_dtype == DT_F32)
    return (int)launch<float, float>(x, scale, out, rows, d, eps, st);
  if (x_dtype == DT_F32 && scale_dtype == DT_BF16)
    return (int)launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
