// Fused RMSNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm_fwd (_rms_kernel):
// y = x * rsqrt(mean(x^2) + eps) * scale, statistics in fp32, cast back to
// x's dtype.
//
// Bound on the H100: bytes.  Per element it reads x once and writes y once
// (4 B per element in bf16) for ~4 flops, far below the ~295 flop/B where the
// card stops being memory-bound.  Design: one CTA per row, so D (up to 8192)
// stays whole and the reduction never leaves the SM; 16-byte vector loads
// and stores when the row is aligned; fp32 sum of squares reduced with warp
// shuffles and one shared-memory step.  The second sweep re-reads the row,
// which the first sweep just brought into L1, so device memory sees x once.
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
