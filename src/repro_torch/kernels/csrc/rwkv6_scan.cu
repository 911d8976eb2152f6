// Chunked WKV6 forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_chunked_fwd
// (_rwkv_kernel).  Per head (K = V = head dim), with log-decay ld_t <= 0:
//     out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(e^{ld_t}) S_{t-1} + k_t v_t^T.
// Over a chunk of CH tokens with inclusive prefix sums La_t = sum_{i<=t} ld_i
// (and La_{-1} = 0), from the state S_0 before the chunk:
//     out_t = (r_t * e^{La_{t-1}}) S_0                                (inter)
//           + sum_{s<t} [sum_k r_tk k_sk e^{La_{t-1,k} - La_{s,k}}] v_s   (intra)
//           + (r_t * u * k_t) . v_t                                   (bonus)
//     S_c   = diag(e^{La_c}) S_0 + sum_s (k_s * e^{La_c - La_s}) v_s^T.
// Every exponent above is <= 0, so no factor can overflow: the intra ratio
// is taken pairwise inside the (t, s) loop instead of the TPU kernel's
// k * e^{-La} factorisation, which returns inf once a chunk's log-decay sum
// passes about -88.
//
// Bound on the H100: at rwkv6-1.6b's training shape (B 8, T 512, H 32,
// K 64) about 2.4 GFLOP of fp32 chunk products against ~101 MB of inputs
// and output, so operations (67 TFLOP/s fp32 outside the tensor cores) and
// bytes bound it about equally.  Design: one CTA per (batch, head) walks
// the chunks in order, holding the (K, K) fp32 state in shared memory and
// staging each chunk's r, k, v and log-decay there as fp32 (rows padded to
// K+1 floats so that the per-pair loop reads distinct banks).  Scalar fp32
// FMA; mma.sync / wgmma and TMA are later work.
#include "common.cuh"

constexpr int CH = 16;    // tokens per chunk: CH*CH score pairs = one per thread
constexpr int NT = 256;   // threads per CTA
static_assert(NT == CH * CH, "phase C gives each thread one (t, s) pair");

template <int K>
struct Smem {
  static constexpr int KP = K + 1;                    // padded row stride
  static constexpr size_t floats = (size_t)K * K      // state
                                   + 5 * CH * KP      // r, k, v, La, La_prev
                                   + CH * (CH + 1)    // scores
                                   + 2 * K;           // u, e^{La_c}
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int K>
__global__ void __launch_bounds__(NT)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ lw, const float* __restrict__ u, T* __restrict__ out,
             int seq, int heads) {
  constexpr int KP = Smem<K>::KP;
  constexpr int PP = CH + 1;
  extern __shared__ float smem[];
  float* S = smem;                  // (K, K) state, row = key channel
  float* sr = S + K * K;            // r, then r * e^{La_{t-1}}
  float* sk = sr + CH * KP;         // k, then k * e^{La_c - La_s}
  float* sv = sk + CH * KP;         // v
  float* sla = sv + CH * KP;        // log-decay, then its inclusive prefix La
  float* slp = sla + CH * KP;       // exclusive prefix La_{t-1}
  float* sP = slp + CH * KP;        // (CH, CH) scores, bonus on the diagonal
  float* su = sP + CH * PP;         // u of this head
  float* sdec = su + K;             // e^{La_c}

  const int tid = threadIdx.x;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const size_t tok_stride = (size_t)heads * K;
  const size_t base = ((size_t)b * seq * heads + h) * K;

  for (int i = tid; i < K * K; i += NT) S[i] = 0.f;
  for (int i = tid; i < K; i += NT) su[i] = u[(size_t)h * K + i];

  for (int c0 = 0; c0 < seq; c0 += CH) {
    // A: stage the chunk (rows past the sequence: zeros, decay 1)
    for (int i = tid; i < CH * K; i += NT) {
      const int t = i / K, kk = i % K;
      float rv = 0.f, kv = 0.f, vv = 0.f, lv = 0.f;
      if (c0 + t < seq) {
        const size_t g = base + (size_t)(c0 + t) * tok_stride + kk;
        rv = to_f32(r[g]);
        kv = to_f32(k[g]);
        vv = to_f32(v[g]);
        lv = lw[g];
      }
      sr[t * KP + kk] = rv;
      sk[t * KP + kk] = kv;
      sv[t * KP + kk] = vv;
      sla[t * KP + kk] = lv;
    }
    __syncthreads();
    // B: prefix sums of the log-decay, one channel per thread
    for (int kk = tid; kk < K; kk += NT) {
      float acc = 0.f;
      for (int t = 0; t < CH; ++t) {
        const float ld = sla[t * KP + kk];
        slp[t * KP + kk] = acc;
        acc += ld;
        sla[t * KP + kk] = acc;
      }
    }
    __syncthreads();
    // C: scores, one (t, s) pair per thread; every exponent is <= 0
    {
      const int t = tid / CH, s = tid % CH;
      float acc = 0.f;
      if (s < t) {
        const float* rt = sr + t * KP;
        const float* ks = sk + s * KP;
        const float* lpt = slp + t * KP;
        const float* las = sla + s * KP;
#pragma unroll 8
        for (int kk = 0; kk < K; ++kk) acc += rt[kk] * ks[kk] * expf(lpt[kk] - las[kk]);
      } else if (s == t) {
        const float* rt = sr + t * KP;
        const float* kt = sk + t * KP;
#pragma unroll 8
        for (int kk = 0; kk < K; ++kk) acc += rt[kk] * su[kk] * kt[kk];
      }
      sP[t * PP + s] = acc;
    }
    __syncthreads();
    // D: decay-weighted r and k for the inter-chunk term and the state update
    for (int i = tid; i < CH * K; i += NT) {
      const int t = i / K, kk = i % K;
      const float la_end = sla[(CH - 1) * KP + kk];
      sr[t * KP + kk] *= expf(slp[t * KP + kk]);
      sk[t * KP + kk] *= expf(la_end - sla[t * KP + kk]);
      if (t == 0) sdec[kk] = expf(la_end);
    }
    __syncthreads();
    // E: out_t = (r_t e^{La_{t-1}}) S_0 + sum_{s<=t} P[t,s] v_s
    for (int i = tid; i < CH * K; i += NT) {
      const int t = i / K, j = i % K;
      if (c0 + t >= seq) continue;
      const float* rq = sr + t * KP;
      float acc = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < K; ++kk) acc += rq[kk] * S[kk * K + j];
      for (int s = 0; s <= t; ++s) acc += sP[t * PP + s] * sv[s * KP + j];
      out[base + (size_t)(c0 + t) * tok_stride + j] = from_f32<T>(acc);
    }
    __syncthreads();
    // F: S = diag(e^{La_c}) S + sum_s kd_s v_s^T
    for (int i = tid; i < K * K; i += NT) {
      const int kk = i / K, j = i % K;
      float acc = sdec[kk] * S[i];
#pragma unroll
      for (int s = 0; s < CH; ++s) acc += sk[s * KP + kk] * sv[s * KP + j];
      S[i] = acc;
    }
    __syncthreads();
  }
}

template <typename T, int K>
static cudaError_t launch(const void* r, const void* k, const void* v, const float* lw,
                          const float* u, void* out, int batch, int seq, int heads,
                          cudaStream_t st) {
  constexpr size_t smem = Smem<K>::bytes;
  static_assert(smem <= 48 * 1024, "past the default dynamic shared memory limit");
  rwkv6_kernel<T, K><<<(unsigned)(batch * heads), NT, smem, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v), lw, u,
      static_cast<T*>(out), seq, heads);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(const void* r, const void* k, const void* v, const float* lw,
                            const float* u, void* out, int batch, int seq, int heads, int dk,
                            cudaStream_t st) {
  switch (dk) {
    case 32: return launch<T, 32>(r, k, v, lw, u, out, batch, seq, heads, st);
    case 64: return launch<T, 64>(r, k, v, lw, u, out, batch, seq, heads, st);
    default: return cudaErrorInvalidValue;
  }
}

// r/k/v/out (B, T, H, K) contiguous in `dtype`; log_w (B, T, H, K) and
// u (H, K) contiguous float32.
extern "C" int rwkv6_fwd(const void* r, const void* k, const void* v, const void* log_w,
                         const void* u, void* out, int batch, int seq, int heads, int dk,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || heads <= 0 || (long long)batch * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* lw = static_cast<const float*>(log_w);
  const float* uu = static_cast<const float*>(u);
  if (dtype == DT_F32) return (int)dispatch<float>(r, k, v, lw, uu, out, batch, seq, heads, dk, st);
  if (dtype == DT_BF16)
    return (int)dispatch<__nv_bfloat16>(r, k, v, lw, uu, out, batch, seq, heads, dk, st);
  return (int)cudaErrorInvalidValue;
}
