// Mamba2 SSD chunk scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mamba2_ssd.py::mamba2_ssd_fwd
// (_ssd_kernel).  Per (batch, head), with a scalar log-decay dt_t * A <= 0
// per step and B/C shared by all heads (n_groups 1), over chunks of CH
// tokens with la_t the inclusive prefix sum of dt * A inside the chunk and
// S0 the (P, N) state before it:
//     y_t = e^{la_t} C_t . S0^T + sum_{s<=t} e^{la_t - la_s} (C_t . B_s) dt_s x_s + D x_t
//     S   = e^{la_c} S0 + sum_s e^{la_c - la_s} dt_s x_s (x) B_s.
// Only pairs s <= t are formed, so every exponent is <= 0 and no factor can
// overflow.  The prefix sums are kept in fp64 (64 per chunk), so that
// la_t - la_s keeps its digits when both are large (under strong decay a
// chunk's log-decay reaches thousands while the pairs that count differ by
// less than one).  A tail shorter than a chunk is staged as zeros with
// dt = 0: decay 1 and no update.
//
// Bound on the H100: at zamba2-7b's training shape (B 8, T 512, H 112,
// P 64, N 64) four 64^3 products per (batch, head, chunk) -- C.S0^T, C.B^T,
// G.x and the state update, ~2 MFLOP -- over 7,168 of them: ~14 GFLOP of
// fp32 FMA, ~0.2 ms at 67 TFLOP/s outside the tensor cores, against ~135 MB
// of x, y, B/C, dt and the fp32 final state (~0.04 ms).  Operations bound it.
// Design: the TPU grid walked (batch*head, chunk) with the state carried in
// VMEM from one grid step to the next; here one CTA per (batch, head) --
// 896 CTAs at that shape, several waves over 132 SMs -- loops over the
// chunks itself with the fp32 state, the chunk's x, B, C and the (CH, CH)
// score tile in shared memory (~82 KB at P = N = 64, so the dynamic shared
// memory opt-in).  Each thread holds a 4-row register tile of every
// product.  x and y keep their (B, T, H, P) layout and x, B, C are read
// through their strides (the TPU wrapper transposed x to (B*H, T, P) first,
// a copy each way).  Scalar fp32 FMA; mma.sync / wgmma on the chunk
// products, and sharing C.B^T (head-independent) across the heads of a
// batch, are later work.
#include "common.cuh"

constexpr int CH = 64;    // tokens per chunk (the TPU kernel's DEFAULT_CHUNK)
constexpr int NT = 256;   // threads per CTA, a TX x (NT / TX) grid
constexpr int TX = 16;    // column groups: thread tx takes columns tx, tx + 16, ...
constexpr int TR = 4;     // chunk rows per thread: (NT / TX) * TR == CH
static_assert((NT / TX) * TR == CH && 4 * TX == CH, "one CH x CH score tile per CTA");

template <int P, int N>
struct SsdSmem {
  static constexpr int NS = N + 1;                   // padded rows of S, B, C
  static constexpr int GS = CH + 1;                  // padded rows of the score tile
  static constexpr size_t floats = (size_t)P * NS    // state
                                   + (size_t)CH * P  // x
                                   + 2 * (size_t)CH * NS   // B, C
                                   + (size_t)CH * GS       // scores G
                                   + 2 * CH                // la (fp64)
                                   + 3 * CH;               // dt, e^{la}, e^{la_c - la} dt
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ state, long long xsb, long long xst,
           long long bsb, long long bst, long long csb, long long cst, int seq, int heads) {
  using L = SsdSmem<P, N>;
  constexpr int NS = L::NS, GS = L::GS;
  constexpr int PJ = P / TX;          // columns of x / y per thread
  constexpr int NJ = N / TX;          // columns of the state per thread
  constexpr int PR = P / (NT / TX);   // rows of the state per thread
  static_assert(P % TX == 0 && N % TX == 0 && P % (NT / TX) == 0, "P, N multiples of 16");
  extern __shared__ float smem[];
  double* sla = reinterpret_cast<double*>(smem);   // la_t, fp64
  float* S = smem + 2 * CH;           // (P, NS) state, row = head channel p
  float* sX = S + P * NS;             // (CH, P)
  float* sB = sX + CH * P;            // (CH, NS)
  float* sC = sB + CH * NS;           // (CH, NS)
  float* sG = sC + CH * NS;           // (CH, GS) masked scores
  float* sdt = sG + CH * GS;          // dt_s
  float* sel = sdt + CH;              // e^{la_t}
  float* sw = sel + CH;               // e^{la_c - la_s} dt_s

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const float a = A[h], dcoef = Dv[h];
  const T* xb = x + b * xsb + (long long)h * P;
  const T* bb = Bm + b * bsb;
  const T* cb = Cm + b * csb;
  const float* dtb = dt + (size_t)b * seq * heads + h;
  T* yb = y + ((size_t)b * seq * heads + h) * P;
  const size_t y_tok = (size_t)heads * P;

  for (int i = tid; i < P * NS; i += NT) S[i] = 0.f;

  for (int c0 = 0; c0 < seq; c0 += CH) {
    // A: stage x, B, C as fp32 (rows past the sequence: zeros)
    for (int i = tid; i < CH * P; i += NT) {
      const int t = i / P, p = i % P;
      sX[i] = c0 + t < seq ? to_f32(xb[(c0 + t) * xst + p]) : 0.f;
    }
    for (int i = tid; i < CH * N; i += NT) {
      const int t = i / N, n = i % N;
      const bool in = c0 + t < seq;
      sB[t * NS + n] = in ? to_f32(bb[(c0 + t) * bst + n]) : 0.f;
      sC[t * NS + n] = in ? to_f32(cb[(c0 + t) * cst + n]) : 0.f;
    }
    // B: la = inclusive prefix of dt * A, warp 0, two tokens a lane
    if (tid < 32) {
      const int t0 = 2 * tid;
      const float d0 = c0 + t0 < seq ? dtb[(size_t)(c0 + t0) * heads] : 0.f;
      const float d1 = c0 + t0 + 1 < seq ? dtb[(size_t)(c0 + t0 + 1) * heads] : 0.f;
      const double v0 = (double)(d0 * a), v1 = v0 + (double)(d1 * a);
      double inc = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, inc, o);
        if (tid >= o) inc += u;
      }
      const double up = __shfl_up_sync(0xffffffffu, inc, 1);
      const double ex = tid == 0 ? 0.0 : up;
      const double l0 = ex + v0, l1 = inc;
      const double lend = __shfl_sync(0xffffffffu, inc, 31);
      sdt[t0] = d0;
      sdt[t0 + 1] = d1;
      sla[t0] = l0;
      sla[t0 + 1] = l1;
      sel[t0] = expf((float)l0);
      sel[t0 + 1] = expf((float)l1);
      sw[t0] = expf((float)(lend - l0)) * d0;
      sw[t0 + 1] = expf((float)(lend - l1)) * d1;
    }
    __syncthreads();

    // C: rows t = ty*TR + i.  Scores G[t][s] = e^{la_t - la_s} (C_t . B_s) dt_s
    // for s <= t (columns s = tx + 16j), and the inter-chunk term
    // e^{la_t} C_t . S0^T (columns p = tx + 16j), kept in registers
    float acc[TR][PJ];
    {
      float g[TR][4];
#pragma unroll
      for (int i = 0; i < TR; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      }
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[TR], bv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < TR; ++i) cv[i] = sC[(ty * TR + i) * NS + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[(tx + TX * j) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = S[(tx + TX * j) * NS + n];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += cv[i] * sv[j];
        }
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = ty * TR + i;
        const double lt = sla[t];
        const float et = sel[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + TX * j;
          sG[t * GS + s] = s <= t ? g[i][j] * expf((float)(lt - sla[s])) * sdt[s] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= et;
      }
    }
    __syncthreads();

    // D: y_t = inter + sum_{s<=t} G[t][s] x_s + D x_t (G is 0 past the diagonal)
    {
      const int s_end = ty * TR + TR;
      for (int s = 0; s < s_end; ++s) {
        float gv[TR], xv[PJ];
#pragma unroll
        for (int i = 0; i < TR; ++i) gv[i] = sG[(ty * TR + i) * GS + s];
#pragma unroll
        for (int j = 0; j < PJ; ++j) xv[j] = sX[s * P + tx + TX * j];
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] += gv[i] * xv[j];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = ty * TR + i;
        if (c0 + t >= seq) continue;
#pragma unroll
        for (int j = 0; j < PJ; ++j) {
          const int p = tx + TX * j;
          yb[(size_t)(c0 + t) * y_tok + p] = from_f32<T>(acc[i][j] + dcoef * sX[t * P + p]);
        }
      }
    }
    // E: S = e^{la_c} S + sum_s (e^{la_c - la_s} dt_s x_s) (x) B_s; each thread
    // updates only its own entries (rows p = ty*PR + i, columns n = tx + 16j),
    // and every read of S in C finished at the barrier above
    {
      const float dec = sel[CH - 1];
      float st[PR][NJ];
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) st[i][j] = dec * S[(ty * PR + i) * NS + tx + TX * j];
#pragma unroll 4
      for (int s = 0; s < CH; ++s) {
        const float ws = sw[s];
        float xw[PR], bv[NJ];
#pragma unroll
        for (int i = 0; i < PR; ++i) xw[i] = sX[s * P + ty * PR + i] * ws;
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = sB[s * NS + tx + TX * j];
#pragma unroll
        for (int i = 0; i < PR; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) st[i][j] += xw[i] * bv[j];
      }
#pragma unroll
      for (int i = 0; i < PR; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) S[(ty * PR + i) * NS + tx + TX * j] = st[i][j];
    }
    __syncthreads();
  }

  float* so = state + ((size_t)b * heads + h) * P * N;
  for (int i = tid; i < P * N; i += NT) so[i] = S[(i / N) * NS + i % N];
}

template <typename T, int P, int N>
static cudaError_t launch(const void* x, const float* dt, const float* A, const void* B,
                          const void* C, const float* D, void* y, float* state, long long xsb,
                          long long xst, long long bsb, long long bst, long long csb,
                          long long cst, int batch, int seq, int heads, cudaStream_t st) {
  constexpr size_t smem = SsdSmem<P, N>::bytes;
  static_assert(smem <= 227 * 1024, "past the shared memory a CTA can take");
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<T, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<T, P, N><<<(unsigned)(batch * heads), NT, smem, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(B), static_cast<const T*>(C), D,
      static_cast<T*>(y), state, xsb, xst, bsb, bst, csb, cst, seq, heads);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch(int P, int N, const void* x, const float* dt, const float* A,
                            const void* B, const void* C, const float* D, void* y, float* state,
                            long long xsb, long long xst, long long bsb, long long bst,
                            long long csb, long long cst, int batch, int seq, int heads,
                            cudaStream_t st) {
#define SSD_CASE(PP, NN)                                                                   \
  if (P == PP && N == NN)                                                                  \
    return launch<T, PP, NN>(x, dt, A, B, C, D, y, state, xsb, xst, bsb, bst, csb, cst, batch, \
                             seq, heads, st);
  SSD_CASE(32, 16)   // zamba2 reduced widths
  SSD_CASE(64, 64)   // zamba2-7b
#undef SSD_CASE
  return cudaErrorInvalidValue;
}

// x (B, T, H, P) with (H, P) packed and batch / token strides xsb / xst (in
// elements); B, C (B, T, N) with N packed and strides bsb / bst, csb / cst;
// x, B, C, y in `dtype`.  dt (B, T, H), A (H,), D (H,) contiguous float32;
// y (B, T, H, P) and state (B, H, P, N, float32) contiguous.
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
                              const void* C, const void* D, void* y, void* state, long long xsb,
                              long long xst, long long bsb, long long bst, long long csb,
                              long long cst, int batch, int seq, int heads, int P, int N,
                              int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || seq <= 0 || heads <= 0 || (long long)batch * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* sf = static_cast<float*>(state);
  if (dtype == DT_F32)
    return (int)dispatch<float>(P, N, x, dtf, Af, B, C, Df, y, sf, xsb, xst, bsb, bst, csb, cst,
                                batch, seq, heads, st);
  if (dtype == DT_BF16)
    return (int)dispatch<__nv_bfloat16>(P, N, x, dtf, Af, B, C, Df, y, sf, xsb, xst, bsb, bst,
                                        csb, cst, batch, seq, heads, st);
  return (int)cudaErrorInvalidValue;
}
