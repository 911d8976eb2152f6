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
// overflow (the TPU kernel's e^{la_t} e^{-la_s} factoring is the trap).  The
// prefix sums are kept in fp64, so that la_t - la_s keeps its digits when
// both are large (under strong decay a chunk's log-decay reaches thousands
// while the pairs that count differ by less than one).  A tail shorter than
// a chunk is staged as zeros with dt = 0: decay 1 and no update.
//
// Bound on the H100 at zamba2-7b's training shape (B 8, T 512, H 112, P 64,
// N 64, bf16): bytes.  x and y move 117 MB, the fp32 final state 14.7 MB,
// dt 1.8 MB, B and C 1 MB: ~135 MB, 0.040 ms at 3.35 TB/s.  The four chunk
// products -- C.S0^T, C.B^T, G.x and the state update -- are ~11.5 GFLOP,
// 0.012 ms on bf16 tensor cores (989 TFLOP/s) but 0.17 ms as fp32 FMA (67
// TFLOP/s), which is where a scalar body stays.
//
// bf16 body (ssd_kernel_tc; the training steps): a CTA takes HG = 2 heads of
// one batch and walks the chunks; 8 warps, warp w owning rows 16 (w % 4)..
// of P for head w / 4 (a slice of P needs only its own columns of x), all
// products on mma.sync m16n8k16 (bf16 in, fp32 out):
// * C.B^T does not depend on the head: each warp forms one 16 x 32 tile of it
//   once a chunk (the tiles at or below the diagonal), builds both heads'
//   G = C.B^T e^{la_t - la_s} dt_s (s <= t) from its accumulators and stores
//   G as bf16 rows for the heads' warps;
// * each warp keeps its 16 rows of the state in registers in fp32 across
//   the chunks: they are the accumulator of the update S = e^{la_c} S +
//   (w x)^T B and, split, the A operand of y^T = S0 C^T;
// * x^T comes once a chunk by ldmatrix.trans and serves G.x (y^T += x^T
//   G^T), D x and, scaled by w_s = e^{la_c - la_s} dt_s, the update.
// x, B and C are exact in bf16; S, G and w x are not, so each is split into
// hi + lo bf16 terms (16 mantissa bits, two products instead of one): the
// fp32 final state of a bf16 run stays within 3e-5 x max|ref| of the plain
// version, which one bf16 rounding would not.  The pair exponents of G are
// differences of fp32 offsets from the row block's first prefix sum, in
// log2 units (one ex2 each), which keeps their digits.  The next chunk's B, C
// and x load by cp.async into a second stage while this one computes.  The
// 448 CTAs of ~112 KB run two to an SM; the (32, 16) reduced widths take the
// same body with half the warps idle.  x, B and C are read through their
// strides (the model passes views of its conv output), by cp.async where
// every row is 16-byte aligned and element by element where not.  What it
// does about the bound: every product is on tensor cores, C.B^T once per
// (batch, chunk); what remains is issue (address arithmetic, the splits,
// the exponentials) and the barriers of a chunk walk, not bytes.
//
// fp32 body (ssd_kernel; the fp32 parity runs): one CTA per (batch, head)
// with the chunk, its (CH, CH) score tile and the state in shared memory
// (~82 KB at P = N = 64), each thread a 4-row register tile of every
// product in scalar fp32 FMA, so the fp32 route keeps fp32 products
// throughout.
#include "common.cuh"
#include "hopper.cuh"

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

// ---- the fp32 body: one CTA per (batch, head), scalar FMA ---------------------

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


// ---- the bf16 body: head groups, mma.sync --------------------------------------

constexpr int HG = 2;                     // heads of one batch per CTA
constexpr int TC_WARPS = 4 * HG;          // warp w: head w / 4 of the group, rows 16 (w % 4)..
constexpr int TC_THREADS = 32 * TC_WARPS;
static_assert(16 * 4 == CH, "four 16-row blocks a chunk");

template <int P, int N>
struct TcSmem {
  static constexpr int BS = N + 8;        // bf16 row of B and C (ldmatrix: no bank conflicts)
  static constexpr int XS = P + 8;        // bf16 row of x
  static constexpr int GS = CH + 8;       // bf16 row of G
  static constexpr size_t dt = 0;                                  // float [HG][CH]: dt_s
  static constexpr size_t el = dt + sizeof(float) * HG * CH;       // e^{la_t}
  static constexpr size_t w = el + sizeof(float) * HG * CH;        // e^{la_c - la_s} dt_s
  static constexpr size_t lr = w + sizeof(float) * HG * CH;        // float [HG][4][CH]: (la - la_{16i}) log2 e
  static constexpr size_t Ghi = lr + sizeof(float) * HG * 4 * CH;  // bf16 [HG][CH][GS]: G, hi
  static constexpr size_t Glo = Ghi + 2 * HG * CH * GS;            // and lo
  // two stages of a chunk's inputs, one computed while the next one loads
  static constexpr size_t B = 0;                                   // bf16 [CH][BS], in a stage
  static constexpr size_t C = B + 2 * CH * BS;
  static constexpr size_t X = C + 2 * CH * BS;                     // bf16 [HG][CH][XS]
  static constexpr size_t stage = X + 2 * HG * CH * XS;
  static constexpr size_t stages = Glo + 2 * HG * CH * GS;
  static constexpr size_t bytes = stages + 2 * stage;
  static_assert(Ghi % 16 == 0 && Glo % 16 == 0 && C % 16 == 0 && X % 16 == 0 &&
                stage % 16 == 0 && stages % 16 == 0, "16-byte rows");
};

template <int P, int N>
__global__ void __launch_bounds__(TC_THREADS, 2)
ssd_kernel_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm, const float* __restrict__ Dv,
              __nv_bfloat16* __restrict__ y, float* __restrict__ state, long long xsb,
              long long xst, long long bsb, long long bst, long long csb, long long cst, int seq,
              int heads, int vec) {
  using namespace hopper;
  using L = TcSmem<P, N>;
  constexpr int BS = L::BS, XS = L::XS, GS = L::GS;
  constexpr int KN = N / 16;              // k-steps over the state dim
  constexpr int NN = N / 8;               // n-tiles over the state dim
  constexpr int VB = N / 8, VX = P / 8;   // 16-byte vectors in a row of B / C, of x
  static_assert(P % 16 == 0 && N % 16 == 0 && HG * CH * VX % TC_THREADS == 0,
                "P, N multiples of 16");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sdt = reinterpret_cast<float*>(tc_smem + L::dt);
  float* sel = reinterpret_cast<float*>(tc_smem + L::el);
  float* sw = reinterpret_cast<float*>(tc_smem + L::w);
  float* slr = reinterpret_cast<float*>(tc_smem + L::lr);
  __nv_bfloat16* sGhi = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::Ghi);
  __nv_bfloat16* sGlo = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::Glo);

  const int groups = (heads + HG - 1) / HG;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * HG;
  const int nh = min(HG, heads - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int hh = warp / 4, blk = warp % 4;            // this warp's head and 16-row block
  const bool owner = hh < nh && 16 * blk < P;         // holds state rows 16 blk.. of head hh
  const int p0 = 16 * blk;
  const __nv_bfloat16* xb = x + b * xsb + (long long)h0 * P;
  const __nv_bfloat16* bb = Bm + b * bsb;
  const __nv_bfloat16* cb = Cm + b * csb;
  const uint32_t aGhi = smem_u32(sGhi), aGlo = smem_u32(sGlo);
  // a chunk's B, C and x: 16-byte vectors, cp.async into stage `buf` (rows
  // past the sequence and heads past the last are zero-filled)
  auto issue = [&](int cn, int buf) {
    const uint32_t sbase = smem_u32(tc_smem + L::stages + buf * L::stage);
    const int rn = min(CH, seq - cn);
#pragma unroll
    for (int k = 0; k < (CH * VB + TC_THREADS - 1) / TC_THREADS; ++k) {
      const int i = tid + k * TC_THREADS, t = i / VB, e = i % VB;
      if (CH * VB % TC_THREADS == 0 || i < CH * VB) {
        const bool rd = t < rn;
        const uint32_t o = 2 * (t * BS + 8 * e);
        cp_async16(sbase + L::B + o, rd ? bb + (cn + t) * bst + 8 * e : bb, rd);
        cp_async16(sbase + L::C + o, rd ? cb + (cn + t) * cst + 8 * e : cb, rd);
      }
    }
#pragma unroll
    for (int k = 0; k < HG * CH * VX / TC_THREADS; ++k) {
      const int i = tid + k * TC_THREADS, q = i / (CH * VX), t = i / VX % CH, e = i % VX;
      const bool rd = t < rn && q < nh;
      cp_async16(sbase + L::X + 2 * ((q * CH + t) * XS + 8 * e),
                 rd ? xb + (cn + t) * xst + q * P + 8 * e : xb, rd);
    }
    cp_async_commit();
  };

  // this warp's rows p0.. of head hh's state, fp32, in registers across the
  // chunks: the accumulator of the update and, split, the A operand of C.S0^T
  float st[NN][4];
#pragma unroll
  for (int j = 0; j < NN; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;

  if (vec) issue(0, 0);
  for (int c0 = 0, it = 0; c0 < seq; c0 += CH, ++it) {
    const int rows = min(CH, seq - c0);
    const int cur = vec ? it & 1 : 0;
    unsigned char* stg = tc_smem + L::stages + cur * L::stage;
    __nv_bfloat16* sB = reinterpret_cast<__nv_bfloat16*>(stg + L::B);
    __nv_bfloat16* sC = reinterpret_cast<__nv_bfloat16*>(stg + L::C);
    __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(stg + L::X);
    const uint32_t aB = smem_u32(sB), aC = smem_u32(sC), aX = smem_u32(sX);
    // A: this chunk's B, C and the group's x: by cp.async one chunk ahead
    // (the next chunk's go out at once and land while this one computes), or
    // element by element where a row is not 16-byte aligned
    if (vec) {
      cp_async_wait<0>();
      __syncthreads();
      if (c0 + CH < seq) issue(c0 + CH, cur ^ 1);
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < CH * N; i += TC_THREADS) {
        const int t = i / N, e = i % N;
        sB[t * BS + e] = t < rows ? bb[(c0 + t) * bst + e] : zero;
        sC[t * BS + e] = t < rows ? cb[(c0 + t) * cst + e] : zero;
      }
      for (int i = tid; i < HG * CH * P; i += TC_THREADS) {
        const int q = i / (CH * P), t = i / P % CH, e = i % P;
        sX[(q * CH + t) * XS + e] = t < rows && q < nh ? xb[(c0 + t) * xst + q * P + e] : zero;
      }
      __syncthreads();
    }

    // B: warp q < nh scans head q's log-decay (fp64 prefix, two tokens a
    // lane), while every warp forms a tile of C.B^T -- rows 16 blk.., columns
    // 32 (warp / 4).. -- once for all the heads of the group
    if (warp < nh) {
      const int q = warp;
      const float a = A[h0 + q];
      const float* dtp = dt + ((size_t)b * seq + c0) * heads + h0 + q;
      const int u0 = 2 * lane;
      const float d0 = u0 < rows ? dtp[(size_t)u0 * heads] : 0.f;
      const float d1 = u0 + 1 < rows ? dtp[(size_t)(u0 + 1) * heads] : 0.f;
      const double v0 = (double)(d0 * a), v1 = v0 + (double)(d1 * a);
      double inc = v1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += u;
      }
      const double up = __shfl_up_sync(0xffffffffu, inc, 1);
      const double l0 = (lane == 0 ? 0.0 : up) + v0, l1 = inc;
      const double lend = __shfl_sync(0xffffffffu, inc, 31);
      sdt[q * CH + u0] = d0;
      sdt[q * CH + u0 + 1] = d1;
      sel[q * CH + u0] = expf((float)l0);
      sel[q * CH + u0 + 1] = expf((float)l1);
      sw[q * CH + u0] = expf((float)(lend - l0)) * d0;
      sw[q * CH + u0 + 1] = expf((float)(lend - l1)) * d1;
      // la_s - la_{16i} for each block's first row: the pair exponents of G as
      // differences of two fp32 numbers that keep their digits (|la_t - la_s|
      // = |la_t - la_{16i}| + |la_{16i} - la_s| for s <= 16i <= t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const double ref = __shfl_sync(0xffffffffu, l0, 8 * i);
        slr[(q * 4 + i) * CH + u0] = (float)((l0 - ref) * (double)LOG2E);   // log2 units
        slr[(q * 4 + i) * CH + u0 + 1] = (float)((l1 - ref) * (double)LOG2E);
      }
    }
    const int t0 = 16 * blk, s0 = 32 * (warp / 4);
    const bool tile = s0 <= t0 + 15;         // a tile with pairs s <= t
    float cbm[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cbm[j][0] = cbm[j][1] = cbm[j][2] = cbm[j][3] = 0.f;
    if (tile) {
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t cf[4];
        ldmatrix_x4(cf, aC + ((t0 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS + 16 * kk +
                              (lane >> 4) * 8) * 2);
#pragma unroll
        for (int jq = 0; jq < 2; ++jq) {
          uint32_t bf[4];
          ldmatrix_x4(bf, aB + ((s0 + 16 * jq + (lane >> 4) * 8 + (lane & 7)) * BS + 16 * kk +
                                ((lane >> 3) & 1) * 8) * 2);
          mma_bf16(cbm[2 * jq], cf, bf[0], bf[1]);
          mma_bf16(cbm[2 * jq + 1], cf, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();

    // C: G = C.B^T e^{la_t - la_s} dt_s (s <= t, else 0) for each head, from
    // this warp's tile, split into hi + lo bf16 rows of G
    if (tile) {
      const int r0 = t0 + g, r1 = r0 + 8;
      for (int q = 0; q < nh; ++q) {
        const float* lr = slr + (q * 4 + blk) * CH;
        const float* dts = sdt + q * CH;
        const float l0 = lr[r0], l1 = lr[r1];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 8 * j + 2 * c;
          const float2 ls = *reinterpret_cast<const float2*>(lr + s);
          const float2 ds = *reinterpret_cast<const float2*>(dts + s);
          const float* m = cbm[j];
          uint32_t hi, lo;
          split_bf16(s <= r0 ? m[0] * ex2(l0 - ls.x) * ds.x : 0.f,
                     s + 1 <= r0 ? m[1] * ex2(l0 - ls.y) * ds.y : 0.f, hi, lo);
          *reinterpret_cast<uint32_t*>(sGhi + (q * CH + r0) * GS + s) = hi;
          *reinterpret_cast<uint32_t*>(sGlo + (q * CH + r0) * GS + s) = lo;
          split_bf16(s <= r1 ? m[2] * ex2(l1 - ls.x) * ds.x : 0.f,
                     s + 1 <= r1 ? m[3] * ex2(l1 - ls.y) * ds.y : 0.f, hi, lo);
          *reinterpret_cast<uint32_t*>(sGhi + (q * CH + r1) * GS + s) = hi;
          *reinterpret_cast<uint32_t*>(sGlo + (q * CH + r1) * GS + s) = lo;
        }
      }
    }
    __syncthreads();

    // D: y^T (rows p0.. of P, columns t) and the state update for this
    // warp's head and rows
    if (owner) {
      // x^T rows p0.., columns s: A fragments, exact; also x for D x
      uint32_t xa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4_trans(xa[kk], aX + ((hh * CH + 16 * kk + (lane >> 4) * 8 + (lane & 7)) * XS +
                                        p0 + ((lane >> 3) & 1) * 8) * 2);
      float yt[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) yt[j][0] = yt[j][1] = yt[j][2] = yt[j][3] = 0.f;
      // S0 . C^T: the state's accumulators are its A fragments, split hi + lo
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t ah[4], al[4];
        split_bf16(st[2 * kk][0], st[2 * kk][1], ah[0], al[0]);
        split_bf16(st[2 * kk][2], st[2 * kk][3], ah[1], al[1]);
        split_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1], ah[2], al[2]);
        split_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          uint32_t bf[4];
          ldmatrix_x4(bf, aC + ((16 * jq + (lane >> 4) * 8 + (lane & 7)) * BS + 16 * kk +
                                ((lane >> 3) & 1) * 8) * 2);
          mma_bf16(yt[2 * jq], ah, bf[0], bf[1]);
          mma_bf16(yt[2 * jq], al, bf[0], bf[1]);
          mma_bf16(yt[2 * jq + 1], ah, bf[2], bf[3]);
          mma_bf16(yt[2 * jq + 1], al, bf[2], bf[3]);
        }
      }
      // times e^{la_t} per column t
      const float* els = sel + hh * CH;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 e = *reinterpret_cast<const float2*>(els + 8 * j + 2 * c);
        yt[j][0] *= e.x;
        yt[j][1] *= e.y;
        yt[j][2] *= e.x;
        yt[j][3] *= e.y;
      }
      // + x^T . G^T over the blocks s <= t
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int jq = 0; jq < 4; ++jq) {
          if (jq < kk) continue;
          const uint32_t off = ((hh * CH + 16 * jq + (lane >> 4) * 8 + (lane & 7)) * GS + 16 * kk +
                                ((lane >> 3) & 1) * 8) * 2;
          uint32_t gh[4], gl[4];
          ldmatrix_x4(gh, aGhi + off);
          ldmatrix_x4(gl, aGlo + off);
          mma_bf16(yt[2 * jq], xa[kk], gh[0], gh[1]);
          mma_bf16(yt[2 * jq], xa[kk], gl[0], gl[1]);
          mma_bf16(yt[2 * jq + 1], xa[kk], gh[2], gh[3]);
          mma_bf16(yt[2 * jq + 1], xa[kk], gl[2], gl[3]);
        }
      }
      // + D x, out: y[t][p] from y^T's (p, t) pairs
      const float dco = Dv[h0 + hh];
      __nv_bfloat16* yb = y + (((size_t)b * seq + c0) * heads + h0 + hh) * P + p0 + g;
      const size_t ytok = (size_t)heads * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 xlo = unpack_bf16(xa[j / 2][2 * (j & 1)]);       // p0 + g, t = 8j + 2c..
        const float2 xhi = unpack_bf16(xa[j / 2][2 * (j & 1) + 1]);   // p0 + g + 8
        const int t = 8 * j + 2 * c;
        if (t < rows) {
          yb[t * ytok] = __float2bfloat16_rn(yt[j][0] + dco * xlo.x);
          yb[t * ytok + 8] = __float2bfloat16_rn(yt[j][2] + dco * xhi.x);
        }
        if (t + 1 < rows) {
          yb[(t + 1) * ytok] = __float2bfloat16_rn(yt[j][1] + dco * xlo.y);
          yb[(t + 1) * ytok + 8] = __float2bfloat16_rn(yt[j][3] + dco * xhi.y);
        }
      }
      // S = e^{la_c} S + (w x)^T B
      const float* ws = sw + hh * CH;
      const float dec = els[CH - 1];
#pragma unroll
      for (int j = 0; j < NN; ++j) {
        st[j][0] *= dec;
        st[j][1] *= dec;
        st[j][2] *= dec;
        st[j][3] *= dec;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int s = 16 * kk + 2 * c;
        const float2 w0 = *reinterpret_cast<const float2*>(ws + s);
        const float2 w8 = *reinterpret_cast<const float2*>(ws + s + 8);
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = unpack_bf16(xa[kk][i]);
          const float2 w = i >= 2 ? w8 : w0;        // a2, a3 hold columns 2c + 8, 2c + 9
          split_bf16(v.x * w.x, v.y * w.y, ah[i], al[i]);
        }
#pragma unroll
        for (int jq = 0; jq < N / 16; ++jq) {
          uint32_t bf[4];
          ldmatrix_x4_trans(bf, aB + ((16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7)) * BS +
                                      16 * jq + (lane >> 4) * 8) * 2);
          mma_bf16(st[2 * jq], ah, bf[0], bf[1]);
          mma_bf16(st[2 * jq], al, bf[0], bf[1]);
          mma_bf16(st[2 * jq + 1], ah, bf[2], bf[3]);
          mma_bf16(st[2 * jq + 1], al, bf[2], bf[3]);
        }
      }
    }
    __syncthreads();                      // G and this stage are free again
  }

  if (owner) {
    float* so = state + (((size_t)b * heads + h0 + hh) * P + p0 + g) * N + 2 * c;
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      *reinterpret_cast<float2*>(so + 8 * j) = make_float2(st[j][0], st[j][1]);
      *reinterpret_cast<float2*>(so + 8 * N + 8 * j) = make_float2(st[j][2], st[j][3]);
    }
  }
}

template <int P, int N>
static cudaError_t launch_f32(const void* x, const float* dt, const float* A, const void* B,
                              const void* C, const float* D, void* y, float* state, long long xsb,
                              long long xst, long long bsb, long long bst, long long csb,
                              long long cst, int batch, int seq, int heads, cudaStream_t st) {
  constexpr size_t smem = SsdSmem<P, N>::bytes;
  static_assert(smem <= 227 * 1024, "past the shared memory a CTA can take");
  cudaError_t err = cudaFuncSetAttribute(ssd_kernel<float, P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<float, P, N><<<(unsigned)(batch * heads), NT, smem, st>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(B),
      static_cast<const float*>(C), D, static_cast<float*>(y), state, xsb, xst, bsb, bst, csb,
      cst, seq, heads);
  return cudaGetLastError();
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int P, int N>
static cudaError_t launch_tc(const void* x, const float* dt, const float* A, const void* B,
                             const void* C, const float* D, void* y, float* state, long long xsb,
                             long long xst, long long bsb, long long bst, long long csb,
                             long long cst, int batch, int seq, int heads, cudaStream_t st) {
  constexpr size_t smem = TcSmem<P, N>::bytes;
  static_assert(smem <= 227 * 1024, "past the shared memory a CTA can take");
  static uint64_t ready = 0;                // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(ssd_kernel_tc<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_kernel_tc<P, N>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  // 16-byte vector loads where every row of x, B and C starts 16-byte aligned
  const int vec = aligned16(x) && aligned16(B) && aligned16(C) && xsb % 8 == 0 && xst % 8 == 0 &&
                  bsb % 8 == 0 && bst % 8 == 0 && csb % 8 == 0 && cst % 8 == 0;
  const long long grid = (long long)batch * ((heads + HG - 1) / HG);
  ssd_kernel_tc<P, N><<<(unsigned)grid, TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(B),
      static_cast<const __nv_bfloat16*>(C), D, static_cast<__nv_bfloat16*>(y), state, xsb, xst,
      bsb, bst, csb, cst, seq, heads, vec);
  return cudaGetLastError();
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
#define SSD_CASE(PP, NN)                                                                     \
  if (P == PP && N == NN) {                                                                  \
    if (dtype == DT_BF16)                                                                    \
      return (int)launch_tc<PP, NN>(x, dtf, Af, B, C, Df, y, sf, xsb, xst, bsb, bst, csb, cst, \
                                    batch, seq, heads, st);                                  \
    if (dtype == DT_F32)                                                                     \
      return (int)launch_f32<PP, NN>(x, dtf, Af, B, C, Df, y, sf, xsb, xst, bsb, bst, csb,   \
                                     cst, batch, seq, heads, st);                            \
  }
  SSD_CASE(32, 16)   // zamba2 reduced widths
  SSD_CASE(64, 64)   // zamba2-7b
#undef SSD_CASE
  return (int)cudaErrorInvalidValue;
}
