// Chunked WKV6 backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's backward is the AD of its
// recurrence oracle (repro/kernels/ops.py, "oracle-AD bwd"; _rwkv6_b), and
// the port ran autograd through its plain chunked version in its place.
// Per head (K = V = head dim), with log-decay ld_t <= 0, output gradient g_t
// and G_t = dL/dS_t carried backwards, G_{t-1} = diag(e^{ld_t}) G_t + r_t g_t^T:
//     dr_t = S_{t-1} g_t + (u * k_t)(v_t . g_t)
//     dk_t = G_t v_t + (u * r_t)(v_t . g_t)
//     dv_t = G_t^T k_t + (r_t . u * k_t) g_t
//     du   = sum_t r_t * k_t (v_t . g_t)
//     d ld_j = sum_{t>j} r_t * drI_t - sum_{s>=j} k_s * dkI_s
//            = W_j - k_j * dkI_j,  W_j = rowsum(G_j * S_j)
// with drI, dkI dr and dk without their u terms.  Over a chunk of 16 tokens
// with La_t the inclusive prefix of the log-decay, S0 the state before the
// chunk and Gc the state gradient after it (A[t,s] = g_t . v_s,
// E[t,s] = e^{La_{t-1} - La_s} for s < t):
//     drI_t = e^{La_{t-1}} (S0 g_t) + sum_{s<t} A[t,s] k_s E[t,s]
//     dkI_s = e^{La_c - La_s} (Gc v_s) + sum_{t>s} A[t,s] r_t E[t,s]
//     dv_s  = Gc^T (k_s e^{La_c - La_s}) + sum_{t>=s} P[t,s] g_t,
//             P[t,s] = sum_k r_tk k_sk E[t,s,k] (s < t), P[s,s] = r_s . u * k_s
//     G before the chunk = diag(e^{La_c}) Gc + sum_t (r_t e^{La_{t-1}}) g_t^T.
// No exponent is positive, so nothing overflows at any decay: P takes E
// pairwise, dr's and dk's pairs as running products of the steps' decays
// (each <= 1).  Everything is fp32 (the plain VJP's precision): products
// are scalar FMA, the exponentials ex2 of log2-unit prefix sums.  d ld's
// suffix sum starts each chunk from W at its end, the row sums of G * S
// there, and runs over 16 tokens only (carried across the whole sequence it
// put a thousandth of error on the small entries); du's sum over the
// sequence carries its rounding error (Kahan).
//
// Bound on the H100 at rwkv6-1.6b's training cell (B 8, T 1024, H 32, K 64,
// bf16): bytes.  r, k, v and g in bf16 and the fp32 log-decay are read
// (4 x 33.6 + 67 MB), dr, dk, dv in bf16 and d log-decay in fp32 written
// (101 + 67 MB): ~370 MB, 0.11 ms at 3.35 TB/s; the states before each chunk,
// written once and read back (2 x 268 MB at chunks of 16), add 0.16 ms.  The
// fp32 products are ~6 K^2 multiply-adds a token (the five chunk products
// and the forward walk), 13 GFLOP: 0.2 ms at 67 TFLOP/s of fp32 FMA, so a
// kernel that keeps every product in fp32 lands near twice the byte bound.
//
// What the design does about it: one CTA per (batch, head), 8 warps, two
// CTAs an SM.  A forward walk keeps the state in registers and writes it
// before each chunk to a scratch the wrapper allocates (S^T, 16 KB a chunk);
// the reverse walk reads it back with cp.async while a chunk stages.  In the
// reverse walk the four chunk products run side by side, a pair of warps
// each: dr (S0 g, then its pairs), dk (Gc v, then its pairs), dv (Gc^T kd,
// then P g) and the update of G into a second buffer.  A lane holds 8 rows
// (every second token, so the pairs split evenly over the pair) x K/32
// columns: one operand is a broadcast 16-byte read of the rows, the other a
// conflict-free read of the lane's columns, so shared memory feeds the FMAs.
// The pairs' dot products (A, P and the bonus) take a thread a pair.  The
// next chunk's inputs are fetched into registers while a chunk computes.
// du is a per-(batch, head) partial the wrapper sums: no atomics, the same
// gradient run to run.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BC = 16;               // tokens a chunk
constexpr int BNT = 256;             // threads a CTA: 8 warps, a pair a product
constexpr int TS = BC + 4;           // fp32 row of a transposed [K][BC] array (16-byte rows)
constexpr int AS = BC + 1;           // fp32 row of the pair matrices
static_assert(BC * BC == BNT, "a thread per (t, s) pair");

constexpr int al4(int x) { return (x + 3) & ~3; }

// rows t of a transposed array in slot order: the even tokens, then the odd,
// so warp half h reads its rows t = 2m + h (m < 8) as slots 8h..8h+7
__device__ __forceinline__ int slot(int t) { return (t & 1) * (BC / 2) + (t >> 1); }

template <int K>
struct BwdSmem {                                 // offsets in floats
  static constexpr int KP = K + 1;               // padded row: column reads conflict-free
  static constexpr int r = 0;                    // [BC][KP] r (forward walk: k e^{La_c - La_s})
  static constexpr int k = r + BC * KP;          // [BC][KP] k
  static constexpr int v = k + BC * KP;          // [BC][KP] v
  static constexpr int g = v + BC * KP;          // [BC][KP] output gradient
  static constexpr int la = g + BC * KP;         // [BC + 1][KP] row t + 1 = La_t (log2), row 0 = 0
  static constexpr int dri = la + (BC + 1) * KP; // [BC][KP] drI
  static constexpr int dki = dri + BC * KP;      // [BC][KP] dkI
  static constexpr int w = dki + BC * KP;        // [BC][KP] the steps' decays e^{ld_t}
  static constexpr int rq = al4(w + BC * KP);    // [BC][K] r e^{La_{t-1}} (forward walk: v)
  static constexpr int gt = rq + BC * K;         // [K][TS] g^T, slot order
  static constexpr int vt = gt + K * TS;         // [K][TS] v^T
  static constexpr int kdt = vt + K * TS;        // [K][TS] (k e^{La_c - La_s})^T
  static constexpr int s0t = kdt + K * TS;       // [K][K] S0^T, the cp.async target
  static constexpr int g0 = s0t + K * K;         // [K][KP] G, two buffers
  static constexpr int g1 = g0 + K * KP;
  static constexpr int a = g1 + K * KP;          // [BC][AS] A[t][s] = g_t . v_s
  static constexpr int p = a + BC * AS;          // [BC][AS] P[t][s], the bonus on the diagonal
  static constexpr int u = p + BC * AS;          // [K]
  static constexpr int ec = u + K;               // [K] e^{La_c} (forward walk)
  static constexpr int floats = ec + K;
  static constexpr size_t bytes = (size_t)floats * sizeof(float);
  static_assert(rq % 4 == 0 && gt % 4 == 0 && vt % 4 == 0 && kdt % 4 == 0 && s0t % 4 == 0,
                "16-byte rows");
};

struct Bwd {                                     // the CTA's shared arrays
  float *r, *k, *v, *g, *la, *dri, *dki, *w, *rq, *gt, *vt, *kdt, *s0t, *a, *p, *u, *ec;
};

// sum += x, the rounding error of each addition carried in err (Kahan)
__device__ __forceinline__ void kahan_add(float& sum, float& err, float x) {
  const float y = x - err, t = sum + y;
  err = (t - sum) - y;
  sum = t;
}

// rows 1..BC of a channel's column of La (stride K + 1) from its steps'
// log-decays to their inclusive prefix sums; returns the last (La_c)
template <int K>
__device__ __forceinline__ float prefix_sum(float* col) {
  float x[BC];
#pragma unroll
  for (int t = 0; t < BC; ++t) x[t] = col[(t + 1) * (K + 1)];
#pragma unroll
  for (int t = 1; t < BC; ++t) x[t] += x[t - 1];
#pragma unroll
  for (int t = 0; t < BC; ++t) col[(t + 1) * (K + 1)] = x[t];
  return x[BC - 1];
}

__device__ __forceinline__ void load8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w, x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

// dr of rows t = 2m + H: e^{La_{t-1}} (S0 g_t) then the pairs s < t
template <int K, int H>
__device__ __forceinline__ void chunk_dr(const Bwd& s, int lane, int t0, int seq, size_t base,
                                         size_t tok, bf16* __restrict__ dr) {
  constexpr int KP = K + 1, KL = K / 32;
  float acc[8][KL];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < KL; ++i) acc[m][i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    float x[8];
    load8(s.gt + j * TS + 8 * H, x);
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const float w = s.s0t[j * K + lane + 32 * i];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m][i] = fmaf(x[m], w, acc[m][i]);
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < KL; ++i) acc[m][i] *= hopper::ex2(s.la[(2 * m + H) * KP + lane + 32 * i]);
  // the pairs: E[t, s] = e^{La_{t-1} - La_s}, the product of the decays of
  // steps s+1..t-1 (each <= 1), built as s falls from t - 1 (a loop, not
  // unrolled: straight-line code run once a chunk waits on instruction fetch)
  float dec[8][KL];
#pragma unroll 1
  for (int sx = BC - 2; sx >= 0; --sx) {
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const int col = lane + 32 * i;
      const float ks = s.k[sx * KP + col], ws = s.w[(sx + 1) * KP + col];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        dec[m][i] = sx < 2 * m + H - 1 ? dec[m][i] * ws : 1.f;
        if (sx < 2 * m + H)
          acc[m][i] = fmaf(s.a[(2 * m + H) * AS + sx] * ks, dec[m][i], acc[m][i]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = 2 * m + H;
    const float d = s.a[t * AS + t];
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const int col = lane + 32 * i;
      s.dri[t * KP + col] = acc[m][i];
      if (t0 + t < seq)
        dr[base + (size_t)(t0 + t) * tok + col] =
            from_f32<bf16>(fmaf(s.u[col] * s.k[t * KP + col], d, acc[m][i]));
    }
  }
}

// dk of rows s = 2m + H: e^{La_c - La_s} (Gc v_s) then the pairs t > s
template <int K, int H>
__device__ __forceinline__ void chunk_dk(const Bwd& s, const float* gc, int lane, int t0, int seq,
                                         size_t base, size_t tok, bf16* __restrict__ dk) {
  constexpr int KP = K + 1, KL = K / 32;
  float acc[8][KL];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < KL; ++i) acc[m][i] = 0.f;
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    float x[8];
    load8(s.vt + j * TS + 8 * H, x);
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const float w = gc[(lane + 32 * i) * KP + j];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m][i] = fmaf(x[m], w, acc[m][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < KL; ++i) {
    const float le = s.la[BC * KP + lane + 32 * i];
#pragma unroll
    for (int m = 0; m < 8; ++m)
      acc[m][i] *= hopper::ex2(le - s.la[(2 * m + H + 1) * KP + lane + 32 * i]);
  }
  // the pairs: E[t, s] as the product of the decays of steps s+1..t-1, built
  // as t rises from s + 1
  float dec[8][KL];
#pragma unroll 1
  for (int tx = 1; tx < BC; ++tx) {
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const int col = lane + 32 * i;
      const float rt = s.r[tx * KP + col], wt = s.w[(tx - 1) * KP + col];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        dec[m][i] = tx > 2 * m + H + 1 ? dec[m][i] * wt : 1.f;
        if (tx > 2 * m + H)
          acc[m][i] = fmaf(s.a[tx * AS + 2 * m + H] * rt, dec[m][i], acc[m][i]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = 2 * m + H;
    const float d = s.a[t * AS + t];
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const int col = lane + 32 * i;
      s.dki[t * KP + col] = acc[m][i];
      if (t0 + t < seq)
        dk[base + (size_t)(t0 + t) * tok + col] =
            from_f32<bf16>(fmaf(s.u[col] * s.r[t * KP + col], d, acc[m][i]));
    }
  }
}

// dv of rows s = 2m + H: Gc^T kd_s then P[t, s] g_t over t >= s
template <int K, int H>
__device__ __forceinline__ void chunk_dv(const Bwd& s, const float* gc, int lane, int t0, int seq,
                                         size_t base, size_t tok, bf16* __restrict__ dv) {
  constexpr int KP = K + 1, KL = K / 32;
  float acc[8][KL];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int i = 0; i < KL; ++i) acc[m][i] = 0.f;
#pragma unroll 4
  for (int kx = 0; kx < K; ++kx) {
    float x[8];
    load8(s.kdt + kx * TS + 8 * H, x);
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const float w = gc[kx * KP + lane + 32 * i];
#pragma unroll
      for (int m = 0; m < 8; ++m) acc[m][i] = fmaf(x[m], w, acc[m][i]);
    }
  }
#pragma unroll 1
  for (int tx = 0; tx < BC; ++tx) {
#pragma unroll
    for (int i = 0; i < KL; ++i) {
      const float gv = s.g[tx * KP + lane + 32 * i];
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (tx >= 2 * m + H) acc[m][i] = fmaf(s.p[tx * AS + 2 * m + H], gv, acc[m][i]);
    }
  }
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    const int t = 2 * m + H;
    if (t0 + t < seq)
#pragma unroll
      for (int i = 0; i < KL; ++i)
        dv[base + (size_t)(t0 + t) * tok + lane + 32 * i] = from_f32<bf16>(acc[m][i]);
  }
}

// G before the chunk, rows k of half H: e^{La_c} Gc + sum_t rq_t g_t^T
template <int K, int H>
__device__ __forceinline__ void chunk_g(const Bwd& s, const float* gc, float* gn, int lane) {
  constexpr int KP = K + 1, KL = K / 32, KB = 16;
#pragma unroll 1
  for (int kb = H * K / 2; kb < (H + 1) * K / 2; kb += KB) {
    float acc[KB][KL];
#pragma unroll
    for (int q = 0; q < KB; ++q) {
      const float e = hopper::ex2(s.la[BC * KP + kb + q]);
#pragma unroll
      for (int i = 0; i < KL; ++i) acc[q][i] = e * gc[(kb + q) * KP + lane + 32 * i];
    }
#pragma unroll 2
    for (int t = 0; t < BC; ++t) {
      float x[KB];
#pragma unroll
      for (int q = 0; q < KB; q += 4) {
        const float4 a = *reinterpret_cast<const float4*>(s.rq + t * K + kb + q);
        x[q] = a.x, x[q + 1] = a.y, x[q + 2] = a.z, x[q + 3] = a.w;
      }
#pragma unroll
      for (int i = 0; i < KL; ++i) {
        const float gv = s.g[t * KP + lane + 32 * i];
#pragma unroll
        for (int q = 0; q < KB; ++q) acc[q][i] = fmaf(x[q], gv, acc[q][i]);
      }
    }
#pragma unroll
    for (int q = 0; q < KB; ++q)
#pragma unroll
      for (int i = 0; i < KL; ++i) gn[(kb + q) * KP + lane + 32 * i] = acc[q][i];
  }
}

template <int K>
__global__ void __launch_bounds__(BNT, 2)
wkv6_bwd_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const float* __restrict__ lw, const float* __restrict__ u,
                const bf16* __restrict__ g, bf16* __restrict__ dr, bf16* __restrict__ dk,
                bf16* __restrict__ dv, float* __restrict__ dlw, float* __restrict__ du,
                float* __restrict__ states, int seq, int heads) {
  using L = BwdSmem<K>;
  constexpr int KP = L::KP;
  constexpr int NE = BC * K / BNT;               // elements of each input a thread stages
  constexpr int JPT = K * K / BNT;               // forward walk: state columns a thread holds
  static_assert(NE * BNT == BC * K && JPT * BNT == K * K && JPT % 4 == 0, "K in {32, 64}");
  extern __shared__ __align__(16) float smem[];
  const Bwd s{smem + L::r,   smem + L::k,   smem + L::v,   smem + L::g,  smem + L::la,
              smem + L::dri, smem + L::dki, smem + L::w,   smem + L::rq, smem + L::gt,
              smem + L::vt,  smem + L::kdt, smem + L::s0t, smem + L::a,  smem + L::p,
              smem + L::u,   smem + L::ec};
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const size_t tok = (size_t)heads * K;
  const size_t base = ((size_t)b * seq * heads + h) * K;
  const int n = (seq + BC - 1) / BC;
  float* st = states + (size_t)bh * n * K * K;   // S^T before each chunk

  for (int i = tid; i < K; i += BNT) {
    s.u[i] = u[(size_t)h * K + i];
    s.la[i] = 0.f;                               // La_{-1}
  }

  // a chunk's inputs, fetched into registers a chunk ahead (rows past the
  // sequence: zeros, decay 1)
  bf16 pr[NE], pk[NE], pv[NE], pg[NE];
  float pl[NE];
  auto fetch = [&](int c, bool rg) {
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = tid + q * BNT, t = e / K, kk = e % K;
      const bool in = c * BC + t < seq;
      const size_t gi = base + (size_t)(c * BC + t) * tok + kk;
      if (rg) {
        pr[q] = in ? r[gi] : from_f32<bf16>(0.f);
        pg[q] = in ? g[gi] : from_f32<bf16>(0.f);
      }
      pk[q] = in ? k[gi] : from_f32<bf16>(0.f);
      pv[q] = in ? v[gi] : from_f32<bf16>(0.f);
      pl[q] = in ? lw[gi] : 0.f;
    }
  };

  // ---- forward walk: S (as S^T, a thread's JPT rows j of channel kc) in
  // registers, written to the scratch before each chunk
  {
    const int kc = tid % K, j0 = (tid / K) * JPT;
    float sv[JPT];
#pragma unroll
    for (int q = 0; q < JPT; ++q) sv[q] = 0.f;
    fetch(0, false);
    for (int c = 0; c < n; ++c) {
      float* dst = st + (size_t)c * K * K;
#pragma unroll
      for (int q = 0; q < JPT; ++q) dst[(j0 + q) * K + kc] = sv[q];
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        const int e = tid + q * BNT, t = e / K, kk = e % K;
        s.k[t * KP + kk] = to_f32(pk[q]);
        s.rq[t * K + kk] = to_f32(pv[q]);
        s.la[(t + 1) * KP + kk] = pl[q] * hopper::LOG2E;
      }
      if (c + 1 < n) fetch(c + 1, false);
      __syncthreads();
      if (tid < K) {
        const float acc = prefix_sum<K>(s.la + tid);
#pragma unroll
        for (int t = 0; t < BC; ++t)
          s.r[t * KP + tid] = s.k[t * KP + tid] * hopper::ex2(acc - s.la[(t + 1) * KP + tid]);
        s.ec[tid] = hopper::ex2(acc);
      }
      __syncthreads();
      const float e = s.ec[kc];
#pragma unroll
      for (int q = 0; q < JPT; ++q) sv[q] *= e;
#pragma unroll 4
      for (int t = 0; t < BC; ++t) {
        const float kd = s.r[t * KP + kc];
#pragma unroll
        for (int q = 0; q < JPT; q += 4) {
          const float4 x = *reinterpret_cast<const float4*>(s.rq + t * K + j0 + q);
          sv[q] = fmaf(kd, x.x, sv[q]);
          sv[q + 1] = fmaf(kd, x.y, sv[q + 1]);
          sv[q + 2] = fmaf(kd, x.z, sv[q + 2]);
          sv[q + 3] = fmaf(kd, x.w, sv[q + 3]);
        }
      }
      __syncthreads();
    }
  }

  // ---- reverse walk
  const int prod = warp >> 1, half = warp & 1;
  float* gc = smem + L::g0;                      // G after the chunk
  float* gn = smem + L::g1;                      // G before it
  for (int i = tid; i < K * KP; i += BNT) gc[i] = 0.f;
  fetch(n - 1, true);
  // threads tid < K, channel tid: W after the chunk (the row sum of G * S
  // there) and du, the latter with its rounding error carried (Kahan: it
  // sums over the whole sequence)
  float wend = 0.f, duacc = 0.f, duerr = 0.f;
  for (int c = n - 1; c >= 0; --c) {
    const int t0 = c * BC;
    // A: S0^T of the chunk on its way (cp.async, waited for before D); stage
    // the chunk, then fetch the one before it
    {
      const float* src = st + (size_t)c * K * K;
#pragma unroll
      for (int q = 0; q < K * K / 4 / BNT; ++q) {
        const int i = tid + BNT * q;
        hopper::cp_async16(hopper::smem_u32(s.s0t + 4 * i), src + 4 * i, true);
      }
      hopper::cp_async_commit();
    }
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int e = tid + q * BNT, t = e / K, kk = e % K;
      const float vv = to_f32(pv[q]), gv = to_f32(pg[q]);
      s.r[t * KP + kk] = to_f32(pr[q]);
      s.k[t * KP + kk] = to_f32(pk[q]);
      s.v[t * KP + kk] = vv;
      s.g[t * KP + kk] = gv;
      s.la[(t + 1) * KP + kk] = pl[q] * hopper::LOG2E;
      s.w[t * KP + kk] = hopper::ex2(pl[q] * hopper::LOG2E);
      s.vt[kk * TS + slot(t)] = vv;
      s.gt[kk * TS + slot(t)] = gv;
    }
    if (c > 0) fetch(c - 1, true);
    __syncthreads();
    // B: La, one channel a thread
    if (tid < K) prefix_sum<K>(s.la + tid);
    __syncthreads();
    // C: a thread a pair (t, s <= t): A, and P or the bonus; then
    // rq = r e^{La_{t-1}} and kd^T = (k e^{La_c - La_s})^T
    {
      const int t = tid / BC, sx = tid % BC;
      if (sx <= t) {
        float a = 0.f, p = 0.f;
        const float *gr = s.g + t * KP, *vr = s.v + sx * KP;
#pragma unroll 8
        for (int j = 0; j < K; ++j) a = fmaf(gr[j], vr[j], a);
        const float *rr = s.r + t * KP, *kr = s.k + sx * KP;
        if (sx < t) {
          const float *lt = s.la + t * KP, *ls = s.la + (sx + 1) * KP;
#pragma unroll 8
          for (int j = 0; j < K; ++j) p = fmaf(rr[j] * kr[j], hopper::ex2(lt[j] - ls[j]), p);
        } else {
#pragma unroll 8
          for (int j = 0; j < K; ++j) p = fmaf(rr[j] * s.u[j], kr[j], p);
        }
        s.a[t * AS + sx] = a;
        s.p[t * AS + sx] = p;
      }
#pragma unroll
      for (int q = 0; q < NE; ++q) {
        const int e = tid + q * BNT, tq = e / K, kk = e % K;
        s.rq[tq * K + kk] = s.r[tq * KP + kk] * hopper::ex2(s.la[tq * KP + kk]);
        s.kdt[kk * TS + slot(tq)] =
            s.k[tq * KP + kk] * hopper::ex2(s.la[BC * KP + kk] - s.la[(tq + 1) * KP + kk]);
      }
    }
    hopper::cp_async_wait<0>();                   // this chunk's S0^T
    __syncthreads();
    // D: the four products, a pair of warps each
    if (prod == 0) {
      if (half) chunk_dr<K, 1>(s, lane, t0, seq, base, tok, dr);
      else chunk_dr<K, 0>(s, lane, t0, seq, base, tok, dr);
    } else if (prod == 1) {
      if (half) chunk_dk<K, 1>(s, gc, lane, t0, seq, base, tok, dk);
      else chunk_dk<K, 0>(s, gc, lane, t0, seq, base, tok, dk);
    } else if (prod == 2) {
      if (half) chunk_dv<K, 1>(s, gc, lane, t0, seq, base, tok, dv);
      else chunk_dv<K, 0>(s, gc, lane, t0, seq, base, tok, dv);
    } else {
      if (half) chunk_g<K, 1>(s, gc, gn, lane);
      else chunk_g<K, 0>(s, gc, gn, lane);
    }
    __syncthreads();
    // E: d log-decay over the chunk's rows, last to first: d ld_j = W_j -
    // k_j dkI_j, W_j = W_end + sum_{t>j} (r_t drI_t - k_t dkI_t) inside the
    // chunk; du; then W_end of the chunk before, the row sums of G * S0 at
    // this chunk's start (both still in shared memory)
    if (tid < K) {
      float z = wend;
#pragma unroll
      for (int t = BC - 1; t >= 0; --t) {
        const float kq = s.k[t * KP + tid], rt = s.r[t * KP + tid];
        const float y = kq * s.dki[t * KP + tid];
        if (t0 + t < seq) dlw[base + (size_t)(t0 + t) * tok + tid] = z - y;
        z += fmaf(rt, s.dri[t * KP + tid], -y);
        kahan_add(duacc, duerr, rt * kq * s.a[t * AS + t]);
      }
      if (c > 0) {
        float w4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int j = 0; j < K; ++j)
          w4[j & 3] = fmaf(gn[tid * KP + j], s.s0t[j * K + tid], w4[j & 3]);
        wend = (w4[0] + w4[1]) + (w4[2] + w4[3]);
      }
    }
    float* tmp = gc;
    gc = gn;
    gn = tmp;
    __syncthreads();
  }
  if (tid < K) du[(size_t)bh * K + tid] = duacc;
}

template <int K>
cudaError_t launch(const void* r, const void* k, const void* v, const float* lw, const float* u,
                   const void* g, void* dr, void* dk, void* dv, float* dlw, float* du,
                   float* states, int batch, int seq, int heads, cudaStream_t st) {
  constexpr size_t smem = BwdSmem<K>::bytes;
  static_assert(2 * (smem + 1024) <= 228 * 1024, "two CTAs an SM");
  static uint64_t ready = 0;                     // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(wkv6_bwd_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wkv6_bwd_kernel<K>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  wkv6_bwd_kernel<K><<<(unsigned)((long long)batch * heads), BNT, smem, st>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      lw, u, static_cast<const bf16*>(g), static_cast<bf16*>(dr), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), dlw, du, states, seq, heads);
  return cudaGetLastError();
}

}  // namespace

// r/k/v/g/dr/dk/dv (B, T, H, K) contiguous bfloat16; log_w and dlog_w
// (B, T, H, K), u (H, K) contiguous float32; du (B, H, K) float32, a partial
// per (batch, head); states (B, H, ceil(T / 16), K, K) float32 scratch.
extern "C" int rwkv6_bwd(const void* r, const void* k, const void* v, const void* log_w,
                         const void* u, const void* g, void* dr, void* dk, void* dv,
                         void* dlog_w, void* du, void* states, int batch, int seq, int heads,
                         int dk_, void* stream) {
  if (batch <= 0 || seq <= 0 || heads <= 0 || (long long)batch * heads > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dk_ != 32 && dk_ != 64) return (int)cudaErrorInvalidValue;
  return (int)(dk_ == 32 ? launch<32> : launch<64>)(
      r, k, v, static_cast<const float*>(log_w), static_cast<const float*>(u), g, dr, dk, dv,
      static_cast<float*>(dlog_w), static_cast<float*>(du), static_cast<float*>(states), batch,
      seq, heads, static_cast<cudaStream_t>(stream));
}
