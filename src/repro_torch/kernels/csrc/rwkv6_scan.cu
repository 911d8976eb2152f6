// Chunked WKV6 forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_chunked_fwd
// (_rwkv_kernel).  Per head (K = V = head dim), with log-decay ld_t <= 0:
//     out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(e^{ld_t}) S_{t-1} + k_t v_t^T.
// Over a chunk with inclusive prefix sums La_t = sum_{i<=t} ld_i (and
// La_{-1} = 0), from the state S_0 before the chunk:
//     out_t = (r_t * e^{La_{t-1}}) S_0                                (inter)
//           + sum_{s<t} [sum_k r_tk k_sk e^{La_{t-1,k} - La_{s,k}}] v_s   (intra)
//           + (r_t * u * k_t) . v_t                                   (bonus)
//     S_c   = diag(e^{La_c}) S_0 + sum_s (k_s * e^{La_c - La_s}) v_s^T.
// No exponent is ever positive, so no factor can overflow; the TPU kernel's
// k * e^{-La} factorisation returns inf once a chunk's log-decay sum passes
// about -88 (a per-step log-decay of -1.5 over its 64 tokens).
//
// Bound on the H100 at rwkv6-1.6b's training shape (B 8, T 512, H 32, K 64,
// bf16): bytes.  r, k, v and out in bf16 are 67 MB and the fp32 log-decay
// 34 MB: ~101 MB, 0.030 ms at 3.35 TB/s.  The chunk products are ~2.5 GFLOP,
// 0.003 ms on bf16 tensor cores but 0.038 ms as fp32 FMA.
//
// bf16 body (rwkv6_kernel_tc; the training steps): a CTA per (batch, head)
// walks chunks of 64 tokens in four sub-blocks of 16, with 8 warps: warp w
// takes the out rows of sub-block w % 4 for half w / 4 of V (out[:, j] and
// S[:, j] depend only on v[:, j]).  The score work that both halves need
// -- staging, the prefix sums, the pairs inside the sub-blocks, the decayed
// k of the update -- is done once a CTA and shared in shared memory, so 256
// CTAs of 8 warps fill the card two to an SM without recomputing it.  On
// mma.sync m16n8k16 (bf16 in, fp32 out):
// * pairs in different sub-blocks: the reference point is the row before
//   sub-block w's (ref = 16w - 1, between s and t - 1), so P[t, s] =
//   (r_t e^{La_{t-1} - La_ref}) . (k_s e^{La_ref - La_s}) with both factors
//   <= 1, for all s < 16w at once;
// * pairs across the two 8-token halves of a sub-block: the same with the
//   reference point La_{16w+7} between them;
// * the inter term (r_t e^{La_{t-1}}) S_0, with e^{La_{t-1}} = e^{La_{t-1} -
//   La_ref} e^{La_ref}, two factors <= 1;
// * P.v (P's A fragments from the score accumulators) and the state update
//   S^T = e^{La_c} S^T + v^T (k e^{La_c - La_s}), each warp's tiles of S^T
//   in registers in fp32 across the chunks and their hi + lo copy in shared
//   memory for the next chunk's inter term.
// The pairs inside an 8-token half and the u bonus stay pairwise: a lane
// takes two channels of a half's 36 entries, e^{La_{t-1} - La_s} is the
// running product of the steps' decays between s and t (each <= 1), and a
// reduce-scatter over the warp sums the channels.  r, k and v are exact in
// bf16; the decay-scaled operands, P and the state are not, so each is
// split into hi + lo bf16 terms (a product of two split operands takes
// hi.hi + hi.lo + lo.hi).  The inter term splits both of its operands
// into hi + mid + lo (24 bits, fp32's) and takes the six products of order
// below three: the state grows to ~1e4 over a sequence of a trained model
// while an out row of it cancels to O(1), and hi + lo (16 bits) put such
// rows 1.32x past the bf16 gate against the plain version in rwkv6-1.6b's
// eleventh training step (chip_smoke.py, train_pp); three terms keep them
// to bf16's rounding.  The prefix sums run in fp32 in log2 units (every
// exponential is one ex2).  out leaves through shared memory in 16-byte
// vectors.  What it does about the bound: every chunk product is on tensor
// cores and no score work is repeated; what remains is issue (the splits,
// the exponentials, address arithmetic) and the barriers of a chunk walk.
//
// fp32 body (rwkv6_kernel; the fp32 parity runs): one CTA per (batch, head),
// chunks of 16 with the (K, K) fp32 state in shared memory, a thread a
// score pair and scalar fp32 FMA, so the fp32 route keeps fp32 products.
#include "common.cuh"
#include "hopper.cuh"


// ---- the fp32 body: one CTA per (batch, head), scalar FMA ---------------------

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


// ---- the bf16 body: V halves, sub-blocks, mma.sync -------------------------------

constexpr int TC_CH = 64;                 // tokens per chunk (the TPU kernel's DEFAULT_CHUNK)
constexpr int SB = 16;                    // sub-block: rows 16 sb..16 sb + 15
constexpr int NSB = TC_CH / SB;           // sub-blocks a chunk
constexpr int VSPLIT = 2;                 // slices of V: warp w takes sub-block w % 4, slice w / 4
constexpr int TC_WARPS = NSB * VSPLIT;
constexpr int TC_THREADS = 32 * TC_WARPS;

template <int K>
struct TcSmem {
  static constexpr int VS = K / VSPLIT;   // columns of V a warp takes
  static constexpr int LS = K + 8;        // fp32 row of La (float2 reads: no conflicts)
  static constexpr int BS = K + 8;        // bf16 row of r, k and S^T (ldmatrix: no conflicts)
  static constexpr int PS = SB + 8;       // fp32 row of the diagonal blocks' scores
  static constexpr int NSEG = TC_THREADS / K;          // prefix segments a channel
  static constexpr size_t la = 0;                      // float [CH + 1][LS]: row t+1 = La_t, row 0 = 0
  static constexpr size_t shi = la + 4 * (TC_CH + 1) * LS;  // bf16 [K][BS]: S^T, hi
  static constexpr size_t smid = shi + 2 * K * BS;          // mid
  static constexpr size_t slo = smid + 2 * K * BS;          // and lo
  static constexpr size_t pd = slo + 2 * K * BS;            // float [CH][PS]
  static constexpr size_t u = pd + 4 * TC_CH * PS;          // float [K]
  static constexpr size_t seg = u + 4 * K;                  // float [NSEG][K]: segment totals
  static constexpr size_t r = seg + 4 * NSEG * K;           // bf16 [CH][BS]: r, then kd hi
  static constexpr size_t k = r + 2 * TC_CH * BS;           // k, then kd lo
  static constexpr size_t v = k + 2 * TC_CH * BS;           // bf16 [CH][BS]
  static constexpr size_t o = v + 2 * TC_CH * BS;           // bf16 [CH][BS]: the chunk's out
  static constexpr size_t raw = o + 2 * TC_CH * BS;         // float [CH][K]: the next log-decay
  static constexpr size_t bytes = raw + 4 * TC_CH * K;
  static_assert(shi % 16 == 0 && smid % 16 == 0 && slo % 16 == 0 && pd % 16 == 0 && r % 16 == 0 && k % 16 == 0 &&
                v % 16 == 0 && o % 16 == 0 && raw % 16 == 0, "16-byte rows");
};

__device__ __forceinline__ float2 f2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ uint32_t u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// x and y as hi + mid + lo bf16 pairs: 24 bits, fp32's precision
__device__ __forceinline__ void split3_bf16(float x, float y, uint32_t& hi, uint32_t& mid,
                                            uint32_t& lo) {
  hi = hopper::pack_bf16(x, y);
  const float2 h = hopper::unpack_bf16(hi);
  hopper::split_bf16(x - h.x, y - h.y, mid, lo);
}

// one step of a reduce-scatter over the warp: lanes whose bit O is clear
// keep entries [0, O) and receive the partner's, the others keep [O, 2O)
// (moved down to [0, O)); after the steps 16, 8, 4, 2, 1 lane l holds the
// warp's sum of entry l
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float* e, int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = up ? e[j] : e[j + O], keep = up ? e[j + O] : e[j];
    e[j] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <int K>
__global__ void __launch_bounds__(TC_THREADS, 2)
rwkv6_kernel_tc(const __nv_bfloat16* __restrict__ r, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u, __nv_bfloat16* __restrict__ out, int seq, int heads,
                int vec) {
  using namespace hopper;
  using L = TcSmem<K>;
  constexpr int VS = L::VS, LS = L::LS, BS = L::BS, PS = L::PS, NSEG = L::NSEG;
  constexpr int KK = K / 16;                // k-steps over the channels
  constexpr int NV = VS / 8;                // n-tiles over a warp's V columns
  constexpr int NSC = 2 * (NSB - 1);        // score n-tiles of the last sub-block
  constexpr int SEGLEN = TC_CH / NSEG;
  constexpr int CPL = K / 32;               // channels a lane takes in the diagonal pairs
  // the state update: S^T tiles (K / 16 row tiles x K / 8 column tiles) over the warps
  constexpr int MT = K / 16, NPW = (K / 8) * MT / TC_WARPS;
  static_assert(NSEG * K == TC_THREADS && VS % 16 == 0 && NPW >= 1 && CPL >= 1 &&
                TC_WARPS == 2 * NSB, "K in {32, 64}; a warp per (sub-block, half) in C");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* sLa = reinterpret_cast<float*>(tc_smem + L::la);
  __nv_bfloat16* sShi = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::shi);
  __nv_bfloat16* sSmid = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::smid);
  __nv_bfloat16* sSlo = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::slo);
  float* sPd = reinterpret_cast<float*>(tc_smem + L::pd);
  float* su = reinterpret_cast<float*>(tc_smem + L::u);
  float* sSeg = reinterpret_cast<float*>(tc_smem + L::seg);
  __nv_bfloat16* sR = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::r);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::k);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::v);
  __nv_bfloat16* sO = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::o);
  float* sRaw = reinterpret_cast<float*>(tc_smem + L::raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int b = blockIdx.x / heads, h = blockIdx.x % heads;
  const int sb = warp % NSB, j0 = (warp / NSB) * VS;   // this warp's sub-block and V columns
  const size_t tok = (size_t)heads * K;
  const size_t base = ((size_t)b * seq * heads + h) * K;
  const int t0 = SB * sb, r0 = t0 + g, r1 = r0 + 8;
  const uint32_t aV = smem_u32(sV), aR = smem_u32(sR), aK = smem_u32(sK);
  const uint32_t aShi = smem_u32(sShi), aSmid = smem_u32(sSmid), aSlo = smem_u32(sSlo);
  // this warp's tiles of S^T in fp32, kept in registers across the chunks:
  // rows j 16 mt.., columns (channels) 8 (nt0 + n)..
  const int mt = warp % MT, nt0 = (warp / MT) * NPW;
  float st[NPW][4];
#pragma unroll
  for (int n = 0; n < NPW; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;

  for (int i = tid; i < K * BS; i += TC_THREADS)
    sShi[i] = sSmid[i] = sSlo[i] = __float2bfloat16(0.f);
  for (int i = tid; i < K; i += TC_THREADS) {
    su[i] = u[(size_t)h * K + i];
    sLa[i] = 0.f;                           // La_{-1}
  }

  // a chunk's log-decay (its largest input), cp.async into sRaw a chunk
  // ahead: it lands while the chunk before computes
  constexpr int VL = K / 4, NL = TC_CH * VL / TC_THREADS;   // 16-byte vectors
  static_assert(NL * TC_THREADS == TC_CH * VL, "whole vectors");
  auto issue_lw = [&](int cn) {
    const int rn = min(TC_CH, seq - cn);
#pragma unroll
    for (int q = 0; q < NL; ++q) {
      const int i = tid + q * TC_THREADS, t = i / VL;
      const bool rd = t < rn;
      cp_async16(smem_u32(sRaw + 4 * i),
                 rd ? lw + base + (size_t)(cn + t) * tok + 4 * (i % VL) : lw, rd);
    }
    cp_async_commit();
  };
  if (vec) issue_lw(0);

  for (int c0 = 0; c0 < seq; c0 += TC_CH) {
    const int rows = min(TC_CH, seq - c0);
    // A: stage r, k and v (rows past the sequence: zeros); the log-decay is
    // in sRaw (zeros past the sequence: decay 1)
    if (vec) {
      constexpr int VB = K / 8, NB = TC_CH * VB / TC_THREADS;   // 16-byte vectors a row
      static_assert(NB * TC_THREADS == TC_CH * VB, "whole vectors");
      uint4 br[NB], bk[NB], bv[NB];
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int i = tid + q * TC_THREADS, t = i / VB;
        const size_t off = base + (size_t)(c0 + t) * tok + 8 * (i % VB);
        const bool in = t < rows;
        br[q] = in ? *reinterpret_cast<const uint4*>(r + off) : make_uint4(0, 0, 0, 0);
        bk[q] = in ? *reinterpret_cast<const uint4*>(k + off) : make_uint4(0, 0, 0, 0);
        bv[q] = in ? *reinterpret_cast<const uint4*>(v + off) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int i = tid + q * TC_THREADS, o = (i / VB) * BS + 8 * (i % VB);
        *reinterpret_cast<uint4*>(sR + o) = br[q];
        *reinterpret_cast<uint4*>(sK + o) = bk[q];
        *reinterpret_cast<uint4*>(sV + o) = bv[q];
      }
      cp_async_wait<0>();
    } else {
      const __nv_bfloat16 zero = __float2bfloat16(0.f);
      for (int i = tid; i < TC_CH * K; i += TC_THREADS) {
        const int t = i / K, kk = i % K;
        const size_t gi = base + (size_t)(c0 + t) * tok + kk;
        const bool in = t < rows;
        sR[t * BS + kk] = in ? r[gi] : zero;
        sK[t * BS + kk] = in ? k[gi] : zero;
        sRaw[t * K + kk] = in ? lw[gi] : 0.f;
        sV[t * BS + kk] = in ? v[gi] : zero;
      }
    }
    __syncthreads();
    // B: La = inclusive prefix of the log-decay along the chunk, in log2
    // units (every use is an exponential: ex2), each channel in NSEG segments
    // (a thread a segment, its rows read at once), then the segments' offsets
    {
      const int kk = tid % K, q = tid / K;
      float* col = sLa + (1 + q * SEGLEN) * LS + kk;
      const float* in = sRaw + q * SEGLEN * K + kk;
      float x[SEGLEN];
#pragma unroll
      for (int t = 0; t < SEGLEN; ++t) x[t] = in[t * K] * LOG2E;   // log2 units: 2^x = e^ld
#pragma unroll
      for (int t = 1; t < SEGLEN; ++t) x[t] += x[t - 1];
#pragma unroll
      for (int t = 0; t < SEGLEN; ++t) col[t * LS] = x[t];
      sSeg[q * K + kk] = x[SEGLEN - 1];
    }
    __syncthreads();
    if (vec && c0 + TC_CH < seq) issue_lw(c0 + TC_CH);
    for (int i = tid; i < (TC_CH - SEGLEN) * K; i += TC_THREADS) {
      const int t = SEGLEN + i / K, kk = i % K;
      float off = 0.f;
      for (int q = 0; q < t / SEGLEN; ++q) off += sSeg[q * K + kk];
      sLa[(t + 1) * LS + kk] += off;
    }
    __syncthreads();

    // C: the pairs of this warp's sub-block that share an 8-token half,
    // pairwise: P[t, s] = sum_k r_tk k_sk e^{La_{t-1,k} - La_{s,k}} for s < t
    // and the bonus sum_k r_tk u_k k_tk for s = t.  A lane takes CPL
    // channels of all 36 entries of a half; e^{La_{t-1} - La_s} is the
    // running product of the steps' decays e^{ld_i}, s < i < t, each <= 1, so
    // no exponent is positive and no pair needs one of its own.  A
    // reduce-scatter over the lanes then sums each entry.  (The pairs across
    // the two halves go through the tensor cores in D.)
    {
      const int hf = warp & 1, tb = SB * (warp >> 1) + 8 * hf, ch = CPL * lane;
      float rr[8][CPL], kv[8][CPL], dec[8][CPL], uu[CPL];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (CPL == 2) {
          const float2 rv = unpack_bf16(u32(sR + (tb + i) * BS + ch));
          const float2 kx = unpack_bf16(u32(sK + (tb + i) * BS + ch));
          const float2 la = f2(sLa + (tb + i + 1) * LS + ch), lp = f2(sLa + (tb + i) * LS + ch);
          rr[i][0] = rv.x;
          rr[i][1] = rv.y;
          kv[i][0] = kx.x;
          kv[i][1] = kx.y;
          dec[i][0] = ex2(la.x - lp.x);
          dec[i][1] = ex2(la.y - lp.y);
        } else {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            rr[i][j] = __bfloat162float(sR[(tb + i) * BS + ch + j]);
            kv[i][j] = __bfloat162float(sK[(tb + i) * BS + ch + j]);
            dec[i][j] = ex2(sLa[(tb + i + 1) * LS + ch + j] - sLa[(tb + i) * LS + ch + j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < CPL; ++j) uu[j] = su[ch + j];
      float e[36];                            // entry (t, s <= t) at t (t + 1) / 2 + s
#pragma unroll
      for (int sl = 0; sl < 8; ++sl) {
        float d[CPL];
        e[sl * (sl + 1) / 2 + sl] = 0.f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          e[sl * (sl + 1) / 2 + sl] += rr[sl][j] * uu[j] * kv[sl][j];
          d[j] = 1.f;
        }
#pragma unroll
        for (int tl = sl + 1; tl < 8; ++tl) {
          float a = 0.f;
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            if (tl > sl + 1) d[j] *= dec[tl - 1][j];
            a += rr[tl][j] * kv[sl][j] * d[j];
          }
          e[tl * (tl + 1) / 2 + sl] = a;
        }
      }
      // entries 0..31: lane l ends with the sum of entry l; 32..35: every lane
      reduce_scatter_step<16>(e, lane);
      reduce_scatter_step<8>(e, lane);
      reduce_scatter_step<4>(e, lane);
      reduce_scatter_step<2>(e, lane);
      reduce_scatter_step<1>(e, lane);
#pragma unroll
      for (int j = 32; j < 36; ++j) {
        e[j] += __shfl_xor_sync(0xffffffffu, e[j], 16);
        e[j] += __shfl_xor_sync(0xffffffffu, e[j], 8);
        e[j] += __shfl_xor_sync(0xffffffffu, e[j], 4);
        e[j] += __shfl_xor_sync(0xffffffffu, e[j], 2);
        e[j] += __shfl_xor_sync(0xffffffffu, e[j], 1);
      }
      {
        int tl = 0;
        while ((tl + 1) * (tl + 2) / 2 <= lane) ++tl;
        sPd[(tb + tl) * PS + 8 * hf + lane - tl * (tl + 1) / 2] = e[0];
      }
      if (lane < 4) {
        const float last = lane == 0 ? e[32] : lane == 1 ? e[33] : lane == 2 ? e[34] : e[35];
        sPd[(tb + 7) * PS + 8 * hf + 4 + lane] = last;      // entries (7, 4..7)
      }
    }
    __syncthreads();

    // D: out for this warp's sub-block
    {
      const float* lref = sLa + t0 * LS;       // La_ref = La_{16w - 1}
      float acc[NV][4];
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      float sc[NSC][4];                         // P[t, s] for s < 16w
#pragma unroll
      for (int j = 0; j < NSC; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      // the pairs across the two 8-token halves of this sub-block, t in the
      // upper and s in the lower: reference point La_{16w+7}, between them
      const float* lmid = sLa + (t0 + 8) * LS;
      float xc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 0; kq < KK; ++kq) {
        // A fragments: rt = r_t e^{La_{t-1} - La_ref}, hi + lo, and rq = rt e^{La_ref},
        // hi + mid + lo
        uint32_t th[4], tl_[4], qh[4], qm[4], ql[4];
        float2 er[2];                           // e^{La_ref} at columns 2c.. and 2c+8..
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 lr = f2(lref + 16 * kq + 2 * c + 8 * i);
          er[i] = make_float2(ex2(lr.x), ex2(lr.y));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i & 1 ? r1 : r0, col = 16 * kq + 2 * c + (i >> 1) * 8;
          const float2 rv = unpack_bf16(u32(sR + row * BS + col));
          const float2 lp = f2(sLa + row * LS + col), lr = f2(lref + col);
          const float ex = rv.x * ex2(lp.x - lr.x), ey = rv.y * ex2(lp.y - lr.y);
          split_bf16(ex, ey, th[i], tl_[i]);
          split3_bf16(ex * er[i >> 1].x, ey * er[i >> 1].y, qh[i], qm[i], ql[i]);
        }
        {
          // cross block: rows r1 (t = 16w + 8 + g) against s = 16w + g
          uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
          uint32_t b0h, b0l, b1h, b1l;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int col = 16 * kq + 2 * c + 8 * i;
            const float2 rv = unpack_bf16(u32(sR + r1 * BS + col));
            const float2 lp = f2(sLa + r1 * LS + col), lm = f2(lmid + col);
            split_bf16(rv.x * ex2(lp.x - lm.x), rv.y * ex2(lp.y - lm.y), ah[1 + 2 * i],
                       al[1 + 2 * i]);
            const float2 kv = unpack_bf16(u32(sK + r0 * BS + col));
            const float2 ls = f2(sLa + (r0 + 1) * LS + col);
            split_bf16(kv.x * ex2(lm.x - ls.x), kv.y * ex2(lm.y - ls.y), i ? b1h : b0h,
                       i ? b1l : b0l);
          }
          mma_bf16(xc, ah, b0h, b1h);
          mma_bf16(xc, ah, b0l, b1l);
          mma_bf16(xc, al, b0h, b1h);
        }
        // inter: rq . S0, S0^T hi, mid and lo rows j as B fragments by
        // ldmatrix, one at a time; the products of order below three (the
        // smallest first)
#pragma unroll
        for (int jq = 0; jq < NV / 2; ++jq) {
          const uint32_t off = ((j0 + 16 * jq + (lane >> 4) * 8 + (lane & 7)) * BS + 16 * kq +
                                ((lane >> 3) & 1) * 8) * 2;
          uint32_t bf[4];
          ldmatrix_x4(bf, aSlo + off);
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_bf16(acc[2 * jq + n], qh, bf[2 * n], bf[2 * n + 1]);
          ldmatrix_x4(bf, aSmid + off);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[2 * jq + n], qm, bf[2 * n], bf[2 * n + 1]);
            mma_bf16(acc[2 * jq + n], qh, bf[2 * n], bf[2 * n + 1]);
          }
          ldmatrix_x4(bf, aShi + off);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(acc[2 * jq + n], ql, bf[2 * n], bf[2 * n + 1]);
            mma_bf16(acc[2 * jq + n], qm, bf[2 * n], bf[2 * n + 1]);
            mma_bf16(acc[2 * jq + n], qh, bf[2 * n], bf[2 * n + 1]);
          }
        }
        // scores against the earlier sub-blocks: k_s e^{La_ref - La_s}, hi + lo
#pragma unroll
        for (int j = 0; j < NSC; ++j) {
          if (j >= 2 * sb) continue;
          const int s = 8 * j + g, col = 16 * kq + 2 * c;
          const float* ls = sLa + (s + 1) * LS + col;
          const float2 k0 = unpack_bf16(u32(sK + s * BS + col));
          const float2 k1 = unpack_bf16(u32(sK + s * BS + col + 8));
          const float2 l0 = f2(ls), l1 = f2(ls + 8), f0 = f2(lref + col), f1 = f2(lref + col + 8);
          uint32_t b0h, b0l, b1h, b1l;
          split_bf16(k0.x * ex2(f0.x - l0.x), k0.y * ex2(f0.y - l0.y), b0h, b0l);
          split_bf16(k1.x * ex2(f1.x - l1.x), k1.y * ex2(f1.y - l1.y), b1h, b1l);
          mma_bf16(sc[j], th, b0h, b1h);
          mma_bf16(sc[j], th, b0l, b1l);
          mma_bf16(sc[j], tl_, b0h, b1h);
        }
      }
      // P.v over the sub-blocks up to this warp's: the earlier ones from the
      // score accumulators, the diagonal one from the pairwise scores and the
      // cross block
#pragma unroll
      for (int kq = 0; kq < TC_WARPS; ++kq) {
        if (kq > sb) continue;
        float p[8];                             // rows r0, r1 x columns 2c, 2c+1, 2c+8, 2c+9
        if (kq < sb) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            p[i] = sc[2 * kq][i];
            p[4 + i] = sc[2 * kq + 1][i];
          }
        } else {
          // rows r0 (local g) pair with the lower half only, pairwise; rows
          // r1 (local g + 8) with the lower half through the cross block and
          // with the upper half pairwise
          const int sl = 2 * c;
          const float2 a = f2(sPd + r0 * PS + sl), d = f2(sPd + r1 * PS + 8 + sl);
          p[0] = sl <= g ? a.x : 0.f;
          p[1] = sl + 1 <= g ? a.y : 0.f;
          p[2] = xc[2];
          p[3] = xc[3];
          p[4] = p[5] = 0.f;
          p[6] = sl <= g ? d.x : 0.f;
          p[7] = sl + 1 <= g ? d.y : 0.f;
        }
        uint32_t ph[4], pl[4];
        split_bf16(p[0], p[1], ph[0], pl[0]);   // a0: row r0, columns 2c..
        split_bf16(p[2], p[3], ph[1], pl[1]);   // a1: row r1
        split_bf16(p[4], p[5], ph[2], pl[2]);   // a2: row r0, columns 2c+8..
        split_bf16(p[6], p[7], ph[3], pl[3]);   // a3: row r1
#pragma unroll
        for (int jq = 0; jq < NV / 2; ++jq) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, aV + ((16 * kq + ((lane >> 3) & 1) * 8 + (lane & 7)) * BS + j0 +
                                      16 * jq + (lane >> 4) * 8) * 2);
          mma_bf16(acc[2 * jq], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * jq], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * jq + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * jq + 1], pl, vf[2], vf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int col = j0 + 8 * j + 2 * c;
        *reinterpret_cast<uint32_t*>(sO + r0 * BS + col) = pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(sO + r1 * BS + col) = pack_bf16(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();                          // r, k and S0^T are read; out is staged
    for (int i = tid; i < TC_CH * K / 8; i += TC_THREADS) {     // out: 16-byte vectors
      const int t = i / (K / 8), e = i % (K / 8);
      if (t < rows)
        *reinterpret_cast<uint4*>(out + base + (size_t)(c0 + t) * tok + 8 * e) =
            *reinterpret_cast<const uint4*>(sO + t * BS + 8 * e);
    }

    // E: kd = k_s e^{La_c - La_s}, hi + lo, over r and k; then S^T =
    // e^{La_c} S^T + v^T kd for this warp's tiles, and their hi + mid + lo
    // copy for the next chunk's inter term
    const float* lend = sLa + TC_CH * LS;     // La_c
    for (int i = tid; i < TC_CH * K / 2; i += TC_THREADS) {
      const int s = i / (K / 2), ch = 2 * (i % (K / 2));
      const float2 kv = unpack_bf16(u32(sK + s * BS + ch));
      const float2 ls = f2(sLa + (s + 1) * LS + ch), le = f2(lend + ch);
      uint32_t hi, lo;
      split_bf16(kv.x * ex2(le.x - ls.x), kv.y * ex2(le.y - ls.y), hi, lo);
      *reinterpret_cast<uint32_t*>(sR + s * BS + ch) = hi;
      *reinterpret_cast<uint32_t*>(sK + s * BS + ch) = lo;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      const float2 le = f2(lend + 8 * (nt0 + n) + 2 * c);
      const float dx = ex2(le.x), dy = ex2(le.y);
      st[n][0] *= dx;
      st[n][1] *= dy;
      st[n][2] *= dx;
      st[n][3] *= dy;
    }
#pragma unroll
    for (int kq = 0; kq < TC_CH / 16; ++kq) {
      uint32_t va[4];                           // v^T rows j, columns s: A fragments
      ldmatrix_x4_trans(va, aV + ((16 * kq + (lane >> 4) * 8 + (lane & 7)) * BS + 16 * mt +
                                  ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
      for (int np = 0; np < (NPW + 1) / 2; ++np) {
        // kd rows s, columns 8 (nt0 + 2np).. (two n-tiles; a lone last one reads
        // the row's padding for its unused second)
        const uint32_t off = ((16 * kq + ((lane >> 3) & 1) * 8 + (lane & 7)) * BS +
                              8 * (nt0 + 2 * np) + (lane >> 4) * 8) * 2;
        uint32_t kh[4], kl[4];
        ldmatrix_x4_trans(kh, aR + off);
        ldmatrix_x4_trans(kl, aK + off);
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (2 * np + n >= NPW) continue;
          mma_bf16(st[2 * np + n], va, kh[2 * n], kh[2 * n + 1]);
          mma_bf16(st[2 * np + n], va, kl[2 * n], kl[2 * n + 1]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NPW; ++n) {
      const int col = 8 * (nt0 + n) + 2 * c, j = 16 * mt + g;
      uint32_t hi, mid, lo;
      split3_bf16(st[n][0], st[n][1], hi, mid, lo);
      *reinterpret_cast<uint32_t*>(sShi + j * BS + col) = hi;
      *reinterpret_cast<uint32_t*>(sSmid + j * BS + col) = mid;
      *reinterpret_cast<uint32_t*>(sSlo + j * BS + col) = lo;
      split3_bf16(st[n][2], st[n][3], hi, mid, lo);
      *reinterpret_cast<uint32_t*>(sShi + (j + 8) * BS + col) = hi;
      *reinterpret_cast<uint32_t*>(sSmid + (j + 8) * BS + col) = mid;
      *reinterpret_cast<uint32_t*>(sSlo + (j + 8) * BS + col) = lo;
    }
    __syncthreads();                          // the next chunk overwrites r, k, v and La
  }
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int K>
static cudaError_t launch_f32(const void* r, const void* k, const void* v, const float* lw,
                              const float* u, void* out, int batch, int seq, int heads,
                              cudaStream_t st) {
  constexpr size_t smem = Smem<K>::bytes;
  static_assert(smem <= 48 * 1024, "past the default dynamic shared memory limit");
  rwkv6_kernel<float, K><<<(unsigned)(batch * heads), NT, smem, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(k), static_cast<const float*>(v),
      lw, u, static_cast<float*>(out), seq, heads);
  return cudaGetLastError();
}

template <int K>
static cudaError_t launch_tc(const void* r, const void* k, const void* v, const float* lw,
                             const float* u, void* out, int batch, int seq, int heads,
                             cudaStream_t st) {
  constexpr size_t smem = TcSmem<K>::bytes;
  static_assert(smem <= 227 * 1024, "past the shared memory a CTA can take");
  static uint64_t ready = 0;                // devices whose attributes are set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(ready >> dev & 1)) {
    err = cudaFuncSetAttribute(rwkv6_kernel_tc<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rwkv6_kernel_tc<K>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    ready |= 1ull << dev;
  }
  const int vec = aligned16(r) && aligned16(k) && aligned16(v) && aligned16(lw);
  const long long grid = (long long)batch * heads;
  rwkv6_kernel_tc<K><<<(unsigned)grid, TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lw, u, static_cast<__nv_bfloat16*>(out), seq, heads,
      vec);
  return cudaGetLastError();
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
  if (dk != 32 && dk != 64) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return (int)(dk == 32 ? launch_tc<32> : launch_tc<64>)(r, k, v, lw, uu, out, batch, seq,
                                                            heads, st);
  if (dtype == DT_F32)
    return (int)(dk == 32 ? launch_f32<32> : launch_f32<64>)(r, k, v, lw, uu, out, batch, seq,
                                                              heads, st);
  return (int)cudaErrorInvalidValue;
}
