// Decode attention (one query token over a dense KV cache) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_fwd
// (_dec_kernel): q (B,1,H,D) against ck/cv (B,S,G,D), masked per lane by
// valid (B,S), online softmax in fp32, H/G query heads per KV head (GQA).
//
// Bound on the H100: bytes (every live position's K and V read once).  The
// body, its split-S design and what it does about the bound are in
// decode_body.cuh, shared with the paged kernel; this file says where a dense
// lane's positions live.  The span is cut into fixed slices of split_len
// positions (tile multiples, sized by the wrapper); tiles with no valid
// position are skipped, so bytes scale with each lane's live positions, not
// the cache span.  A lane whose valid row is all False gets the mean of V
// over the span, as the TPU kernel's finite mask gives.
#include "decode_body.cuh"

struct DenseLayout {
  const uint8_t* valid;      // (B, S)
  int S, split_len;

  __device__ void slice(int b, int split, int n_split, int& begin, int& end) const {
    begin = split * split_len;
    end = min(S, begin + split_len);
  }
  __device__ int span() const { return S; }
  __device__ bool live(int b, int p) const { return valid[(size_t)b * S + p] != 0; }
  __device__ size_t row(int b, int p) const { return (size_t)b * S + p; }
};

template <typename T, int D>
static cudaError_t launch(const void* q, const void* k, const void* v, const void* valid,
                          void* out, void* part_m, void* part_l, void* part_acc, void* counters,
                          int B, int S, int H, int G, int split_len, int n_split, float scale,
                          cudaStream_t st) {
  dim3 grid(n_split, G, B);
  const DenseLayout lay{static_cast<const uint8_t*>(valid), S, split_len};
  decode_kernel<T, D, DenseLayout><<<grid, DEC_THREADS, 0, st>>>(
      lay, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), static_cast<int*>(counters), H, G, n_split, scale);
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
