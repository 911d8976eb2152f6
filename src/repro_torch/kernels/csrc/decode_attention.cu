// Decode attention (one query token over a dense KV cache) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention_fwd
// (_dec_kernel): q (B,1,H,D) against ck/cv (B,S,G,D), masked per lane by
// valid (B,S), online softmax in fp32, H/G query heads per KV head (GQA).
//
// Bound on the H100: bytes (every live position's K and V read once).  The
// body, its design and what it does about the bound are in decode_body.cuh,
// shared with the paged kernel; this file says where a dense lane's
// positions live.  The span is cut into fixed slices of split_len positions
// (tile multiples, sized by the wrapper); each warp reads the `valid` bytes
// of all its chunks of 16 positions at once and walks only the chunks with a
// valid position, so bytes scale with each lane's live positions, not the
// cache span.  The host does not know which slices are live, so every CTA
// reads its slice of `valid` and takes part in the merge.  A lane whose
// valid row is all False gets the mean of V over the span, as the TPU
// kernel's finite mask gives.
#include "decode_body.cuh"

struct DenseLayout {
  const uint8_t* valid;      // (B, S)
  int S;

  __device__ int end(int b) const { return S; }
  __device__ int n_items(int b, int n_split) const { return n_split; }
  __device__ int span() const { return S; }
  __device__ bool live(int b, int p) const { return valid[(size_t)b * S + p] != 0; }
  __device__ uint32_t chunk_mask(int b, int p0, int end) const {
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < DEC_CHUNK; ++j)
      if (p0 + j < end && live(b, p0 + j)) m |= 1u << j;
    return m;
  }
  __device__ int row(int b, int p) const { return b * S + p; }
};

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, void* part_m, void* part_l,
                                    void* part_acc, void* counters, int B, int S, int H, int G,
                                    int D, int split_len, int n_split, float scale, int dtype,
                                    void* stream) {
  if (S <= 0 || (long long)split_len * n_split < S || (long long)B * S >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const DenseLayout lay{static_cast<const uint8_t*>(valid), S};
  return (int)launch_decode(lay, D, dtype, q, k, v, out, part_m, part_l, part_acc, counters, B,
                            H, G, n_split, split_len, scale, static_cast<cudaStream_t>(stream));
}
