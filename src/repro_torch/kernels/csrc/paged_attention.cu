// Paged decode attention (one query token over a block-pooled KV cache) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_decode_attention_fwd
// (_paged_kernel): q (B,1,H,D) against the pool kp/vp (NB,bs,G,D) through
// block_tables (B,max_blocks) int32 and pos (B,) int32.  Lane b attends to
// its logical positions 0..pos[b]; position p lives at row p % bs of pool
// block block_tables[b, p / bs].  Online softmax in fp32, H/G query heads per
// KV head (GQA), output in q's type.  Block 0 is the sink that idle lanes
// write to.
//
// Bound on the H100: bytes -- live positions x G x D x 2 (K and V) x 2 bytes
// in bf16, read once, for ~1 flop per byte.  Where the TPU kernel walks every
// table entry of a lane in a sequential grid axis (scalar prefetch aims each
// block's DMA, and blocks past pos are read and masked), each warp here loads
// its own chunks' table entries and offsets the pool pointer by them (the
// body and its loads are decode_body.cuh, shared with the dense kernel).
// The host does not know pos without a sync, so every CTA takes a fixed
// slice of split_len positions of the table's span (the wrapper sizes it for
// the card); a CTA whose slice starts past pos[b] exits at once, and the
// merge waits only for the ceil((pos[b] + 1) / split_len) CTAs of a lane that
// hold live positions, so a short lane costs few CTAs and a long one is
// spread over many.  Blocks past pos[b] / bs are never read, so on a live lane
// the sink is never read either.
#include "decode_body.cuh"

struct PagedLayout {
  const int* tables;         // (B, max_blocks) pool block ids
  const int* pos;            // (B,) last position a lane attends
  int bs, max_blocks, split_len;

  // live positions of lane b: 0..pos[b], within the table's span
  __device__ int end(int b) const {
    const int p = pos[b];
    return p < 0 ? 0 : min(p, max_blocks * bs - 1) + 1;
  }
  // one CTA (which writes the mean of V) for a lane with no live position
  __device__ int n_items(int b, int n_split) const {
    return max(1, min(n_split, (end(b) + split_len - 1) / split_len));
  }
  __device__ int span() const { return max_blocks * bs; }
  __device__ bool live(int b, int p) const { return true; }      // p < end(b)
  __device__ uint32_t chunk_mask(int b, int p0, int end) const {
    const int n = end - p0;
    return n >= DEC_CHUNK ? (1u << DEC_CHUNK) - 1 : n > 0 ? (1u << n) - 1 : 0u;
  }
  __device__ int row(int b, int p) const {
    return tables[(size_t)b * max_blocks + p / bs] * bs + p % bs;
  }
};

extern "C" int paged_decode_attention_fwd(const void* q, const void* kp, const void* vp,
                                          const void* block_tables, const void* pos, void* out,
                                          void* part_m, void* part_l, void* part_acc,
                                          void* counters, int B, int bs, int max_blocks, int H,
                                          int G, int D, int n_split, float scale, int dtype,
                                          void* stream) {
  if (bs <= 0 || max_blocks <= 0 || (long long)max_blocks * bs > (1LL << 30) || n_split <= 0)
    return (int)cudaErrorInvalidValue;
  // n_split slices of whole tiles cover the span
  const int tiles = (max_blocks * bs + DEC_TILE - 1) / DEC_TILE;
  const int split_len = (tiles + n_split - 1) / n_split * DEC_TILE;
  const PagedLayout lay{static_cast<const int*>(block_tables), static_cast<const int*>(pos), bs,
                        max_blocks, split_len};
  return (int)launch_decode(lay, D, dtype, q, kp, vp, out, part_m, part_l, part_acc, counters, B,
                            H, G, n_split, split_len, scale, static_cast<cudaStream_t>(stream));
}
