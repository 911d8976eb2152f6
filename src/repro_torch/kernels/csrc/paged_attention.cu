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
// block's DMA, and blocks past pos are read and masked), each CTA here loads
// its own table entries and offsets the pool pointer by them, and a lane's
// live positions 0..pos[b] are cut into n_split tile-aligned slices, one CTA
// per (lane, KV head, slice), sized by the wrapper for about two CTAs per SM
// at serving batch; the last CTA of each (lane, KV head) merges them in the
// same launch.  Blocks past pos[b] / bs are never read, so on a live lane the
// sink is never read either.  The body and its loads are decode_body.cuh,
// shared with the dense kernel.
#include "decode_body.cuh"

struct PagedLayout {
  const int* tables;         // (B, max_blocks) pool block ids
  const int* pos;            // (B,) last position a lane attends
  int bs, max_blocks;

  // live positions of lane b: 0..pos[b], within the table's span
  __device__ int n_live(int b) const {
    const int p = pos[b];
    return p < 0 ? 0 : min(p, max_blocks * bs - 1) + 1;
  }
  __device__ void slice(int b, int split, int n_split, int& begin, int& end) const {
    const int n = n_live(b);
    const int tiles = (n + DEC_TILE - 1) / DEC_TILE;
    const int per = (tiles + n_split - 1) / n_split;           // tiles per slice
    begin = min(n, split * per * DEC_TILE);
    end = min(n, begin + per * DEC_TILE);
  }
  __device__ int span() const { return max_blocks * bs; }
  __device__ bool live(int b, int p) const { return p <= pos[b]; }
  __device__ size_t row(int b, int p) const {
    return (size_t)tables[(size_t)b * max_blocks + p / bs] * bs + p % bs;
  }
};

template <typename T, int D>
static cudaError_t launch(const PagedLayout& lay, const void* q, const void* k, const void* v,
                          void* out, void* part_m, void* part_l, void* part_acc, void* counters,
                          int B, int H, int G, int n_split, float scale, cudaStream_t st) {
  dim3 grid(n_split, G, B);
  decode_kernel<T, D, PagedLayout><<<grid, DEC_THREADS, 0, st>>>(
      lay, static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(part_m), static_cast<float*>(part_l),
      static_cast<float*>(part_acc), static_cast<int*>(counters), H, G, n_split, scale);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_d(int D, const PagedLayout& lay, const void* q, const void* k,
                              const void* v, void* out, void* pm, void* pl, void* pa, void* cnt,
                              int B, int H, int G, int n_split, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(lay, q, k, v, out, pm, pl, pa, cnt, B, H, G, n_split, scale, st);
    case 64: return launch<T, 64>(lay, q, k, v, out, pm, pl, pa, cnt, B, H, G, n_split, scale, st);
    case 128: return launch<T, 128>(lay, q, k, v, out, pm, pl, pa, cnt, B, H, G, n_split, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int paged_decode_attention_fwd(const void* q, const void* kp, const void* vp,
                                          const void* block_tables, const void* pos, void* out,
                                          void* part_m, void* part_l, void* part_acc,
                                          void* counters, int B, int bs, int max_blocks, int H,
                                          int G, int D, int n_split, float scale, int dtype,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || bs <= 0 || max_blocks <= 0 || (long long)max_blocks * bs > (1LL << 30) ||
      G <= 0 || H % G != 0 || H / G > MAX_NREP || n_split <= 0 || B > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  const PagedLayout lay{static_cast<const int*>(block_tables), static_cast<const int*>(pos), bs,
                        max_blocks};
  if (dtype == DT_BF16)
    return (int)dispatch_d<__nv_bfloat16>(D, lay, q, kp, vp, out, part_m, part_l, part_acc,
                                          counters, B, H, G, n_split, scale, st);
  if (dtype == DT_F32)
    return (int)dispatch_d<float>(D, lay, q, kp, vp, out, part_m, part_l, part_acc, counters, B,
                                  H, G, n_split, scale, st);
  return (int)cudaErrorInvalidValue;
}
