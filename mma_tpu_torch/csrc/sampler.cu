// Hopper (sm_90a) kernel of the neighbour sampler's picks: one hop of
// mma_tpu_torch/csrc/graphops.cpp's layered sampler, on the card.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (mma_tpu_torch/ops/cuda/build.py). The entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused
// launch.
//
// One thread per frontier slot. The thread takes the node's in-edges over
// the dst-sorted CSR exactly as graphops.cpp's sample_node does: every
// edge when the degree is at most the fanout, else a reservoir over the
// edge positions driven by the same splitmix64 stream, seeded by
// (rng_seed, node, hop). It reads the picked sources, sorts them and drops
// repeats, so a slot's row equals the host's picks for that node bit for
// bit. The relabel that follows (first occurrences in emission order) is
// plain PyTorch: mma_tpu_torch/data/device_sampling.py.
//
// Slots at or past the frontier's length (a device scalar, so that the
// caller need not read it back) give no picks. A reservoir walks the whole
// row, one draw an edge, so a hub's thread runs longest; the draws of a row
// form one serial chain, which is what keeps the sample equal to the
// host's at any thread count.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxFanout = 64;  // graphops.cpp's per-node stack buffer

__device__ __forceinline__ uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

__global__ void sample_picks_kernel(const int64_t* __restrict__ row_ptr,
                                    const int32_t* __restrict__ src_sorted,
                                    const int32_t* __restrict__ frontier,
                                    const int64_t* __restrict__ n_frontier, int n_slots,
                                    int fanout, int hop, const int64_t* __restrict__ rng_seed,
                                    int32_t* __restrict__ picks, int32_t* __restrict__ count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  int32_t* out = picks + static_cast<int64_t>(i) * fanout;
  int32_t m = 0;
  if (i < *n_frontier) {
    const int32_t u = frontier[i];
    const int64_t lo = row_ptr[u], deg = row_ptr[u + 1] - lo;
    int32_t vals[kMaxFanout];
    int32_t k;
    if (deg <= fanout) {
      k = static_cast<int32_t>(deg);
      for (int32_t j = 0; j < k; ++j) vals[j] = src_sorted[lo + j];
    } else {
      int64_t pick[kMaxFanout];
      uint64_t s = splitmix64(static_cast<uint64_t>(*rng_seed) ^
                              (static_cast<uint64_t>(u) << 20) ^ static_cast<uint64_t>(hop));
      k = fanout;
      for (int32_t j = 0; j < fanout; ++j) pick[j] = lo + j;
      for (int64_t j = fanout; j < deg; ++j) {
        s = splitmix64(s);
        const uint64_t r = __umul64hi(s, static_cast<uint64_t>(j + 1));
        if (r < static_cast<uint64_t>(fanout)) pick[r] = lo + j;
      }
      for (int32_t j = 0; j < k; ++j) vals[j] = src_sorted[pick[j]];
    }
    for (int32_t j = 1; j < k; ++j) {  // insertion sort of at most 64
      const int32_t v = vals[j];
      int32_t p = j - 1;
      while (p >= 0 && vals[p] > v) {
        vals[p + 1] = vals[p];
        --p;
      }
      vals[p + 1] = v;
    }
    for (int32_t j = 0; j < k; ++j) {
      if (j > 0 && vals[j] == vals[j - 1]) continue;
      out[m++] = vals[j];
    }
  }
  count[i] = m;
  for (int32_t j = m; j < fanout; ++j) out[j] = -1;
}

}  // namespace

extern "C" {

const char* mma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// row_ptr (N+1,) i64 and src_sorted (E,) i32: the graph's dst-sorted CSR;
// frontier (n_slots,) i32 global ids, the first *n_frontier of them real
// (n_frontier a device i64 scalar); picks (n_slots, fanout) i32 and count
// (n_slots,) i32 out: each slot's sorted distinct picked sources, -1 after
// them. fanout in [1, 64]. rng_seed is a device i64 (the stream's seed, its
// bits as uint64), read there so that the launch can sit in a CUDA graph.
int mma_sample_picks(const void* row_ptr, const void* src_sorted, const void* frontier,
                     const void* n_frontier, int n_slots, int fanout, int hop,
                     const void* rng_seed, void* picks, void* count, void* stream) {
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  if (fanout < 1 || fanout > kMaxFanout) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 128;
  sample_picks_kernel<<<(n_slots + block - 1) / block, block, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(row_ptr), static_cast<const int32_t*>(src_sorted),
      static_cast<const int32_t*>(frontier), static_cast<const int64_t*>(n_frontier), n_slots,
      fanout, hop, static_cast<const int64_t*>(rng_seed), static_cast<int32_t*>(picks),
      static_cast<int32_t*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
