// Hopper (sm_90a) kernels of the ZINC convolution's min/max reductions,
// forward and backward.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (mma_tpu_torch/ops/cuda/build.py). Each entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused
// launch.
//
// Replaces the four Pallas kernels of mma_tpu/ops/pallas/segment_minmax.py.
// Those find each row's optimum with a Hillis-Steele doubling scan over a
// block of edges, select per-row partials with one-hot MXU contractions of
// 3-term bf16 splits, and carry "hit before" state across the sequential
// (row block, chunk) grid, all because the TPU has no scatter and rounds
// MXU operands. None of that is needed here. The design of all four:
//
//   One thread per (destination row, channel). The thread walks the row's
//   edges over the dst-sorted CSR in edge order; channels run along
//   threadIdx.x, so each edge's C-wide row is read coalesced. ZINC's
//   in-degree is at most 4, so each walk is short.
//
// That gives the Pallas kernels' semantics directly: "first hit" is the
// first edge in walk order, every output element is written once by one
// thread (no atomics, bitwise equal run to run), and the dst-keyed sum of
// the backward is a fixed-order sum. Rows without edges give 0 (the
// reference's torch_scatter fill). Edges outside the CSR (the padding tail
// of Graph.real_row_ptr) get no value in the forward and a zero gradient in
// the backward.
//
// Bound on this card: bytes, for all four. Each edge value is read once,
// compared (and in the edge program added and masked) a few times: about 1
// operation per byte, far below the f32 CUDA-core ridge (~20 FLOP/B).
//
// All four also read bf16 edge operands (the conv's compute_dtype
// "bfloat16"): each kernel is a template on the element type E of its edge
// operand (kernel 4's data, kernel 5's data and grad, kernels 6-7's c, hg,
// dhg and dc), float or __nv_bfloat16. Only the loads and the stores of E
// change: a bf16 value is widened to f32 as it is loaded, and every
// compare, add, dropout product and sum stays f32, as the JAX kernels
// compute them on bf16 inputs (mma_tpu/ops/pallas/segment_minmax.py:
// x = hg.astype(f32) + c, :251; data_passes = c_passes = 1, :843, :936).
// The forward outputs stay f32. Where the JAX kernels' one-pass
// contraction rounds an f32 operand to bf16, the bf16 variants round it
// too: the backward's cotangent ct (passes = 1 for bf16 data, _split_terms
// at :353 and :473). The backward writes its edge gradient (and kernel 7
// its dc) in E, each f32 value rounded once to nearest even, as
// grad.astype(d.dtype) and dc.astype(c.dtype) do (:883-884, :981).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Threads along x cover channels (a multiple of 32, at most 128, so a
// narrow C keeps whole warps busy); the rest of the block along y covers
// rows.
struct RowChannelGrid {
  dim3 grid, block;
};

RowChannelGrid row_channel_grid(int n_rows, int n_chan) {
  int bx = ((n_chan + 31) / 32) * 32;
  if (bx > 128) bx = 128;
  const int by = kThreads / bx;
  return {dim3((n_rows + by - 1) / by), dim3(bx, by)};
}

__device__ __forceinline__ bool improves(float v, float best, bool is_max) {
  return is_max ? v > best : v < best;
}

using bf16_t = __nv_bfloat16;

// One element of type E (float or bf16) in device memory as f32, and an
// f32 value stored as E (rounded to nearest even for bf16).
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const bf16_t* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16_t* p, float v) { *p = __float2bfloat16_rn(v); }

// The backward's cotangent as the JAX kernels select it: exact for f32
// edge operands (3-term split), rounded to bf16 for bf16 ones (one pass).
template <typename E>
__device__ __forceinline__ float cotangent(float ct) {
  if constexpr (sizeof(E) == sizeof(float)) {
    return ct;
  } else {
    return __bfloat162float(__float2bfloat16_rn(ct));
  }
}

// The JAX package's _dropout_keep (segment_minmax.py:170-192), bit for bit:
// a murmur3-finalizer hash of (seed, absolute edge index, lane). The int32
// wrapping products there are these uint32 products. Returns the mask value
// keep / (1 - rate), with scale = f32(1 / (1 - rate)) from the host.
__device__ __forceinline__ float dropout_keep(int32_t seed, int64_t pos, int lane,
                                              int32_t thresh, float scale) {
  uint32_t x = static_cast<uint32_t>(pos) * 0x9E3779B9u +
               static_cast<uint32_t>(lane) * 0x85EBCA6Bu + static_cast<uint32_t>(seed);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const int32_t u = static_cast<int32_t>(x & 0x7FFFFFFFu);
  return u >= thresh ? scale : 0.f;
}

// The edge program's message: x = m * (hg + c[dst]). Rounded operations,
// so that the backward's recompute is bitwise the forward's (no FMA
// contraction can differ between the two kernels).
__device__ __forceinline__ float message(float hg, float c, bool drop, int32_t seed,
                                         int64_t e, int ch, int32_t thresh, float scale) {
  const float x = __fadd_rn(hg, c);
  return drop ? __fmul_rn(x, dropout_keep(seed, e, ch, thresh, scale)) : x;
}

// ---------------------------------------------------------------------------
// Kernel 4: segment_minmax
//
// Replaces _minmax_kernel (launched by _fused_segment_minmax):
//   out[i, p*C + ch] = op_p over e in [row_ptr[i], row_ptr[i+1]) of data[e, ch]
// for ops p in aggregator order (bit p of max_bits set: max, else min).
// Both ops share one read of the edge data.
// ---------------------------------------------------------------------------
template <typename E>
__global__ void segment_minmax_kernel(const E* __restrict__ data,
                                      const int32_t* __restrict__ row_ptr,
                                      float* __restrict__ out, int n_rows, int n_chan,
                                      int n_ops, int max_bits) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  float* o = out + static_cast<int64_t>(row) * n_ops * n_chan;
  const bool max0 = max_bits & 1, max1 = max_bits & 2;
  for (int ch = threadIdx.x; ch < n_chan; ch += blockDim.x) {
    float b0 = 0.f, b1 = 0.f;
    if (start < end) {
      b0 = b1 = load(data + start * n_chan + ch);
      for (int64_t e = start + 1; e < end; ++e) {
        const float v = load(data + e * n_chan + ch);
        if (improves(v, b0, max0)) b0 = v;
        if (improves(v, b1, max1)) b1 = v;
      }
    }
    o[ch] = b0;
    if (n_ops == 2) o[n_chan + ch] = b1;
  }
}

// ---------------------------------------------------------------------------
// Kernel 5: segment_minmax_bwd
//
// Replaces _minmax_bwd_kernel (launched by _fused_segment_minmax_bwd): each
// (row, channel, op) cotangent goes to the FIRST edge of the row whose value
// equals the forward optimum (exact f32 ==; torch_scatter's arg routing),
// summed over the ops in op order. A degree-1 row's edge is both min and
// max and gets ct_min + ct_max.
// ---------------------------------------------------------------------------
template <typename E>
__global__ void segment_minmax_bwd_kernel(const E* __restrict__ data,
                                          const int32_t* __restrict__ row_ptr,
                                          const float* __restrict__ out,
                                          const float* __restrict__ ct,
                                          E* __restrict__ grad, int n_rows,
                                          int n_chan, int n_ops) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  if (start >= end) return;
  const int64_t base = static_cast<int64_t>(row) * n_ops * n_chan;
  for (int ch = threadIdx.x; ch < n_chan; ch += blockDim.x) {
    const float t0 = out[base + ch], c0 = cotangent<E>(ct[base + ch]);
    const float t1 = n_ops == 2 ? out[base + n_chan + ch] : 0.f;
    const float c1 = n_ops == 2 ? cotangent<E>(ct[base + n_chan + ch]) : 0.f;
    bool open0 = true, open1 = n_ops == 2;
    for (int64_t e = start; e < end; ++e) {
      const float v = load(data + e * n_chan + ch);
      float g = 0.f;
      if (open0 && v == t0) { g += c0; open0 = false; }
      if (open1 && v == t1) { g += c1; open1 = false; }
      store(grad + e * n_chan + ch, g);
    }
  }
}

// ---------------------------------------------------------------------------
// Kernel 6: minmax_prog
//
// Replaces _minmax_prog_kernel (launched by _fused_minmax_prog): the fused
// min/max edge program. x_e = m_e * (hg_e + c[dst_e]) (the dropout mask
// multiplies after the add, so dropped lanes take part as 0), then min/max
// per destination row as kernel 4. c[i, ch] is read once per row; the (E, C)
// message tensor is never stored.
// ---------------------------------------------------------------------------
template <typename E>
__global__ void minmax_prog_kernel(const E* __restrict__ c,
                                   const E* __restrict__ hg,
                                   const int32_t* __restrict__ row_ptr,
                                   const int32_t* __restrict__ seed_ptr,
                                   float* __restrict__ out, int n_rows, int n_chan,
                                   int n_ops, int max_bits, int32_t thresh,
                                   float scale) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  const bool drop = seed_ptr != nullptr;
  const int32_t seed = drop ? __ldg(seed_ptr) : 0;
  float* o = out + static_cast<int64_t>(row) * n_ops * n_chan;
  const bool max0 = max_bits & 1, max1 = max_bits & 2;
  for (int ch = threadIdx.x; ch < n_chan; ch += blockDim.x) {
    float b0 = 0.f, b1 = 0.f;
    if (start < end) {
      const float cv = load(c + static_cast<int64_t>(row) * n_chan + ch);
      b0 = b1 = message(load(hg + start * n_chan + ch), cv, drop, seed, start, ch, thresh,
                        scale);
      for (int64_t e = start + 1; e < end; ++e) {
        const float v = message(load(hg + e * n_chan + ch), cv, drop, seed, e, ch, thresh,
                                scale);
        if (improves(v, b0, max0)) b0 = v;
        if (improves(v, b1, max1)) b1 = v;
      }
    }
    o[ch] = b0;
    if (n_ops == 2) o[n_chan + ch] = b1;
  }
}

// ---------------------------------------------------------------------------
// Kernel 7: minmax_prog_bwd
//
// Replaces _minmax_prog_bwd_kernel (launched by _fused_minmax_prog_bwd):
// recomputes x exactly (same message(), same hash), routes each op's
// cotangent to the first hit as kernel 5, and emits
//   dhg[e, ch] = routed_ct * m_e          (every covered edge)
//   dc[i, ch]  = sum over the row's edges of dhg, in edge order.
// ---------------------------------------------------------------------------
template <typename E>
__global__ void minmax_prog_bwd_kernel(const E* __restrict__ c,
                                       const E* __restrict__ hg,
                                       const int32_t* __restrict__ row_ptr,
                                       const int32_t* __restrict__ seed_ptr,
                                       const float* __restrict__ out,
                                       const float* __restrict__ ct,
                                       E* __restrict__ dhg, E* __restrict__ dc,
                                       int n_rows, int n_chan, int n_ops, int32_t thresh,
                                       float scale) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  const bool drop = seed_ptr != nullptr;
  const int32_t seed = drop ? __ldg(seed_ptr) : 0;
  const int64_t base = static_cast<int64_t>(row) * n_ops * n_chan;
  for (int ch = threadIdx.x; ch < n_chan; ch += blockDim.x) {
    float acc = 0.f;
    if (start < end) {
      const float cv = load(c + static_cast<int64_t>(row) * n_chan + ch);
      const float t0 = out[base + ch], c0 = cotangent<E>(ct[base + ch]);
      const float t1 = n_ops == 2 ? out[base + n_chan + ch] : 0.f;
      const float c1 = n_ops == 2 ? cotangent<E>(ct[base + n_chan + ch]) : 0.f;
      bool open0 = true, open1 = n_ops == 2;
      for (int64_t e = start; e < end; ++e) {
        const float x = __fadd_rn(load(hg + e * n_chan + ch), cv);
        const float m = drop ? dropout_keep(seed, e, ch, thresh, scale) : 1.f;
        const float v = drop ? __fmul_rn(x, m) : x;
        float g = 0.f;
        if (open0 && v == t0) { g += c0; open0 = false; }
        if (open1 && v == t1) { g += c1; open1 = false; }
        if (drop) g = __fmul_rn(g, m);
        store(dhg + e * n_chan + ch, g);
        acc = __fadd_rn(acc, g);
      }
    }
    store(dc + static_cast<int64_t>(row) * n_chan + ch, acc);
  }
}

// Zeroes the edge rows outside [row_ptr[0], row_ptr[n_rows]): the padding
// edges, which the backward kernels do not visit.
template <typename E>
__global__ void zero_uncovered_kernel(E* __restrict__ grad,
                                      const int32_t* __restrict__ row_ptr, int n_rows,
                                      int64_t n_edges, int n_chan) {
  const int64_t lo = row_ptr[0];
  const int64_t hi = row_ptr[n_rows];
  const int64_t total = (lo + n_edges - hi) * n_chan;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t e = i / n_chan;
    if (e >= lo) e += hi - lo;
    store(grad + e * n_chan + i % n_chan, 0.f);
  }
}

template <typename E>
cudaError_t launch_zero_uncovered(E* grad, const int32_t* row_ptr, int n_rows,
                                  int64_t n_edges, int n_chan, cudaStream_t s) {
  int64_t blocks = (n_edges * n_chan + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  zero_uncovered_kernel<E><<<static_cast<int>(blocks), kThreads, 0, s>>>(grad, row_ptr, n_rows,
                                                                       n_edges, n_chan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// data (E, C) f32 (bf16 when bf16 != 0), row_ptr (n_rows+1,) i32, out
// (n_rows, n_ops*C) f32. n_ops is 1 or 2; bit p of max_bits set means op p
// is max, else min.
int mma_segment_minmax(const void* data, const void* row_ptr, void* out, int n_rows,
                       int n_chan, int n_ops, int max_bits, int bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  auto launch = [&](auto elem) {
    using E = decltype(elem);
    segment_minmax_kernel<E><<<g.grid, g.block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(data), static_cast<const int32_t*>(row_ptr),
        static_cast<float*>(out), n_rows, n_chan, n_ops, max_bits);
  };
  bf16 ? launch(bf16_t()) : launch(float());
  return static_cast<int>(cudaGetLastError());
}

// data and grad (n_edges, C) f32 (bf16 when bf16 != 0), out and ct
// (n_rows, n_ops*C) f32, row_ptr (n_rows+1,) i32. Every edge row of grad is
// written.
int mma_segment_minmax_bwd(const void* data, const void* row_ptr, const void* out,
                           const void* ct, void* grad, int n_rows, int64_t n_edges,
                           int n_chan, int n_ops, int bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  auto launch = [&](auto elem) {
    using E = decltype(elem);
    segment_minmax_bwd_kernel<E><<<g.grid, g.block, 0, s>>>(
        static_cast<const E*>(data), static_cast<const int32_t*>(row_ptr),
        static_cast<const float*>(out), static_cast<const float*>(ct),
        static_cast<E*>(grad), n_rows, n_chan, n_ops);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_zero_uncovered(static_cast<E*>(grad), static_cast<const int32_t*>(row_ptr),
                                 n_rows, n_edges, n_chan, s);
  };
  return static_cast<int>(bf16 ? launch(bf16_t()) : launch(float()));
}

// c (n_rows, C) and hg (E, C) f32 (both bf16 when bf16 != 0), out
// (n_rows, n_ops*C) f32, row_ptr (n_rows+1,) i32; seed (1,) i32 on the
// device, or null for no dropout; thresh = int(rate * 2^31), scale =
// f32(1 / (1 - rate)).
int mma_minmax_prog(const void* c, const void* hg, const void* row_ptr, const void* seed,
                    void* out, int n_rows, int n_chan, int n_ops, int max_bits,
                    int thresh, float scale, int bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  auto launch = [&](auto elem) {
    using E = decltype(elem);
    minmax_prog_kernel<E><<<g.grid, g.block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(c), static_cast<const E*>(hg),
        static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(seed),
        static_cast<float*>(out), n_rows, n_chan, n_ops, max_bits, thresh, scale);
  };
  bf16 ? launch(bf16_t()) : launch(float());
  return static_cast<int>(cudaGetLastError());
}

// As mma_minmax_prog, plus out and ct (n_rows, n_ops*C) f32; outputs dhg
// (n_edges, C), every edge row written, and dc (n_rows, C), both in the
// type of c and hg.
int mma_minmax_prog_bwd(const void* c, const void* hg, const void* row_ptr,
                        const void* seed, const void* out, const void* ct, void* dhg,
                        void* dc, int n_rows, int64_t n_edges, int n_chan, int n_ops,
                        int thresh, float scale, int bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  auto launch = [&](auto elem) {
    using E = decltype(elem);
    minmax_prog_bwd_kernel<E><<<g.grid, g.block, 0, s>>>(
        static_cast<const E*>(c), static_cast<const E*>(hg),
        static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(seed),
        static_cast<const float*>(out), static_cast<const float*>(ct),
        static_cast<E*>(dhg), static_cast<E*>(dc), n_rows, n_chan, n_ops, thresh, scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_zero_uncovered(static_cast<E*>(dhg), static_cast<const int32_t*>(row_ptr),
                                 n_rows, n_edges, n_chan, s);
  };
  return static_cast<int>(bf16 ? launch(bf16_t()) : launch(float()));
}

}  // extern "C"
