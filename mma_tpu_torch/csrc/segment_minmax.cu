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
__global__ void segment_minmax_kernel(const float* __restrict__ data,
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
      b0 = b1 = __ldg(data + start * n_chan + ch);
      for (int64_t e = start + 1; e < end; ++e) {
        const float v = __ldg(data + e * n_chan + ch);
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
__global__ void segment_minmax_bwd_kernel(const float* __restrict__ data,
                                          const int32_t* __restrict__ row_ptr,
                                          const float* __restrict__ out,
                                          const float* __restrict__ ct,
                                          float* __restrict__ grad, int n_rows,
                                          int n_chan, int n_ops) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  if (start >= end) return;
  const int64_t base = static_cast<int64_t>(row) * n_ops * n_chan;
  for (int ch = threadIdx.x; ch < n_chan; ch += blockDim.x) {
    const float t0 = out[base + ch], c0 = ct[base + ch];
    const float t1 = n_ops == 2 ? out[base + n_chan + ch] : 0.f;
    const float c1 = n_ops == 2 ? ct[base + n_chan + ch] : 0.f;
    bool open0 = true, open1 = n_ops == 2;
    for (int64_t e = start; e < end; ++e) {
      const float v = __ldg(data + e * n_chan + ch);
      float g = 0.f;
      if (open0 && v == t0) { g += c0; open0 = false; }
      if (open1 && v == t1) { g += c1; open1 = false; }
      grad[e * n_chan + ch] = g;
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
__global__ void minmax_prog_kernel(const float* __restrict__ c,
                                   const float* __restrict__ hg,
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
      const float cv = __ldg(c + static_cast<int64_t>(row) * n_chan + ch);
      b0 = b1 = message(__ldg(hg + start * n_chan + ch), cv, drop, seed, start, ch,
                        thresh, scale);
      for (int64_t e = start + 1; e < end; ++e) {
        const float v = message(__ldg(hg + e * n_chan + ch), cv, drop, seed, e, ch,
                                thresh, scale);
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
__global__ void minmax_prog_bwd_kernel(const float* __restrict__ c,
                                       const float* __restrict__ hg,
                                       const int32_t* __restrict__ row_ptr,
                                       const int32_t* __restrict__ seed_ptr,
                                       const float* __restrict__ out,
                                       const float* __restrict__ ct,
                                       float* __restrict__ dhg, float* __restrict__ dc,
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
      const float cv = __ldg(c + static_cast<int64_t>(row) * n_chan + ch);
      const float t0 = out[base + ch], c0 = ct[base + ch];
      const float t1 = n_ops == 2 ? out[base + n_chan + ch] : 0.f;
      const float c1 = n_ops == 2 ? ct[base + n_chan + ch] : 0.f;
      bool open0 = true, open1 = n_ops == 2;
      for (int64_t e = start; e < end; ++e) {
        const float x = __fadd_rn(__ldg(hg + e * n_chan + ch), cv);
        const float m = drop ? dropout_keep(seed, e, ch, thresh, scale) : 1.f;
        const float v = drop ? __fmul_rn(x, m) : x;
        float g = 0.f;
        if (open0 && v == t0) { g += c0; open0 = false; }
        if (open1 && v == t1) { g += c1; open1 = false; }
        if (drop) g = __fmul_rn(g, m);
        dhg[e * n_chan + ch] = g;
        acc = __fadd_rn(acc, g);
      }
    }
    dc[static_cast<int64_t>(row) * n_chan + ch] = acc;
  }
}

// Zeroes the edge rows outside [row_ptr[0], row_ptr[n_rows]): the padding
// edges, which the backward kernels do not visit.
__global__ void zero_uncovered_kernel(float* __restrict__ grad,
                                      const int32_t* __restrict__ row_ptr, int n_rows,
                                      int64_t n_edges, int n_chan) {
  const int64_t lo = row_ptr[0];
  const int64_t hi = row_ptr[n_rows];
  const int64_t total = (lo + n_edges - hi) * n_chan;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int64_t e = i / n_chan;
    if (e >= lo) e += hi - lo;
    grad[e * n_chan + i % n_chan] = 0.f;
  }
}

cudaError_t launch_zero_uncovered(float* grad, const int32_t* row_ptr, int n_rows,
                                  int64_t n_edges, int n_chan, cudaStream_t s) {
  int64_t blocks = (n_edges * n_chan + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  if (blocks < 1) blocks = 1;
  zero_uncovered_kernel<<<static_cast<int>(blocks), kThreads, 0, s>>>(grad, row_ptr, n_rows,
                                                                       n_edges, n_chan);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// data (E, C) f32, row_ptr (n_rows+1,) i32, out (n_rows, n_ops*C) f32.
// n_ops is 1 or 2; bit p of max_bits set means op p is max, else min.
int mma_segment_minmax(const void* data, const void* row_ptr, void* out, int n_rows,
                       int n_chan, int n_ops, int max_bits, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  segment_minmax_kernel<<<g.grid, g.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(row_ptr),
      static_cast<float*>(out), n_rows, n_chan, n_ops, max_bits);
  return static_cast<int>(cudaGetLastError());
}

// data (n_edges, C), out and ct (n_rows, n_ops*C), grad (n_edges, C), all
// f32; row_ptr (n_rows+1,) i32. Every edge row of grad is written.
int mma_segment_minmax_bwd(const void* data, const void* row_ptr, const void* out,
                           const void* ct, void* grad, int n_rows, int64_t n_edges,
                           int n_chan, int n_ops, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  segment_minmax_bwd_kernel<<<g.grid, g.block, 0, s>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(row_ptr),
      static_cast<const float*>(out), static_cast<const float*>(ct),
      static_cast<float*>(grad), n_rows, n_chan, n_ops);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_zero_uncovered(static_cast<float*>(grad),
                                                static_cast<const int32_t*>(row_ptr),
                                                n_rows, n_edges, n_chan, s));
}

// c (n_rows, C), hg (E, C), out (n_rows, n_ops*C), all f32; row_ptr
// (n_rows+1,) i32; seed (1,) i32 on the device, or null for no dropout;
// thresh = int(rate * 2^31), scale = f32(1 / (1 - rate)).
int mma_minmax_prog(const void* c, const void* hg, const void* row_ptr, const void* seed,
                    void* out, int n_rows, int n_chan, int n_ops, int max_bits,
                    int thresh, float scale, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  minmax_prog_kernel<<<g.grid, g.block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const float*>(hg),
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(seed),
      static_cast<float*>(out), n_rows, n_chan, n_ops, max_bits, thresh, scale);
  return static_cast<int>(cudaGetLastError());
}

// As mma_minmax_prog, plus out and ct (n_rows, n_ops*C); outputs dhg
// (n_edges, C), every edge row written, and dc (n_rows, C).
int mma_minmax_prog_bwd(const void* c, const void* hg, const void* row_ptr,
                        const void* seed, const void* out, const void* ct, void* dhg,
                        void* dc, int n_rows, int64_t n_edges, int n_chan, int n_ops,
                        int thresh, float scale, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowChannelGrid g = row_channel_grid(n_rows, n_chan);
  minmax_prog_bwd_kernel<<<g.grid, g.block, 0, s>>>(
      static_cast<const float*>(c), static_cast<const float*>(hg),
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(seed),
      static_cast<const float*>(out), static_cast<const float*>(ct),
      static_cast<float*>(dhg), static_cast<float*>(dc), n_rows, n_chan, n_ops, thresh,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_zero_uncovered(static_cast<float*>(dhg),
                                                static_cast<const int32_t*>(row_ptr),
                                                n_rows, n_edges, n_chan, s));
}

}  // extern "C"
