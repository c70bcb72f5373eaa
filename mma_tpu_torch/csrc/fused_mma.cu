// Hopper (sm_90a) kernels of the MMA node-classification forward.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (mma_tpu_torch/ops/cuda/build.py). Each entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused
// launch. Both kernels reduce over the dst-sorted CSR: every output row is
// written exactly once by the warp that owns it, so there are no atomics
// and the result is deterministic; rows with no edges get 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// Kernel 1: segment_sum_csr
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_sum_kernel (launched by
// _fused_segment_sum). out[i] = sum_{e in [row_ptr[i], row_ptr[i+1])} data[e].
//
// Bound on this card: bytes. Each edge row of `data` is read once and each
// output row written once, one FLOP per 4 bytes, far below the ridge.
// Design: one warp per destination row. The warp splits into groups of
// `lpe` lanes; a group covers up to 4*lpe channels with 16-byte loads
// (when C % 4 == 0), and the groups walk the row's edges with stride
// `groups`, so a narrow row (C=16 needs 4 lanes) still keeps all 32 lanes
// loading. The group partials combine with a fixed butterfly of shuffles,
// so the summation order is fixed. A heavy row (power-law skew) is one
// warp's sequential loop; the other warps of the SM keep the memory system
// busy meanwhile.
// ---------------------------------------------------------------------------

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void add(T& a, const T& b) {
    a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
  }
  __device__ static T shfl_xor(const T& a, int off) {
    return make_float4(__shfl_xor_sync(0xffffffffu, a.x, off),
                       __shfl_xor_sync(0xffffffffu, a.y, off),
                       __shfl_xor_sync(0xffffffffu, a.z, off),
                       __shfl_xor_sync(0xffffffffu, a.w, off));
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static void add(T& a, const T& b) { a += b; }
  __device__ static T shfl_xor(const T& a, int off) {
    return __shfl_xor_sync(0xffffffffu, a, off);
  }
};

template <int VEC>
__global__ void segment_sum_csr_kernel(const float* __restrict__ data,
                                       const int32_t* __restrict__ row_ptr,
                                       float* __restrict__ out, int n_rows,
                                       int n_vec, int lpe) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int warps = blockDim.x / kWarp;
  const int row = blockIdx.x * warps + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lpe;
  const int g = lane / lpe;
  const int li = lane % lpe;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  const T* rows = reinterpret_cast<const T*>(data);
  T* dst = reinterpret_cast<T*>(out) + static_cast<int64_t>(row) * n_vec;

  for (int base = 0; base < n_vec; base += lpe) {
    const int cv = base + li;
    T acc = V::zero();
    if (cv < n_vec) {
#pragma unroll 4
      for (int64_t e = start + g; e < end; e += groups) {
        V::add(acc, __ldg(rows + e * n_vec + cv));
      }
    }
    for (int off = lpe; off < kWarp; off <<= 1) {
      V::add(acc, V::shfl_xor(acc, off));
    }
    if (g == 0 && cv < n_vec) dst[cv] = acc;
  }
}

// ---------------------------------------------------------------------------
// Kernel 2: edge_program_lean_fwd
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_program_fwd_lean_kernel
// (launched by _fused_program_fwd_lean):
//   S[i] = sum_{e: dst_e = i} act(c[i] + h[src_e] @ W_bot) * tile(h[src_e], K)
// with act = sigmoid on lanes where pat is 1 and the identity elsewhere.
//
// Bound on this card: operations. Per edge the (1 x F)(F x K*F) product is
// 2*F*K*F FLOPs against about 4*F bytes of gathered h, i.e. 2*K*F FLOP per
// byte (256 at F=64, K=2): far above the f32 CUDA-core ridge (~20 FLOP/B).
// Design: W_bot's lane tile (F x 128 floats) sits in shared memory for the
// whole block; each lane owns 4 consecutive output lanes of a row, and one
// warp owns a whole row, so the row's sum is written once. The warp gathers
// h[src] for a batch of 4 edges into shared memory (stored [f][edge], so
// one 16-byte broadcast load gives all 4 edges' h[src, f]) and each thread
// does 16 FMAs per pair of 16-byte shared loads: W_bot is read from shared
// memory once per 4 edges instead of once per edge, which keeps the loop on
// the FMA units. The next batch's gather is issued into registers before
// the current batch's products, so its latency hides behind them. The grid
// is persistent (as many blocks as fit on the card) and rows are dealt
// round-robin over all its warps: the power-law graph's heaviest rows are
// its lowest ids, so they land on distinct warps instead of queuing on one.
// Neither logits nor messages touch device memory.
// ---------------------------------------------------------------------------

constexpr int kLaneTile = 128;     // output lanes per block (32 lanes x 4)
constexpr int kEdgeBatch = 4;      // edges per shared-memory batch
constexpr int kProgWarps = 8;      // warps per block
constexpr int kMaxF = 128;
constexpr int kStageRegs = kEdgeBatch * kMaxF / kWarp;  // gather registers

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Gathers h[src[e0 + j], ff] for the batch's kEdgeBatch x f values into
// st (element idx = lane + 32 v is edge j = idx / f, feature ff = idx % f);
// edges at or past `end` give 0.
__device__ __forceinline__ void gather_batch(float (&st)[kStageRegs],
                                             const float* __restrict__ h,
                                             const int32_t* __restrict__ src,
                                             int e0, int end, int f, int lane) {
  int j = 0, ff = lane;
  while (ff >= f) { ff -= f; ++j; }
#pragma unroll
  for (int v = 0; v < kStageRegs; ++v) {
    st[v] = 0.f;
    if (j < kEdgeBatch && e0 + j < end) {
      st[v] = __ldg(h + static_cast<int64_t>(__ldg(src + e0 + j)) * f + ff);
    }
    ff += kWarp;
    while (ff >= f) { ff -= f; ++j; }
  }
}

__global__ void __launch_bounds__(kProgWarps * kWarp)
edge_program_lean_fwd_kernel(const float* __restrict__ c,
                             const float* __restrict__ h,
                             const float* __restrict__ w_bot,
                             const float* __restrict__ pat,
                             const int32_t* __restrict__ src,
                             const int32_t* __restrict__ row_ptr,
                             float* __restrict__ out, int n_rows, int f,
                             int kf) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;                                  // [f][kLaneTile]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* h_s = smem + f * kLaneTile + warp * f * kEdgeBatch;  // [f][edge]

  const int l_base = blockIdx.y * kLaneTile;
  for (int idx = threadIdx.x; idx < f * kLaneTile; idx += blockDim.x) {
    const int ff = idx / kLaneTile;
    const int l = l_base + idx % kLaneTile;
    w_s[idx] = l < kf ? w_bot[static_cast<int64_t>(ff) * kf + l] : 0.f;
  }
  __syncthreads();

  const int l0 = l_base + lane * 4;  // this thread's 4 output lanes
  const bool active = l0 < kf;      // kf % 4 == 0, so all 4 or none
  float p[4];
  int hl[4];  // lane l reads h[src, l mod F]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    p[q] = active ? pat[l0 + q] : 0.f;
    hl[q] = (l0 + q) % f;
  }
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + lane;
  const float4* hs4 = reinterpret_cast<const float4*>(h_s);
  float st[kStageRegs];

  const int n_warps = gridDim.x * kProgWarps;
  for (int row = blockIdx.x * kProgWarps + warp; row < n_rows; row += n_warps) {
    const int start = row_ptr[row];
    const int end = row_ptr[row + 1];
    float4 ci = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) {
      ci = *reinterpret_cast<const float4*>(c + static_cast<int64_t>(row) * kf + l0);
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    if (start < end) gather_batch(st, h, src, start, end, f, lane);

    for (int e0 = start; e0 < end; e0 += kEdgeBatch) {
      const int nb = min(kEdgeBatch, end - e0);
      __syncwarp();  // the previous batch's reads of h_s are done
      {
        int j = 0, ff = lane;
        while (ff >= f) { ff -= f; ++j; }
#pragma unroll
        for (int v = 0; v < kStageRegs; ++v) {
          if (j < kEdgeBatch) h_s[ff * kEdgeBatch + j] = st[v];
          ff += kWarp;
          while (ff >= f) { ff -= f; ++j; }
        }
      }
      __syncwarp();
      if (e0 + kEdgeBatch < end) {
        gather_batch(st, h, src, e0 + kEdgeBatch, end, f, lane);  // in flight below
      }

      float lg[kEdgeBatch][4];
#pragma unroll
      for (int j = 0; j < kEdgeBatch; ++j) {
        lg[j][0] = ci.x; lg[j][1] = ci.y; lg[j][2] = ci.z; lg[j][3] = ci.w;
      }
#pragma unroll 4
      for (int ff = 0; ff < f; ++ff) {
        const float4 wv = w4[ff * (kLaneTile / 4)];
        const float4 hv = hs4[ff];
        const float hj[kEdgeBatch] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int j = 0; j < kEdgeBatch; ++j) {
          lg[j][0] = fmaf(hj[j], wv.x, lg[j][0]);
          lg[j][1] = fmaf(hj[j], wv.y, lg[j][1]);
          lg[j][2] = fmaf(hj[j], wv.z, lg[j][2]);
          lg[j][3] = fmaf(hj[j], wv.w, lg[j][3]);
        }
      }
      if (active) {
        // Unrolled with a guard (not a loop to nb) so that lg stays in
        // registers; edges are added in CSR order.
#pragma unroll
        for (int j = 0; j < kEdgeBatch; ++j) {
          if (j < nb) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float m = p[q] != 0.f ? sigmoidf(lg[j][q]) : lg[j][q];
              acc[q] = fmaf(m, h_s[hl[q] * kEdgeBatch + j], acc[q]);
            }
          }
        }
      }
    }
    if (active) {
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(row) * kf + l0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  }
}

}  // namespace

extern "C" {

const char* mma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// data (E, C) f32, row_ptr (n_rows+1,) i32, out (n_rows, C) f32. vec4 != 0
// requires C % 4 == 0 and 16-byte aligned data/out.
int mma_segment_sum_csr(const void* data, const void* row_ptr, void* out,
                        int n_rows, int n_chan, int vec4, void* stream) {
  const int threads = 256;
  const int blocks = (n_rows + threads / kWarp - 1) / (threads / kWarp);
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const int n_vec = vec4 ? n_chan / 4 : n_chan;
  int lpe = 1;
  while (lpe < n_vec && lpe < kWarp) lpe <<= 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    segment_sum_csr_kernel<4><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(data), static_cast<const int32_t*>(row_ptr),
        static_cast<float*>(out), n_rows, n_vec, lpe);
  } else {
    segment_sum_csr_kernel<1><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(data), static_cast<const int32_t*>(row_ptr),
        static_cast<float*>(out), n_rows, n_vec, lpe);
  }
  return static_cast<int>(cudaGetLastError());
}

// c (n_rows, kf), h (n_rows, f), w_bot (f, kf), pat (kf,) 0/1 f32,
// src (E,) i32, row_ptr (n_rows+1,) i32, out (n_rows, kf) f32.
// Requires f % 4 == 0, f <= 128, kf % f == 0, kf <= 512, 16-byte aligned
// c/out.
int mma_edge_program_lean_fwd(const void* c, const void* h, const void* w_bot,
                              const void* pat, const void* src,
                              const void* row_ptr, void* out, int n_rows,
                              int f, int kf, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(f) * kLaneTile +
                       static_cast<size_t>(kProgWarps) * f * kEdgeBatch);
  cudaError_t err = cudaFuncSetAttribute(
      edge_program_lean_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Persistent grid: as many blocks per lane tile as fit on the card at
  // once, but no more than the rows need.
  int device = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edge_program_lean_fwd_kernel, kProgWarps * kWarp, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_rows + kProgWarps - 1) / kProgWarps;
  dim3 grid(min(row_blocks, max(1, n_sm * per_sm)),
            (kf + kLaneTile - 1) / kLaneTile);
  edge_program_lean_fwd_kernel<<<grid, kProgWarps * kWarp, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(c), static_cast<const float*>(h),
      static_cast<const float*>(w_bot), static_cast<const float*>(pat),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(row_ptr),
      static_cast<float*>(out), n_rows, f, kf);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
