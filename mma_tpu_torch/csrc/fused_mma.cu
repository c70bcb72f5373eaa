// Hopper (sm_90a) kernels of the MMA node-classification forward and
// backward (the lean and the wide edge program) and of the ZINC
// convolution's sum and sum-of-squares reductions.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (mma_tpu_torch/ops/cuda/build.py). Each entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused
// launch. Every kernel reduces over the dst-sorted CSR (or its CSC twin)
// in a fixed order: each output element is written exactly once, so there
// are no atomics and the results are deterministic; rows with no edges
// get 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;

// ---------------------------------------------------------------------------
// Kernel 1: segment_sum_csr
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_sum_kernel (launched by
// _fused_segment_sum). out[i] = sum_{e in [row_ptr[i], row_ptr[i+1])} data[e],
// or data[index[e]] when an index is given: the CSC / by-src / gather-VJP
// uses read their rows through the index instead of a permuted copy.
//
// Bound on this card: bytes, one FLOP per 4 bytes, far below the ridge.
// Counted as chip_smoke.py counts it (each input read once, each output
// written once): the node table (indexed) or the edge rows, the CSR, the
// index and the output; 0.023 ms at the synthetic-large graph's C=64
// indexed sum (E = 2.1M, N = 131k). The gathered rows themselves are
// E*C*4 B: 537 MB at C=64, 0.160 ms at 3.35 TB/s, and 0.48 ms at C=192.
// A sum can beat that figure when the table it gathers from stays in the
// 50 MB L2: the C=64 node table is 33.5 MB, so most gathers hit the L2.
//
// Design: an edge-balanced two-pass sum, the card's form of the TPU
// kernel's grid flattened over (row block, edge chunk). A power-law graph
// puts up to 1,448 edges in one row; a warp per row would make that row
// one warp's sequential loop and the floor of the whole launch.
//
// Pass 1 (segment_sum_chunk_kernel): the edge positions [0, E) split into
// chunks of `chunk` edges, one warp each. The warp finds the rows that
// start inside its chunk by two 32-ary searches of row_ptr (merge-path),
// loads row_ptr (and, for a row the whole warp takes, the index) 32
// entries at a time with one coalesced load and hands them out by
// __shfl_sync, then walks its rows in order. Groups
// of `lpe` lanes cover the channels, each lane `tiles` slots of 16-byte
// loads (C % 4 == 0) or scalars, several edges' loads in flight before
// their adds. A row that fills at least half a warp step takes the whole
// warp: the groups stride over its edges and combine with a fixed
// butterfly of shuffles. Shorter rows (narrow C: Cora, the classes' C=16)
// go one to a group, `groups` rows at a time, each in CSR order, so a warp
// is not one row's memory latency after another.
//
// A row of at most max(chunk, kSumMinSplit) edges belongs whole to the
// chunk it starts in, which writes it directly (an empty one as 0), even
// where it runs on past the chunk. It is summed as a warp per row would, so
// where one group covers a row (the ZINC widths) it keeps the plain
// version's sequential bits, which the std aggregator's cancelling
// gradient needs: splitting ZINC's 4-edge rows moved a PNA train step's
// embedding gradient by 2e-3 relative. A longer row is split at the chunk
// boundaries: the partial of the row that enters the chunk from an
// earlier one goes to the chunk's head slot, and that of the chunk's last
// row, when it goes on past the chunk, to its tail slot: scratch
// (n_chunks, 2, C), and the tail row's id to tail_row.
// Pass 2 (segment_sum_fixup_kernel): one warp per chunk with a tail row
// adds the tail and the later chunks' heads in chunk order and writes the
// row once.
//
// Every output row is written exactly once, with no atomics, and the
// partition depends only on E (the data's or the index's length, which
// bounds row_ptr[n]), never on the card: results are bitwise equal run to
// run, and the host never reads row_ptr (no sync; the launch can be
// captured in a CUDA graph). Positions outside [row_ptr[0], row_ptr[n])
// are nobody's edges; row_ptr[0] may be above 0.
//
// The chunk size: E / kSumTargetChunks rounded up to a power of two, at
// least kSumMinChunk. 8,192 chunks fill the card's resident warps about
// once, and a heavy row splits into chunk-sized pieces. A fixed large
// chunk would leave a small graph (Cora, 10.6k edges) a few dozen warps
// that each walk hundreds of edges; its floor of 16 edges gives Cora 672
// warps of about 4 rows. Rows of up to kSumMinSplit = 64 edges are never
// split, whatever the chunk, so that a ZINC molecule (at most 38 atoms)
// stays whole in the pooling sum.
// ---------------------------------------------------------------------------

constexpr int kSumTargetChunks = 8192;
constexpr int kSumMinChunk = 16;
constexpr int kSumMinSplit = 64;  // rows of at most max(chunk, 64) edges stay whole
constexpr int kSumWarps = 8;  // warps per block, both passes

int sum_chunk_edges(int n_edges) {
  int chunk = kSumMinChunk;
  while (static_cast<int64_t>(chunk) * kSumTargetChunks < n_edges) chunk <<= 1;
  return chunk;
}

int sum_n_chunks(int n_edges) {
  const int chunk = sum_chunk_edges(n_edges);
  return max(1, (n_edges + chunk - 1) / chunk);
}

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

// For keys[0] and keys[1] at once, the first i in [0, n] with
// row_ptr[i] >= key (n if none): a 32-ary search, one probe a lane and key
// per step, so 4 steps for 131k rows. Warp-uniform.
__device__ __forceinline__ void lower_bound2(const int32_t* __restrict__ row_ptr, int n,
                                             const int64_t keys[2], int found[2]) {
  const int lane = threadIdx.x % kWarp;
  int lo[2] = {0, 0}, hi[2] = {n, n};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2];
    bool pred[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      step[k] = (hi[k] - lo[k] + kWarp - 1) / kWarp;
      const int64_t q = lo[k] + static_cast<int64_t>(lane + 1) * step[k] - 1;
      pred[k] = lo[k] >= hi[k] || q >= hi[k] || __ldg(row_ptr + q) >= keys[k];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const unsigned m = __ballot_sync(0xffffffffu, pred[k]);
      if (lo[k] >= hi[k]) continue;
      if (m == 0) {  // every probe below the key, the last one at hi - 1
        lo[k] = hi[k];
      } else {
        const int f = __ffs(m) - 1;
        const int nlo = lo[k] + f * step[k];
        hi[k] = min(hi[k], lo[k] + (f + 1) * step[k] - 1);
        lo[k] = nlo;
      }
    }
  }
  found[0] = lo[0];
  found[1] = lo[1];
}

// The data row that edge position e reads, or -1 past the end re.
__device__ __forceinline__ int64_t edge_row(const int32_t* __restrict__ index, int64_t e,
                                            int64_t re) {
  return e < re ? (index != nullptr ? static_cast<int64_t>(__ldg(index + e)) : e) : -1;
}

// Pass 1. TILES: the lane's channel slots per edge (a compile-time bound
// on `tiles`; wider rows take several rounds over the row's edges). U:
// edges a group loads before it adds them, about 32 floats in flight a
// lane.
template <int VEC, int TILES>
__global__ void __launch_bounds__(kSumWarps* kWarp)
segment_sum_chunk_kernel(const float* __restrict__ data, const int32_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ index, float* __restrict__ out,
                         float* __restrict__ part, int32_t* __restrict__ tail_row,
                         int n_rows, int n_vec, int lpe, int tiles, int chunk, int n_chunks) {
  using V = Vec<VEC>;
  using T = typename V::T;
  constexpr int U = TILES * VEC >= 12 ? 2 : (TILES * VEC >= 8 ? 4 : 8);
  const int c = blockIdx.x * kSumWarps + threadIdx.x / kWarp;
  if (c >= n_chunks) return;  // whole warps leave together
  const int lane = threadIdx.x % kWarp;
  const int groups = kWarp / lpe;
  const int g = lane / lpe;
  const int li = lane % lpe;
  const int uu = min(U, kWarp / groups);  // a step's edges fit one index window
  const int step = groups * uu;
  const int split = max(chunk, kSumMinSplit);  // longer rows are split at chunk boundaries

  const int64_t a = static_cast<int64_t>(c) * chunk;
  const int64_t b = a + chunk;
  const int64_t keys[2] = {a, b};
  int found[2];
  lower_bound2(row_ptr, n_rows, keys, found);
  // Rows [i0, i1) start inside the chunk (the last chunk also takes the
  // empty rows that start at row_ptr[n] == E); row i0 - 1 enters it from
  // an earlier chunk when it ends past a and is longer than `split`.
  const int i0 = found[0];
  const int i1 = c == n_chunks - 1 ? n_rows : found[1];
  const int64_t hi = __ldg(row_ptr + n_rows);
  const int32_t* rp_i0 = row_ptr + i0;
  const int32_t* rp_i1 = row_ptr + i1;
  const bool head = i0 > 0 && __ldg(rp_i0) > a && __ldg(rp_i0) - __ldg(rp_i0 - 1) > split;
  const bool tail = i1 > i0 && __ldg(rp_i1) > b && __ldg(rp_i1) - __ldg(rp_i1 - 1) > split;
  if (lane == 0) tail_row[c] = tail ? i1 - 1 : -1;

  const T* rows = reinterpret_cast<const T*>(data);
  T* outv = reinterpret_cast<T*>(out);
  T* head_slot = reinterpret_cast<T*>(part) + static_cast<int64_t>(c) * 2 * n_vec;
  T* tail_slot = head_slot + n_vec;
  int64_t wb = -2 * kWarp;  // the index window [wb, wb + 32), empty at first
  int widx = 0;

  for (int rb = head ? i0 - 1 : i0; rb < i1; rb += kWarp) {
    const int r = rb + lane;
    const bool live = r < i1;
    const int s = live ? __ldg(row_ptr + r) : 0;
    const int e = live ? __ldg(row_ptr + r + 1) : 0;
    const unsigned live_mask = __ballot_sync(0xffffffffu, live);
    const unsigned empty = __ballot_sync(0xffffffffu, live && s == e);
    if (empty == live_mask) {  // a run of empty rows, all owned: write 0
      T* z = outv + static_cast<int64_t>(rb) * n_vec;
      const int64_t n_z = static_cast<int64_t>(__popc(live_mask)) * n_vec;
      for (int64_t i = lane; i < n_z; i += kWarp) z[i] = V::zero();
      continue;
    }
    // Rows shorter than half a warp step: one row a group, `groups` rows at
    // a time, each summed in CSR order, the next step's rows fetched before
    // this step's adds. The other rows take the whole warp, one at a time.
    const int64_t my_re = e - s > split && e > b ? b : e;
    const unsigned batched = __ballot_sync(
        0xffffffffu, groups > 1 && live && 2 * (my_re - (s > a ? s : a)) <= step);
    unsigned m = batched;
    while (m) {
      int mine = -1;
      for (int i = 0; i < groups && m != 0; ++i) {
        const int k = __ffs(m) - 1;
        m &= m - 1;
        if (i == g) mine = k;
      }
      const int kk = mine < 0 ? 0 : mine;
      const int64_t row_s = __shfl_sync(0xffffffffu, s, kk);
      const int64_t row_e = __shfl_sync(0xffffffffu, e, kk);
      const int64_t rs = mine < 0 ? 0 : (row_s > a ? row_s : a);
      const int64_t re = mine < 0 ? 0 : (row_e - row_s > split && row_e > b ? b : row_e);
      const unsigned max_len = __reduce_max_sync(0xffffffffu, static_cast<unsigned>(re - rs));
      const int row = rb + kk;
      T* dst = row < i0 ? head_slot
                        : (tail && row == i1 - 1 ? tail_slot
                                                 : outv + static_cast<int64_t>(row) * n_vec);
      for (int t0 = 0; t0 < tiles; t0 += TILES) {
        T acc[TILES];
#pragma unroll
        for (int t = 0; t < TILES; ++t) acc[t] = V::zero();
        int64_t src[U];
#pragma unroll
        for (int u = 0; u < U; ++u) src[u] = edge_row(index, rs + u, re);
        for (unsigned j = 0; j < max_len; j += U) {
          T v[U][TILES];
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < TILES; ++t) {
              const int cv = (t0 + t) * lpe + li;
              v[u][t] = src[u] >= 0 && cv < n_vec ? __ldg(rows + src[u] * n_vec + cv)
                                                  : V::zero();
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) src[u] = edge_row(index, rs + j + U + u, re);
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < TILES; ++t) V::add(acc[t], v[u][t]);
          }
        }
        if (mine >= 0) {
#pragma unroll
          for (int t = 0; t < TILES; ++t) {
            const int cv = (t0 + t) * lpe + li;
            if (cv < n_vec) dst[cv] = acc[t];
          }
        }
      }
    }
    unsigned todo = live_mask & ~batched;
    while (todo) {
      const int k = __ffs(todo) - 1;
      todo &= todo - 1;
      const int row = rb + k;
      const int64_t row_s = __shfl_sync(0xffffffffu, s, k);
      const int64_t row_e = __shfl_sync(0xffffffffu, e, k);
      // A long row's edges inside this chunk; a short one whole.
      const int64_t rs = row_s > a ? row_s : a;
      const int64_t re = row_e - row_s > split && row_e > b ? b : row_e;
      T* dst = row < i0 ? head_slot
                        : (tail && row == i1 - 1 ? tail_slot
                                                 : outv + static_cast<int64_t>(row) * n_vec);
      for (int t0 = 0; t0 < tiles; t0 += TILES) {
        T acc[TILES];
#pragma unroll
        for (int t = 0; t < TILES; ++t) acc[t] = V::zero();
        for (int64_t e0 = rs; e0 < re; e0 += step) {
          if (index != nullptr && (e0 < wb || e0 + step > wb + kWarp)) {
            wb = e0;
            widx = wb + lane < hi ? __ldg(index + wb + lane) : 0;
          }
          int64_t src[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int64_t ee = e0 + u * groups + g;
            const int j = index != nullptr
                              ? __shfl_sync(0xffffffffu, widx, static_cast<int>((ee - wb) & 31))
                              : 0;
            src[u] = u < uu && ee < re ? (index != nullptr ? j : ee) : -1;
          }
          T v[U][TILES];
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < TILES; ++t) {
              const int cv = (t0 + t) * lpe + li;
              v[u][t] = src[u] >= 0 && cv < n_vec ? __ldg(rows + src[u] * n_vec + cv)
                                                  : V::zero();
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < TILES; ++t) V::add(acc[t], v[u][t]);
          }
        }
        if (rs < re) {
#pragma unroll
          for (int t = 0; t < TILES; ++t) {
            for (int off = lpe; off < kWarp; off <<= 1) {
              V::add(acc[t], V::shfl_xor(acc[t], off));
            }
          }
        }
        if (g == 0) {
#pragma unroll
          for (int t = 0; t < TILES; ++t) {
            const int cv = (t0 + t) * lpe + li;
            if (cv < n_vec) dst[cv] = acc[t];
          }
        }
      }
    }
  }
}

// Pass 2: the long rows that cross a chunk boundary, one warp per chunk
// whose tail row goes on: the tail partial, then the heads of the later
// chunks the row reaches, in chunk order.
template <int VEC>
__global__ void __launch_bounds__(kSumWarps* kWarp)
segment_sum_fixup_kernel(const int32_t* __restrict__ row_ptr, const float* __restrict__ part,
                         const int32_t* __restrict__ tail_row, float* __restrict__ out,
                         int n_vec, int chunk, int n_chunks) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int c = blockIdx.x * kSumWarps + threadIdx.x / kWarp;
  if (c >= n_chunks) return;
  const int row = __ldg(tail_row + c);
  if (row < 0) return;
  const int64_t end = __ldg(row_ptr + row + 1);
  const T* slots = reinterpret_cast<const T*>(part);
  T* dst = reinterpret_cast<T*>(out) + static_cast<int64_t>(row) * n_vec;
  for (int cv = threadIdx.x % kWarp; cv < n_vec; cv += kWarp) {
    T acc = slots[(2 * static_cast<int64_t>(c) + 1) * n_vec + cv];
    for (int64_t c2 = c + 1; c2 * chunk < end; ++c2) {
      V::add(acc, slots[2 * c2 * n_vec + cv]);
    }
    dst[cv] = acc;
  }
}

template <int VEC, int TILES>
cudaError_t launch_segment_sum(const void* data, const void* row_ptr, const void* index,
                               void* out, void* part, void* tail_row, int n_rows, int n_vec,
                               int lpe, int tiles, int chunk, int n_chunks, cudaStream_t s) {
  const int blocks = (n_chunks + kSumWarps - 1) / kSumWarps;
  segment_sum_chunk_kernel<VEC, TILES><<<blocks, kSumWarps * kWarp, 0, s>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(index), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int32_t*>(tail_row), n_rows, n_vec, lpe, tiles, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_sum_fixup_kernel<VEC><<<blocks, kSumWarps * kWarp, 0, s>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const float*>(part),
      static_cast<const int32_t*>(tail_row), static_cast<float*>(out), n_vec, chunk, n_chunks);
  return cudaGetLastError();
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
// edges at or past `end` give 0. NREG * 32 must be at least kEdgeBatch * f.
template <int NREG>
__device__ __forceinline__ void gather_batch(float (&st)[NREG],
                                             const float* __restrict__ h,
                                             const int32_t* __restrict__ src,
                                             int e0, int end, int f, int lane) {
  int j = 0, ff = lane;
  while (ff >= f) { ff -= f; ++j; }
#pragma unroll
  for (int v = 0; v < NREG; ++v) {
    st[v] = 0.f;
    if (j < kEdgeBatch && e0 + j < end) {
      st[v] = __ldg(h + static_cast<int64_t>(__ldg(src + e0 + j)) * f + ff);
    }
    ff += kWarp;
    while (ff >= f) { ff -= f; ++j; }
  }
}

// Stores a gathered batch into the warp's h_s, laid out [f][edge] so that
// one 16-byte broadcast load gives h[src, ff] for all kEdgeBatch edges.
template <int NREG>
__device__ __forceinline__ void stage_batch(float* __restrict__ h_s,
                                            const float (&st)[NREG], int f,
                                            int lane) {
  int j = 0, ff = lane;
  while (ff >= f) { ff -= f; ++j; }
#pragma unroll
  for (int v = 0; v < NREG; ++v) {
    if (j < kEdgeBatch) h_s[ff * kEdgeBatch + j] = st[v];
    ff += kWarp;
    while (ff >= f) { ff -= f; ++j; }
  }
}

// Logits of a batch on this thread's 4 lanes:
// lg[j][q] = c[row, l0 + q] + sum_ff h[src_j, ff] * W_bot[ff, l0 + q].
// w4 points at this thread's 4 lanes of the shared W_bot tile, hs4 at the
// warp's staged batch.
__device__ __forceinline__ void batch_logits(float (&lg)[kEdgeBatch][4],
                                             const float4 ci,
                                             const float4* __restrict__ w4,
                                             const float4* __restrict__ hs4,
                                             int f) {
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
      stage_batch(h_s, st, f, lane);
      __syncwarp();
      if (e0 + kEdgeBatch < end) {
        gather_batch(st, h, src, e0 + kEdgeBatch, end, f, lane);  // in flight below
      }

      float lg[kEdgeBatch][4];
      batch_logits(lg, ci, w4, hs4, f);
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

// ---------------------------------------------------------------------------
// Kernel 3: edge_program_lean_bwd
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_program_bwd_lean_kernel
// (launched by _fused_program_bwd_lean). For each edge e of row i over the
// CSR, with s = src_e, logits = c[i] + h[s] @ W_bot, sig = sigmoid(logits):
//   mask = pat ? sig : logits,  dmask = pat ? sig (1 - sig) : 1,
//   dlog_e = ct[i] * tile(h[s], K) * dmask,
// and it emits
//   dc[i]      = sum_{e in row i} dlog_e                     (N, K*F)
//   dW_bot     = sum_e h[s]^T dlog_e                         (F, K*F)
//   payload[e] = sum_k (ct[i] * mask_e)_k + dlog_e @ W_bot^T (E, F)
// Edges outside [row_ptr[0], row_ptr[n_rows]) get payload 0. The caller
// reduces the payload by source (kernel 1 over the CSC) to form dh.
//
// Bound on this card: operations. Per edge it does three (1 x F)(F x K*F)
// products (the logits again, dlog @ W_bot^T, and the outer product into
// dW_bot), 6*F*K*F FLOPs against about 4*F gathered bytes.
// Design: kernel 2's structure (persistent grid, rows dealt round-robin to
// warps, a 128-lane tile of W_bot in shared memory, batches of 4 edges
// gathered into shared memory as [f][edge]) plus a W_bot^T tile, so that
// a lane owning output feature ff reads W_bot^T[l][ff] without bank
// conflicts for the payload product. ct[i] and c[i] are constant over a
// row, so a warp loads its 4 lanes of each once per row. dc and payload
// are written once each, by the warp that owns the row. dW_bot is a sum
// over every edge and takes no atomics: each block keeps its (F x 128)
// partial in registers spread over its 256 threads (thread = rows
// warp + 8 r, lanes lane + 32 q) and, once per step, all warps stage their
// batch's h[src] and dlog in shared memory and the whole block adds them
// in a fixed order (warp 0..7, edge 0..3). The block partials go to a
// (G, F, K*F) buffer that sum_slabs_kernel adds in block order: with the
// grid size G fixed by the card, dW_bot is bitwise equal run to run. A
// K*F above 128 takes one block column per lane tile, and the payload
// partials of the tiles are added by the same fixed-order pass.
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;

inline size_t bwd_smem_bytes(int f) {
  return sizeof(float) * (2 * static_cast<size_t>(f) * kLaneTile +
                          static_cast<size_t>(kBwdWarps) *
                              (static_cast<size_t>(f) * kEdgeBatch +
                               2 * kLaneTile * kEdgeBatch)) +
         sizeof(int) * kBwdWarps;
}

// FMAX (64 or 128) bounds F; it sizes the per-thread register arrays.
template <int FMAX>
__global__ void __launch_bounds__(kBwdWarps * kWarp)
edge_program_lean_bwd_kernel(const float* __restrict__ c,
                             const float* __restrict__ h,
                             const float* __restrict__ w_bot,
                             const float* __restrict__ pat,
                             const int32_t* __restrict__ src,
                             const int32_t* __restrict__ row_ptr,
                             const float* __restrict__ ct,
                             float* __restrict__ dc,
                             float* __restrict__ dw_part,
                             float* __restrict__ payload_tiles, int n_rows,
                             int n_edges, int f, int kf) {
  constexpr int kRows = FMAX / kBwdWarps;  // dW_bot rows per thread
  constexpr int kOut = FMAX / kWarp;       // payload features per lane
  constexpr int kRegs = kEdgeBatch * FMAX / kWarp;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* w_s = smem;                       // [f][kLaneTile]
  float* wt_s = w_s + f * kLaneTile;       // [kLaneTile][f]
  float* h_all = wt_s + kLaneTile * f;     // per warp [f][edge]
  float* dl_all = h_all + kBwdWarps * f * kEdgeBatch;           // per warp [l][edge]
  float* gm_all = dl_all + kBwdWarps * kLaneTile * kEdgeBatch;  // per warp [l][edge]
  int* nb_s = reinterpret_cast<int*>(gm_all + kBwdWarps * kLaneTile * kEdgeBatch);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* h_s = h_all + warp * f * kEdgeBatch;
  float* dl_s = dl_all + warp * kLaneTile * kEdgeBatch;
  float* gm_s = gm_all + warp * kLaneTile * kEdgeBatch;

  const int l_base = blockIdx.y * kLaneTile;
  const int n_l = min(kLaneTile, kf - l_base);  // lanes of this tile
  float* payload = payload_tiles + static_cast<int64_t>(blockIdx.y) * n_edges * f;

  // Edges no row covers get payload 0.
  {
    const int64_t lo = static_cast<int64_t>(row_ptr[0]) * f;
    const int64_t hi = static_cast<int64_t>(row_ptr[n_rows]) * f;
    const int64_t all = static_cast<int64_t>(n_edges) * f;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < all - hi + lo; i += stride) {
      payload[i < lo ? i : hi + (i - lo)] = 0.f;
    }
  }

  for (int idx = threadIdx.x; idx < f * kLaneTile; idx += blockDim.x) {
    const int ff = idx / kLaneTile;
    const int l = idx % kLaneTile;
    const float v = l < n_l ? w_bot[static_cast<int64_t>(ff) * kf + l_base + l] : 0.f;
    w_s[idx] = v;
    wt_s[l * f + ff] = v;
  }
  __syncthreads();

  const int l0 = l_base + lane * 4;  // this thread's 4 lanes (logits, dc)
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

  float dw[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    dw[r][0] = dw[r][1] = dw[r][2] = dw[r][3] = 0.f;
  }

  // The warp's current row: edges [e0, end), c and ct on its 4 lanes, and
  // its dc sums. next_row() writes the sums of a finished row, skips (and
  // zeroes) empty rows, and loads the next non-empty one.
  const int n_warps = gridDim.x * kBwdWarps;
  int row = blockIdx.x * kBwdWarps + warp;
  int e0 = 0, end = 0;
  float4 ci = make_float4(0.f, 0.f, 0.f, 0.f), cti = ci;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  auto store_dc = [&](int r) {
    if (active) {
      *reinterpret_cast<float4*>(dc + static_cast<int64_t>(r) * kf + l0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  };
  auto seek_row = [&]() {
    for (; row < n_rows; row += n_warps) {
      e0 = row_ptr[row];
      end = row_ptr[row + 1];
      acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
      if (e0 < end) {
        if (active) {
          ci = *reinterpret_cast<const float4*>(c + static_cast<int64_t>(row) * kf + l0);
          cti = *reinterpret_cast<const float4*>(ct + static_cast<int64_t>(row) * kf + l0);
        }
        return;
      }
      store_dc(row);  // an empty row's sums are 0
    }
  };
  seek_row();
  bool has = row < n_rows;

  while (__syncthreads_or(has)) {
    int nb = 0;
    if (has) {
      nb = min(kEdgeBatch, end - e0);
      float st[kRegs];
      gather_batch(st, h, src, e0, end, f, lane);
      stage_batch(h_s, st, f, lane);
      __syncwarp();

      float lg[kEdgeBatch][4];
      batch_logits(lg, ci, w4, hs4, f);
      const float cq[4] = {cti.x, cti.y, cti.z, cti.w};
      float dl[4][kEdgeBatch], gm[4][kEdgeBatch];
#pragma unroll
      for (int j = 0; j < kEdgeBatch; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool valid = active && j < nb;
          const float x = lg[j][q];
          const float sg = sigmoidf(x);
          const float m = p[q] != 0.f ? sg : x;
          const float dm = p[q] != 0.f ? sg * (1.f - sg) : 1.f;
          const float ht = h_s[hl[q] * kEdgeBatch + j];
          dl[q][j] = valid ? cq[q] * ht * dm : 0.f;
          gm[q][j] = valid ? cq[q] * m : 0.f;
          acc[q] += dl[q][j];  // edges in CSR order
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = lane * 4 + q;
        reinterpret_cast<float4*>(dl_s)[l] = make_float4(dl[q][0], dl[q][1], dl[q][2], dl[q][3]);
        reinterpret_cast<float4*>(gm_s)[l] = make_float4(gm[q][0], gm[q][1], gm[q][2], gm[q][3]);
      }
      __syncwarp();

      // payload[e, ff] for ff = lane + 32 o: the dlog @ W_bot^T product over
      // the tile's lanes, then the (ct * mask) lanes with l mod F == ff.
      float pv[kOut][kEdgeBatch];
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
#pragma unroll
        for (int j = 0; j < kEdgeBatch; ++j) pv[o][j] = 0.f;
      }
      const float4* dl4 = reinterpret_cast<const float4*>(dl_s);
      const float4* gm4 = reinterpret_cast<const float4*>(gm_s);
#pragma unroll 4
      for (int l = 0; l < n_l; ++l) {
        const float4 d = dl4[l];
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          const int ff = lane + kWarp * o;
          if (ff < f) {
            const float wv = wt_s[l * f + ff];
            pv[o][0] = fmaf(d.x, wv, pv[o][0]);
            pv[o][1] = fmaf(d.y, wv, pv[o][1]);
            pv[o][2] = fmaf(d.z, wv, pv[o][2]);
            pv[o][3] = fmaf(d.w, wv, pv[o][3]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const int ff = lane + kWarp * o;
        if (ff < f) {
          for (int l = ((ff - l_base) % f + f) % f; l < n_l; l += f) {
            const float4 g = gm4[l];
            pv[o][0] += g.x; pv[o][1] += g.y; pv[o][2] += g.z; pv[o][3] += g.w;
          }
#pragma unroll
          for (int j = 0; j < kEdgeBatch; ++j) {
            if (j < nb) payload[static_cast<int64_t>(e0 + j) * f + ff] = pv[o][j];
          }
        }
      }

      e0 += kEdgeBatch;
      if (e0 >= end) {
        store_dc(row);
        row += n_warps;
        seek_row();
        has = row < n_rows;
      }
    }
    if (lane == 0) nb_s[warp] = nb;
    __syncthreads();  // every warp's batch is staged

    // dW_bot partial: rows ff = warp + 8 r, tile lanes lane + 32 q.
    for (int w = 0; w < kBwdWarps; ++w) {
      if (nb_s[w] == 0) continue;
      const float4* d4 = reinterpret_cast<const float4*>(dl_all + w * kLaneTile * kEdgeBatch);
      const float4* h4 = reinterpret_cast<const float4*>(h_all + w * f * kEdgeBatch);
      float4 dv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) dv[q] = d4[lane + kWarp * q];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int ff = warp + kBwdWarps * r;
        if (ff < f) {
          const float4 hv = h4[ff];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dw[r][q] = fmaf(hv.x, dv[q].x, dw[r][q]);
            dw[r][q] = fmaf(hv.y, dv[q].y, dw[r][q]);
            dw[r][q] = fmaf(hv.z, dv[q].z, dw[r][q]);
            dw[r][q] = fmaf(hv.w, dv[q].w, dw[r][q]);
          }
        }
      }
    }
    // The loop's __syncthreads_or keeps the next batch's staging behind
    // these reads.
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ff = warp + kBwdWarps * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int l = lane + kWarp * q;
      if (ff < f && l < n_l) {
        dw_part[(static_cast<int64_t>(blockIdx.x) * f + ff) * kf + l_base + l] = dw[r][q];
      }
    }
  }
}

// out[i] = sum_{p < n_parts} parts[p * len + i], added in order p = 0, 1, ...
__global__ void sum_slabs_kernel(const float* __restrict__ parts, int n_parts,
                                 int64_t len, float* __restrict__ out) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < len; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
#pragma unroll 8
    for (int p = 0; p < n_parts; ++p) s += __ldg(parts + p * len + i);
    out[i] = s;
  }
}

cudaError_t launch_sum_slabs(const float* parts, int n_parts, int64_t len,
                             float* out, cudaStream_t s) {
  const int threads = 256;
  int64_t blocks = (len + threads - 1) / threads;
  if (blocks > 4096) blocks = 4096;
  sum_slabs_kernel<<<static_cast<int>(blocks), threads, 0, s>>>(parts, n_parts, len, out);
  return cudaGetLastError();
}

template <int FMAX>
cudaError_t bwd_occupancy(int f, int* per_sm) {
  const size_t smem = bwd_smem_bytes(f);
  cudaError_t err = cudaFuncSetAttribute(edge_program_lean_bwd_kernel<FMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, edge_program_lean_bwd_kernel<FMAX>, kBwdWarps * kWarp, smem);
}

// ---------------------------------------------------------------------------
// Kernel 8: segment_sum_sq_csr
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_sumsq_kernel (launched by
// _fused_segment_sum_sq): out[i, :C] = sum_e data[e], out[i, C:] =
// sum_e data[e]^2 over e in [row_ptr[i], row_ptr[i+1]), the var/std
// aggregators' input in one pass over the edge data.
//
// Bound on this card: bytes (three operations per 4-byte element read).
// Design: kernel 4's layout (segment_minmax.cu). One thread per
// (destination row, channel); channels run along threadIdx.x, so each
// edge's C-wide row is read coalesced with scalar loads (ZINC's C = 375 is
// not a multiple of 4), and the thread walks the row's edges in CSR order.
// ZINC's in-degree is at most 4, so each walk is short. Both sums use
// rounded operations (no FMA contraction), so the kernel gives the plain
// version's slot-by-slot sums bit for bit.
// ---------------------------------------------------------------------------

__global__ void segment_sum_sq_kernel(const float* __restrict__ data,
                                      const int32_t* __restrict__ row_ptr,
                                      float* __restrict__ out, int n_rows, int n_chan) {
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  float* o = out + static_cast<int64_t>(row) * 2 * n_chan;
  for (int ch = threadIdx.x; ch < n_chan; ch += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int64_t e = start; e < end; ++e) {
      const float x = __ldg(data + e * n_chan + ch);
      s1 = __fadd_rn(s1, x);
      s2 = __fadd_rn(s2, __fmul_rn(x, x));
    }
    o[ch] = s1;
    o[n_chan + ch] = s2;
  }
}

// ---------------------------------------------------------------------------
// Kernels 9-11: the wide MMA edge program and its backward
//
// Replace mma_tpu/ops/pallas/fused_mma.py::_program_fwd_kernel,
// _program_bwd_kernel and _program_bwd_csc_kernel (launched by
// _fused_program_fwd, _fused_program_bwd, _fused_program_bwd_csc). With
// per-node projections c, d (N, K*F), h (N, F) and, on edge e = (s -> i),
// logits = c[i] + d[s], sig = sigmoid(logits),
//   mask = pat ? sig : logits,  dmask = pat ? sig (1 - sig) : 1:
//   kernel 9:  S[i] = sum_{e in row i} mask_e * tile(h[s], K)
//   kernel 10: dc[i] = sum_{e in row i} dlog_e, dlog_e = ct[i] * tile(h[s], K) * dmask_e,
//              and optionally payload[e] = [dlog_e || sum_k (ct[i] * mask_e)_k]
//              (E, K*F+F), 0 for edges outside the CSR;
//   kernel 11: out[s] = [sum_{e: src=s} dlog_e || sum_{e: src=s} sum_k (ct[i] * mask_e)_k]
//              over the CSC, i = dst_csc[e].
//
// Bound on this card: bytes. Per edge each kernel reads a K*F + F-wide
// node row (768 B at F=64, K=2) or two K*F-wide ones at random and does
// about 4-8 operations per lane. Counted as each input read once, the
// bound is small; the random row reads (E x the row width) set the time.
// Design: one warp per row (a destination row for 9-10, a source row for
// 11), 8 warps a block. A thread owns 4 consecutive lanes of each 128-lane
// tile of the K*F row (NT = ceil(K*F / 128) tiles, K*F <= 512) and keeps
// the row's own node data in registers: c[i] (and ct[i]) for 9-10, d[s]
// and h[s] for 11. Per edge it gathers the other endpoint's rows as
// 16-byte loads straight from the node tables (no gathered (E, K*F+F)
// table as the TPU wrapper builds), issuing the next edge's loads before
// the current edge's arithmetic. The sum over k of the K aggregator blocks
// (the dh part) crosses threads: the warp stages its ct * mask lanes in
// shared memory and each thread adds k = 0..K-1 for its 4 output features
// in that fixed order. Every output row is written once by its warp, edges
// in CSR / CSC order: no atomics, bitwise equal run to run.
// ---------------------------------------------------------------------------

constexpr int kWideWarps = 8;
constexpr int kMaxKF = 512;

__device__ __forceinline__ void load4(float (&v)[4], const float* p, bool on) {
  if (on) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    v[0] = v[1] = v[2] = v[3] = 0.f;
  }
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// A thread's lanes of a K*F-wide row: l0[t] = 128 t + 4 lane in tile t,
// on[t] when they exist, hoff[t] = l0[t] mod F (the same lanes of h).
template <int NT>
struct WideLanes {
  int l0[NT];
  int hoff[NT];
  bool on[NT];
  float pat[NT][4];

  __device__ WideLanes(const float* __restrict__ pattern, int lane, int f, int kf) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      l0[t] = t * kLaneTile + 4 * lane;
      on[t] = l0[t] < kf;  // kf % 4 == 0, so all 4 lanes or none
      hoff[t] = on[t] ? l0[t] % f : 0;
      load4(pat[t], pattern + l0[t], on[t]);
    }
  }

  // v[t] = row[r, l0[t] .. l0[t] + 3] of a (rows, kf) table.
  __device__ void row(float (&v)[NT][4], const float* __restrict__ table, int64_t r,
                      int kf) const {
#pragma unroll
    for (int t = 0; t < NT; ++t) load4(v[t], table + r * kf + l0[t], on[t]);
  }

  // v[t] = h[r, hoff[t] .. hoff[t] + 3]: tile(h[r], K) on this thread's lanes.
  __device__ void hrow(float (&v)[NT][4], const float* __restrict__ h, int64_t r,
                       int f) const {
#pragma unroll
    for (int t = 0; t < NT; ++t) load4(v[t], h + r * f + hoff[t], on[t]);
  }
};

template <int NT>
__device__ __forceinline__ void copy_lanes(float (&dst)[NT][4], const float (&src)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
#pragma unroll
    for (int q = 0; q < 4; ++q) dst[t][q] = src[t][q];
  }
}

// mask and dmask of one lane.
__device__ __forceinline__ void mask_chain(float x, float p, float& m, float& dm) {
  const float sg = sigmoidf(x);
  m = p != 0.f ? sg : x;
  dm = p != 0.f ? sg * (1.f - sg) : 1.f;
}

// The warp's dh part: out[ff] = sum_{k < kf / f} gm_s[k f + ff] for this
// thread's 4 features ff = 4 lane .. 4 lane + 3 (f <= 128), k in order.
__device__ __forceinline__ void sum_blocks(float* __restrict__ out,
                                           const float* __restrict__ gm_s, int lane, int f,
                                           int kf) {
  const int ff = 4 * lane;
  if (ff >= f) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < kf; k += f) {
    const float4 g = *reinterpret_cast<const float4*>(gm_s + k + ff);
    s[0] += g.x; s[1] += g.y; s[2] += g.z; s[3] += g.w;
  }
  store4(out + ff, s);
}

template <int NT>
__global__ void __launch_bounds__(kWideWarps * kWarp)
edge_program_fwd_kernel(const float* __restrict__ c, const float* __restrict__ d,
                        const float* __restrict__ h, const float* __restrict__ pat,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ row_ptr, float* __restrict__ out,
                        int n_rows, int f, int kf) {
  const int row = blockIdx.x * kWideWarps + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // whole warps leave together
  const WideLanes<NT> ln(pat, threadIdx.x % kWarp, f, kf);
  float cv[NT][4], acc[NT][4] = {};
  ln.row(cv, c, row, kf);
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  float dn[NT][4], hn[NT][4];
  if (start < end) {
    const int64_t s = __ldg(src + start);
    ln.row(dn, d, s, kf);
    ln.hrow(hn, h, s, f);
  }
  for (int e = start; e < end; ++e) {
    float dv[NT][4], hv[NT][4];
    copy_lanes(dv, dn);
    copy_lanes(hv, hn);
    if (e + 1 < end) {  // the next edge's rows, in flight below
      const int64_t s = __ldg(src + e + 1);
      ln.row(dn, d, s, kf);
      ln.hrow(hn, h, s, f);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float x = cv[t][q] + dv[t][q];
        const float m = ln.pat[t][q] != 0.f ? sigmoidf(x) : x;
        acc[t][q] = fmaf(m, hv[t][q], acc[t][q]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (ln.on[t]) store4(out + static_cast<int64_t>(row) * kf + ln.l0[t], acc[t]);
  }
}

template <int NT>
__global__ void __launch_bounds__(kWideWarps * kWarp)
edge_program_bwd_kernel(const float* __restrict__ c, const float* __restrict__ d,
                        const float* __restrict__ h, const float* __restrict__ pat,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ row_ptr, const float* __restrict__ ct,
                        float* __restrict__ dc, float* __restrict__ payload, int n_rows,
                        int n_edges, int f, int kf) {
  __shared__ __align__(16) float gm_all[kWideWarps * kMaxKF];
  const int width = kf + f;  // payload row: [dlog || dh_e]
  if (payload != nullptr) {  // edges no row covers get payload 0
    const int64_t lo = static_cast<int64_t>(row_ptr[0]) * width;
    const int64_t hi = static_cast<int64_t>(row_ptr[n_rows]) * width;
    const int64_t all = static_cast<int64_t>(n_edges) * width;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
         i < all - hi + lo; i += stride) {
      payload[i < lo ? i : hi + (i - lo)] = 0.f;
    }
  }
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWideWarps + warp;
  if (row >= n_rows) return;  // whole warps leave together
  float* gm_s = gm_all + warp * kMaxKF;
  const WideLanes<NT> ln(pat, lane, f, kf);
  float cv[NT][4], ctv[NT][4], acc[NT][4] = {};
  ln.row(cv, c, row, kf);
  ln.row(ctv, ct, row, kf);
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  float dn[NT][4], hn[NT][4];
  if (start < end) {
    const int64_t s = __ldg(src + start);
    ln.row(dn, d, s, kf);
    ln.hrow(hn, h, s, f);
  }
  for (int e = start; e < end; ++e) {
    float dv[NT][4], hv[NT][4];
    copy_lanes(dv, dn);
    copy_lanes(hv, hn);
    if (e + 1 < end) {
      const int64_t s = __ldg(src + e + 1);
      ln.row(dn, d, s, kf);
      ln.hrow(hn, h, s, f);
    }
    float dl[NT][4], gm[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float m, dm;
        mask_chain(cv[t][q] + dv[t][q], ln.pat[t][q], m, dm);
        dl[t][q] = ctv[t][q] * hv[t][q] * dm;
        gm[t][q] = ctv[t][q] * m;
        acc[t][q] += dl[t][q];  // edges in CSR order
      }
    }
    if (payload != nullptr) {
      float* prow = payload + static_cast<int64_t>(e) * width;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if (ln.on[t]) {
          store4(prow + ln.l0[t], dl[t]);
          store4(gm_s + ln.l0[t], gm[t]);
        }
      }
      __syncwarp();
      sum_blocks(prow + kf, gm_s, lane, f, kf);
      __syncwarp();  // gm_s is read before the next edge overwrites it
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (ln.on[t]) store4(dc + static_cast<int64_t>(row) * kf + ln.l0[t], acc[t]);
  }
}

template <int NT>
__global__ void __launch_bounds__(kWideWarps * kWarp)
edge_program_bwd_csc_kernel(const float* __restrict__ c, const float* __restrict__ d,
                            const float* __restrict__ h, const float* __restrict__ pat,
                            const int32_t* __restrict__ dst_csc,
                            const int32_t* __restrict__ col_ptr,
                            const float* __restrict__ ct, float* __restrict__ out,
                            int n_rows, int f, int kf) {
  __shared__ __align__(16) float gm_all[kWideWarps * kMaxKF];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kWideWarps + warp;  // a source node
  if (row >= n_rows) return;  // whole warps leave together
  float* gm_s = gm_all + warp * kMaxKF;
  const WideLanes<NT> ln(pat, lane, f, kf);
  float dv[NT][4], hv[NT][4], dd[NT][4] = {}, gsum[NT][4] = {};
  ln.row(dv, d, row, kf);
  ln.hrow(hv, h, row, f);
  const int start = col_ptr[row];
  const int end = col_ptr[row + 1];
  float cn[NT][4], ctn[NT][4];
  if (start < end) {
    const int64_t i = __ldg(dst_csc + start);
    ln.row(cn, c, i, kf);
    ln.row(ctn, ct, i, kf);
  }
  for (int e = start; e < end; ++e) {
    float cv[NT][4], ctv[NT][4];
    copy_lanes(cv, cn);
    copy_lanes(ctv, ctn);
    if (e + 1 < end) {
      const int64_t i = __ldg(dst_csc + e + 1);
      ln.row(cn, c, i, kf);
      ln.row(ctn, ct, i, kf);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float m, dm;
        mask_chain(cv[t][q] + dv[t][q], ln.pat[t][q], m, dm);
        dd[t][q] += ctv[t][q] * hv[t][q] * dm;  // edges in CSC order
        gsum[t][q] += ctv[t][q] * m;
      }
    }
  }
  const int width = kf + f;
  float* orow = out + static_cast<int64_t>(row) * width;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (ln.on[t]) {
      store4(orow + ln.l0[t], dd[t]);
      store4(gm_s + ln.l0[t], gsum[t]);
    }
  }
  __syncwarp();
  sum_blocks(orow + kf, gm_s, lane, f, kf);
}

// Calls launch(std::integral_constant<int, NT>()) for NT = ceil(kf / 128)
// in 1..4 and returns the launch's error.
template <typename Launch>
cudaError_t by_tiles(int kf, Launch launch) {
  switch ((kf + kLaneTile - 1) / kLaneTile) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 3: launch(std::integral_constant<int, 3>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

int wide_blocks(int n_rows) { return (n_rows + kWideWarps - 1) / kWideWarps; }

// ---------------------------------------------------------------------------
// Kernel 12: masked_segment_sum
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_masked_kernel (launched by
// _fused_masked_segment_sum). From per-edge logits (E, K*F) and source
// rows h_src (E, F), both already gathered in CSR order:
//   S[i] = sum_{e in row i} where(pat, sigmoid(logits_e), logits_e) * tile(h_src_e, K)
// with lane l = k F + j of the tile reading h_src[e, j].
//
// Bound on this card: bytes. Each covered edge's logits and h_src rows are
// read once and each output row written once: at synthetic-large
// (E = 2,097,138 covered edges, N = 131,080, F = 64, K = 2) that is
//   E (K*F + F) 4 B + N K*F 4 B = 2,097,138 x 768 B + 131,080 x 512 B ~ 1.68 GB,
// 0.50 ms at 3.35 TB/s, against about 6 operations per edge and lane
// (1.6 GFLOP, 0.024 ms at the f32 rate).
// Design: one warp per destination row, 8 warps a block, as kernel 1. A
// row's edges are contiguous, so the warp streams their logits and h_src
// rows with coalesced loads and gathers nothing: a thread owns VEC
// consecutive lanes of each (32 VEC)-lane tile, VEC = 4 (16-byte loads)
// when F % 4 == 0, else 1. The warp starts the loads of up to 4 edges
// before their arithmetic, so several rows are in flight per warp, and
// adds the edges into registers in CSR order: each output row is written
// once, with no atomics, bitwise equal run to run. The block stages the
// pattern in shared memory once. The power-law graph's heaviest row (1,448
// edges, 1.1 MB) is one warp's sequential loop.
// ---------------------------------------------------------------------------

constexpr int kMaskedWarps = 8;

template <int VEC>
__device__ __forceinline__ void load_lanes(float (&v)[VEC], const float* p, bool on) {
  if constexpr (VEC == 4) {
    load4(v, p, on);
  } else {
    v[0] = on ? __ldg(p) : 0.f;
  }
}

template <int VEC, int NT>
__global__ void __launch_bounds__(kMaskedWarps * kWarp)
masked_segment_sum_kernel(const float* __restrict__ logits,
                          const float* __restrict__ h_src,
                          const float* __restrict__ pat,
                          const int32_t* __restrict__ row_ptr, float* __restrict__ out,
                          int n_rows, int f, int kf) {
  // Edges whose loads are in flight together: 16 floats of each input a thread.
  constexpr int kU = 16 / (NT * VEC) < 1 ? 1 : (16 / (NT * VEC) > 4 ? 4 : 16 / (NT * VEC));
  __shared__ float pat_s[kMaxKF];
  for (int l = threadIdx.x; l < kf; l += blockDim.x) pat_s[l] = pat[l];
  __syncthreads();
  const int row = blockIdx.x * kMaskedWarps + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // whole warps leave together
  const int lane = threadIdx.x % kWarp;
  int l0[NT], hoff[NT];
  bool on[NT];
  float p[NT][VEC], acc[NT][VEC];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    l0[t] = t * kWarp * VEC + VEC * lane;
    on[t] = l0[t] < kf;  // with VEC = 4, kf % 4 == 0: all 4 lanes or none
    hoff[t] = on[t] ? l0[t] % f : 0;
#pragma unroll
    for (int q = 0; q < VEC; ++q) {
      p[t][q] = on[t] ? pat_s[l0[t] + q] : 0.f;
      acc[t][q] = 0.f;
    }
  }
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  for (int e0 = start; e0 < end; e0 += kU) {
    float lg[kU][NT][VEC], hv[kU][NT][VEC];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t e = e0 + u;
      const bool live = e < end;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        load_lanes<VEC>(lg[u][t], logits + e * kf + l0[t], live && on[t]);
        load_lanes<VEC>(hv[u][t], h_src + e * f + hoff[t], live && on[t]);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (e0 + u < end) {  // edges in CSR order
#pragma unroll
        for (int t = 0; t < NT; ++t) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            const float x = lg[u][t][q];
            const float m = p[t][q] != 0.f ? sigmoidf(x) : x;
            acc[t][q] = fmaf(m, hv[u][t][q], acc[t][q]);
          }
        }
      }
    }
  }
  float* orow = out + static_cast<int64_t>(row) * kf;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (!on[t]) continue;
    if constexpr (VEC == 4) {
      store4(orow + l0[t], acc[t]);
    } else {
      orow[l0[t]] = acc[t][0];
    }
  }
}

// Calls launch(std::integral_constant<int, NT>()) for the scalar path's
// NT = ceil(kf / 32) rounded up to a power of two (kf <= 512) and returns
// the launch's error.
template <typename Launch>
cudaError_t by_scalar_tiles(int kf, Launch launch) {
  const int tiles = (kf + kWarp - 1) / kWarp;
  if (tiles <= 1) launch(std::integral_constant<int, 1>());
  else if (tiles <= 2) launch(std::integral_constant<int, 2>());
  else if (tiles <= 4) launch(std::integral_constant<int, 4>());
  else if (tiles <= 8) launch(std::integral_constant<int, 8>());
  else if (tiles <= 16) launch(std::integral_constant<int, 16>());
  else return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mma_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The chunk count of mma_segment_sum_csr for n_edges edge positions (the
// length of data, or of index when there is one); the caller sizes the
// (n_chunks, 2, C) f32 partials and the (n_chunks,) i32 tail rows from it.
int mma_segment_sum_n_chunks(int n_edges) { return sum_n_chunks(n_edges); }

// data (R, C) f32, row_ptr (n_rows+1,) i32 with row_ptr[n_rows] <= n_edges,
// index (n_edges,) i32 or null (then R = n_edges), out (n_rows, C) f32;
// scratch part (n_chunks, 2, C) f32 and tail_row (n_chunks,) i32. Row e of
// the CSR reads data[index[e]] (data[e] without an index). vec4 != 0
// requires C % 4 == 0 and 16-byte aligned data/out/part.
int mma_segment_sum_csr(const void* data, const void* row_ptr, const void* index,
                        void* out, void* part, void* tail_row, int n_rows, int n_chan,
                        int n_edges, int vec4, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const int n_vec = vec4 ? n_chan / 4 : n_chan;
  // Lanes per edge: the power of two that covers a narrow row, else 32 or
  // 16 lanes, whichever divides the row (C=192: 3 slots of 16 lanes).
  int lpe = 1;
  while (lpe < n_vec && lpe < kWarp) lpe <<= 1;
  if (n_vec > kWarp && n_vec % kWarp != 0 && n_vec % (kWarp / 2) == 0) lpe = kWarp / 2;
  const int tiles = (n_vec + lpe - 1) / lpe;
  const int chunk = sum_chunk_edges(n_edges);
  const int n_chunks = sum_n_chunks(n_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MMA_SUM_ARGS \
  data, row_ptr, index, out, part, tail_row, n_rows, n_vec, lpe, tiles, chunk, n_chunks, s
  if (vec4) {
    err = tiles <= 1   ? launch_segment_sum<4, 1>(MMA_SUM_ARGS)
          : tiles <= 2 ? launch_segment_sum<4, 2>(MMA_SUM_ARGS)
          : tiles <= 3 ? launch_segment_sum<4, 3>(MMA_SUM_ARGS)
                       : launch_segment_sum<4, 4>(MMA_SUM_ARGS);
  } else {
    err = tiles <= 1   ? launch_segment_sum<1, 1>(MMA_SUM_ARGS)
          : tiles <= 4 ? launch_segment_sum<1, 4>(MMA_SUM_ARGS)
                       : launch_segment_sum<1, 16>(MMA_SUM_ARGS);
  }
#undef MMA_SUM_ARGS
  return static_cast<int>(err);
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

// The grid size G of mma_edge_program_lean_bwd (blocks per lane tile): as
// many blocks as fit on the card at once, but no more than the rows need.
// The caller sizes the (G, f, kf) dW_bot partial buffer from it.
int mma_edge_program_lean_bwd_grid(int n_rows, int f, int* grid_x) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = f <= 64 ? bwd_occupancy<64>(f, &per_sm) : bwd_occupancy<128>(f, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_rows + kBwdWarps - 1) / kBwdWarps;
  *grid_x = max(1, min(row_blocks, n_sm * per_sm));
  return static_cast<int>(cudaSuccess);
}

// c, ct (n_rows, kf), h (n_rows, f), w_bot (f, kf), pat (kf,) 0/1 f32,
// src (n_edges,) i32, row_ptr (n_rows+1,) i32. Outputs: dc (n_rows, kf),
// dw (f, kf), payload (n_edges, f). Scratch: dw_part (grid_x, f, kf) and,
// when kf > 128, payload_part (ceil(kf / 128), n_edges, f). Same width
// requirements as mma_edge_program_lean_fwd.
int mma_edge_program_lean_bwd(const void* c, const void* h, const void* w_bot,
                              const void* pat, const void* src,
                              const void* row_ptr, const void* ct, void* dc,
                              void* dw, void* payload, void* dw_part,
                              void* payload_part, int n_rows, int n_edges, int f,
                              int kf, int grid_x, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (kf + kLaneTile - 1) / kLaneTile;
  float* pay = static_cast<float*>(tiles > 1 ? payload_part : payload);
  const size_t smem = bwd_smem_bytes(f);
  int per_sm = 0;  // sets the shared-memory attribute of the instance used
  cudaError_t err = f <= 64 ? bwd_occupancy<64>(f, &per_sm) : bwd_occupancy<128>(f, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(grid_x, tiles);
  auto kernel = f <= 64 ? edge_program_lean_bwd_kernel<64> : edge_program_lean_bwd_kernel<128>;
  kernel<<<grid, kBwdWarps * kWarp, smem, s>>>(
      static_cast<const float*>(c), static_cast<const float*>(h),
      static_cast<const float*>(w_bot), static_cast<const float*>(pat),
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(row_ptr),
      static_cast<const float*>(ct), static_cast<float*>(dc),
      static_cast<float*>(dw_part), pay, n_rows, n_edges, f, kf);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  err = launch_sum_slabs(static_cast<const float*>(dw_part), grid_x,
                         static_cast<int64_t>(f) * kf, static_cast<float*>(dw), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 1) {
    err = launch_sum_slabs(pay, tiles, static_cast<int64_t>(n_edges) * f,
                           static_cast<float*>(payload), s);
  }
  return static_cast<int>(err);
}

// data (E, C) f32, row_ptr (n_rows+1,) i32, out (n_rows, 2C) f32.
int mma_segment_sum_sq_csr(const void* data, const void* row_ptr, void* out, int n_rows,
                           int n_chan, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  // Threads along x cover channels (a multiple of 32, at most 128); the
  // rest of the 256-thread block along y covers rows.
  int bx = ((n_chan + kWarp - 1) / kWarp) * kWarp;
  if (bx > 128) bx = 128;
  const int by = 256 / bx;
  segment_sum_sq_kernel<<<(n_rows + by - 1) / by, dim3(bx, by), 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int32_t*>(row_ptr),
      static_cast<float*>(out), n_rows, n_chan);
  return static_cast<int>(cudaGetLastError());
}

// c, d (n_rows, kf), h (n_rows, f), pat (kf,) 0/1 f32, src (E,) i32,
// row_ptr (n_rows+1,) i32, out (n_rows, kf) f32. Requires f % 4 == 0,
// f <= 128, kf % f == 0, kf <= 512 and 16-byte aligned c, d, h, out.
int mma_edge_program_fwd(const void* c, const void* d, const void* h, const void* pat,
                         const void* src, const void* row_ptr, void* out, int n_rows,
                         int f, int kf, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_tiles(kf, [&](auto nt) {
    edge_program_fwd_kernel<decltype(nt)::value><<<wide_blocks(n_rows), kWideWarps * kWarp,
                                                    0, s>>>(
        static_cast<const float*>(c), static_cast<const float*>(d),
        static_cast<const float*>(h), static_cast<const float*>(pat),
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(row_ptr),
        static_cast<float*>(out), n_rows, f, kf);
  }));
}

// As mma_edge_program_fwd, plus ct (n_rows, kf). Outputs: dc (n_rows, kf)
// and, unless payload is null, payload (n_edges, kf + f), 16-byte aligned.
int mma_edge_program_bwd(const void* c, const void* d, const void* h, const void* pat,
                         const void* src, const void* row_ptr, const void* ct, void* dc,
                         void* payload, int n_rows, int n_edges, int f, int kf,
                         void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_tiles(kf, [&](auto nt) {
    edge_program_bwd_kernel<decltype(nt)::value><<<wide_blocks(n_rows), kWideWarps * kWarp,
                                                    0, s>>>(
        static_cast<const float*>(c), static_cast<const float*>(d),
        static_cast<const float*>(h), static_cast<const float*>(pat),
        static_cast<const int32_t*>(src), static_cast<const int32_t*>(row_ptr),
        static_cast<const float*>(ct), static_cast<float*>(dc),
        static_cast<float*>(payload), n_rows, n_edges, f, kf);
  }));
}

// c, ct, d (n_rows, kf), h (n_rows, f), pat (kf,), dst_csc (E,) i32,
// col_ptr (n_rows+1,) i32, out (n_rows, kf + f) f32. Same width and
// alignment requirements as mma_edge_program_fwd.
int mma_edge_program_bwd_csc(const void* c, const void* d, const void* h, const void* pat,
                             const void* dst_csc, const void* col_ptr, const void* ct,
                             void* out, int n_rows, int f, int kf, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_tiles(kf, [&](auto nt) {
    edge_program_bwd_csc_kernel<decltype(nt)::value><<<wide_blocks(n_rows),
                                                        kWideWarps * kWarp, 0, s>>>(
        static_cast<const float*>(c), static_cast<const float*>(d),
        static_cast<const float*>(h), static_cast<const float*>(pat),
        static_cast<const int32_t*>(dst_csc), static_cast<const int32_t*>(col_ptr),
        static_cast<const float*>(ct), static_cast<float*>(out), n_rows, f, kf);
  }));
}

// logits (E, kf), h_src (E, f), pat (kf,) 0/1 f32, row_ptr (n_rows+1,) i32,
// out (n_rows, kf) f32. Requires kf % f == 0, f <= 128, kf <= 512; vec4 != 0
// requires f % 4 == 0 and 16-byte aligned logits, h_src and out.
int mma_masked_segment_sum(const void* logits, const void* h_src, const void* pat,
                           const void* row_ptr, void* out, int n_rows, int f, int kf,
                           int vec4, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (n_rows + kMaskedWarps - 1) / kMaskedWarps;
  auto launch = [&](auto vec, auto nt) {
    masked_segment_sum_kernel<decltype(vec)::value, decltype(nt)::value>
        <<<blocks, kMaskedWarps * kWarp, 0, s>>>(
            static_cast<const float*>(logits), static_cast<const float*>(h_src),
            static_cast<const float*>(pat), static_cast<const int32_t*>(row_ptr),
            static_cast<float*>(out), n_rows, f, kf);
  };
  if (vec4) {
    return static_cast<int>(
        by_tiles(kf, [&](auto nt) { launch(std::integral_constant<int, 4>(), nt); }));
  }
  return static_cast<int>(
      by_scalar_tiles(kf, [&](auto nt) { launch(std::integral_constant<int, 1>(), nt); }));
}

}  // extern "C"
