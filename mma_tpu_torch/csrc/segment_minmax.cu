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
// MXU operands. None of that is needed here.
//
// Kernels 4, 5 and 7: one thread per (destination row, channel). The
// thread walks the row's edges over the dst-sorted CSR in edge order;
// channels run along threadIdx.x, so each edge's C-wide row is read
// coalesced. ZINC's in-degree is at most 4, so each walk is short.
// Kernel 6 stages contiguous tiles of rows through shared memory with
// 16-byte copies instead (its own note below); it visits each row's edges
// in the same order and computes the same values bit for bit.
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

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemPerBlock = 232448;  // 227 KB, the opt-in limit on sm_90

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
// keep_of finishes the hash from its mixed input x = pos K1 + lane K2 +
// seed (mod 2^32), so that kernel 6 can add the lane's part once per lane.
__device__ __forceinline__ uint32_t lane_term(int32_t seed, int lane) {
  return static_cast<uint32_t>(lane) * 0x85EBCA6Bu + static_cast<uint32_t>(seed);
}

__device__ __forceinline__ float keep_of(uint32_t x, int32_t thresh, float scale) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  const int32_t u = static_cast<int32_t>(x & 0x7FFFFFFFu);
  return u >= thresh ? scale : 0.f;
}

__device__ __forceinline__ float dropout_keep(int32_t seed, int64_t pos, int lane,
                                              int32_t thresh, float scale) {
  return keep_of(static_cast<uint32_t>(pos) * 0x9E3779B9u + lane_term(seed, lane), thresh,
                 scale);
}

// The edge program's message: x = m * (hg + c[dst]). Rounded operations,
// so that the backward's recompute is bitwise the forward's (no FMA
// contraction can differ between the two kernels).
// keep is the edge's dropout_keep (used only with drop).
__device__ __forceinline__ float message(float hg, float c, bool drop, float keep) {
  const float x = __fadd_rn(hg, c);
  return drop ? __fmul_rn(x, keep) : x;
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
// per destination row as kernel 4. The (E, C) message tensor is never
// stored.
//
// Bound on this card: bytes. hg and c read once and out written once: at
// the ZINC flagship batch (E = 46,858, N = 23,552, C = 375, min and max)
// 70.3 + 35.3 MB in and 70.6 MB out in f32, 0.0526 ms at 3.35 TB/s; bf16
// hg and c halve the reads (0.0369 ms). About 1 operation per byte, but
// the hash dropout adds some 15 integer operations per edge and channel.
//
// Design: staged contiguous row tiles. A run of consecutive destination
// rows [r0, r1) reads three contiguous spans: the edges [row_ptr[r0],
// row_ptr[r1]) of the dst-sorted hg, the rows [r0, r1) of c and the rows
// [r0, r1) of out. A row-per-thread walk (kernels 4, 5 and 7) loads one
// scalar of each a thread, after a dependent load of row_ptr. C = 375 is
// odd, so single rows are not 16-byte aligned, but a span of rows is one
// range of bytes: it moves in 16-byte pieces whatever C is.
//
//   Tiles: tile b holds the rows whose item key row_ptr[i] + i falls in
//   [b D, (b + 1) D): a budget of D items, one a row and one an edge, so
//   at most D rows and, but for its last row's own edges, at most D - rows
//   edges. Empty rows count, so a run of them cannot pile into one tile.
//   The partition depends on E, N and C alone, never on the card.
//   Blocks: one a tile, several resident an SM. Warp 0 finds the tile's
//   rows by two 32-ary searches of the item keys (fused_mma.cu's
//   lower_bound2 on row_ptr[i] + i); the block then copies the tile's
//   row_ptr entries (4-byte cp.async), c rows and hg edges (16-byte
//   cp.async) into its stage, all issued before any reduction. Each span
//   moves as the 16-byte pieces from its start's boundary below to past
//   its end, laid out in shared memory from a 16-byte boundary, so every
//   piece lands aligned; a piece's bytes outside the span are its
//   neighbours' in the same tensor, never read. Only a piece that crosses
//   the tensor's first or last byte (the first or last tile's) is copied
//   element by element.
//   Reduction: units of (row, 32 channels), unit u to warp u mod 8, so
//   that a warp's lanes share a row and its degree. A lane walks its
//   row's edges from shared memory in edge order with message() and
//   dropout_keep's bits on the absolute edge index (the lane's part of the
//   hash added once a unit, two edges at a time), as the row-per-thread
//   kernel did: out is bitwise what it was, and kernel 7's exact recompute
//   still finds its first hits. The op pair and dropout are template
//   arguments. A lane stores its (row, channel) results to out directly: a
//   warp's stores are one 128-byte line.
//   Long rows: the stage holds Q = D + max(D / 2, 4) items, so a last row
//   of up to Q - D edges past the budget still fits; a longer one is
//   walked in pieces of Q - rows edges through the same stage, one after
//   another, each lane going on from what it stored to out. ZINC's
//   in-degree of at most 4 never takes that path; graphs with hubs do.
//   D: the largest tile whose stage fits MMA_PROG_SMEM_KB (40 KB: five
//   blocks an SM); at the flagship batch D = 18 in f32 and 36 in bf16.
//
// Chosen on the card (scripts/torch_redesign_compare.py, PERF.md §6) over
// a persistent grid walking runs of tiles through a ring of two to six
// stages, each 48-160 KB a block: those were 10-40% slower, as was an out
// tile staged in shared memory and stored as one span with 16-byte stores
// (out written directly is 14-17% faster): the time goes to the
// reduction's integer hash and the barriers between phases, not to bytes
// in flight. Lanes a unit of one row (against lanes over consecutive
// items, which cross rows of other degrees) and the op pair at compile
// time took another 10-15%.
//
// Every output element is written once, by one lane, with no atomics and
// no host sync: bitwise equal run to run, and a call replays in a CUDA
// graph. Positions outside [row_ptr[0], row_ptr[N]) are no tile's edges.
// ---------------------------------------------------------------------------

#ifndef MMA_PROG_SMEM_KB
#define MMA_PROG_SMEM_KB 40
#endif

constexpr int kProgWarps = 8;
constexpr int kProgThreads = kProgWarps * 32;
constexpr int kProgSmemBudget = MMA_PROG_SMEM_KB * 1024;  // a block's stage

__host__ __device__ __forceinline__ int align16(int64_t x) {
  return static_cast<int>((x + 15) & ~static_cast<int64_t>(15));
}

// A block's shared memory: the tile's bounds (kProgHeader bytes), then its
// stage: [row_ptr entries | c rows and hg edges, each span from its
// 16-byte boundary]. All of it dynamic, so that the kernel may take the
// card's whole opt-in limit.
constexpr int kProgHeader = 32;  // a ProgTile, padded to 16 bytes

struct ProgLayout {
  int d;         // the tile's item budget (rows + edges)
  int q;         // items the stage holds
  int rp_bytes;  // the tile's row_ptr entries (at most d + 1)
  int total;     // the header, rp_bytes and the c rows and hg edges
};

ProgLayout prog_layout_of(int d, int n_chan, int elem) {
  ProgLayout l;
  l.d = d;
  l.q = d + std::max(d / 2, 4);
  l.rp_bytes = align16(static_cast<int64_t>(d + 2) * 4);
  l.total = kProgHeader + l.rp_bytes + align16(static_cast<int64_t>(l.q) * n_chan * elem + 64);
  return l;
}

// The largest tile whose stage fits kProgSmemBudget (at least one item).
ProgLayout prog_layout(int n_chan, int elem) {
  int d = std::max(1, kProgSmemBudget / (n_chan * elem * 3 / 2));
  ProgLayout l = prog_layout_of(d, n_chan, elem);
  while (d > 1 && l.total > kProgSmemBudget) l = prog_layout_of(--d, n_chan, elem);
  return l;
}

// For keys[0] and keys[1] at once, the first row i in [0, n) whose item
// key row_ptr[i] + i is >= key (n if none): fused_mma.cu's lower_bound2 on
// the item keys, which rise by at least 1 a row. Warp-uniform.
__device__ __forceinline__ void lower_bound_items(const int32_t* __restrict__ row_ptr, int n,
                                                  const int64_t keys[2], int found[2]) {
  const int lane = threadIdx.x % 32;
  int lo[2] = {0, 0}, hi[2] = {n, n};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2];
    bool pred[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      step[k] = (hi[k] - lo[k] + 31) / 32;
      const int64_t q = lo[k] + static_cast<int64_t>(lane + 1) * step[k] - 1;
      pred[k] = lo[k] >= hi[k] || q >= hi[k] || __ldg(row_ptr + q) + q >= keys[k];
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Stages the n elements at src into dst (16-byte aligned): the 16-byte
// pieces from src's boundary below to past the span's end, piece k at dst
// + 16 k, so element i lands at byte (src & 15) + i * sizeof(E). A piece
// inside the tensor [lo, hi) (bytes) goes by cp.async, whatever of it lies
// outside the span (its neighbours' bytes, never read); a piece that
// crosses the tensor's first or last byte, which only its first or last
// tile meets, copies its elements in the span one by one.
template <typename E>
__device__ __forceinline__ void stage_span(char* dst, const E* src, int64_t n, uint64_t lo,
                                           uint64_t hi) {
  if (n <= 0) return;
  const uint64_t a = reinterpret_cast<uint64_t>(src);
  const uint64_t b = a + static_cast<uint64_t>(n) * sizeof(E);
  const uint64_t a0 = a & ~uint64_t{15};
  const int64_t pieces = static_cast<int64_t>((((b + 15) & ~uint64_t{15}) - a0) / 16);
  for (int64_t k = threadIdx.x; k < pieces; k += blockDim.x) {
    const uint64_t g = a0 + 16 * static_cast<uint64_t>(k);
    if (g >= lo && g + 16 <= hi) {
      cp_async16(dst + 16 * k, reinterpret_cast<const void*>(g));
    } else {
      for (uint64_t p = g < a ? a : g; p < g + 16 && p < b; p += sizeof(E)) {
        *reinterpret_cast<E*>(dst + (p - a0)) = *reinterpret_cast<const E*>(p);
      }
    }
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(bf16_t v) { return __bfloat162float(v); }

// One tile: rows [lo, lo + rows) and their edges [e0, e1).
struct ProgTile {
  int lo, rows;
  int64_t e0, e1;
};
static_assert(sizeof(ProgTile) <= kProgHeader, "the tile's bounds fit the header");

// The kernel's operands and their extents, for staging.
template <typename E>
struct ProgArgs {
  const E* c;
  const E* hg;
  const int32_t* row_ptr;
  int n_rows, n_chan;
  int64_t n_edges;

  __device__ int hg_offset(const ProgTile& t) const {  // the hg span's place in a stage
    const int c_head = static_cast<int>(
        reinterpret_cast<uint64_t>(c + static_cast<int64_t>(t.lo) * n_chan) & 15);
    return align16(c_head + static_cast<int64_t>(t.rows) * n_chan * sizeof(E));
  }
  __device__ void stage_c(char* data, const ProgTile& t) const {
    stage_span(data, c + static_cast<int64_t>(t.lo) * n_chan,
               static_cast<int64_t>(t.rows) * n_chan, reinterpret_cast<uint64_t>(c),
               reinterpret_cast<uint64_t>(c + static_cast<int64_t>(n_rows) * n_chan));
  }
  __device__ void stage_hg(char* data, const ProgTile& t, int64_t ps, int64_t pe) const {
    stage_span(data + hg_offset(t), hg + ps * n_chan, (pe - ps) * n_chan,
               reinterpret_cast<uint64_t>(hg), reinterpret_cast<uint64_t>(hg + n_edges * n_chan));
  }
};

// Starts staging tile t into the stage st: its row_ptr entries, its c rows
// and the first piece [e0, e0 + q - rows) of its hg edges.
template <typename E>
__device__ __forceinline__ void stage_tile(char* st, const ProgLayout& l, const ProgTile& t,
                                           const ProgArgs<E>& g) {
  int32_t* rp_s = reinterpret_cast<int32_t*>(st);
  for (int i = threadIdx.x; i <= t.rows; i += blockDim.x) cp_async4(rp_s + i, g.row_ptr + t.lo + i);
  g.stage_c(st + l.rp_bytes, t);
  g.stage_hg(st + l.rp_bytes, t, t.e0, min64(t.e1, t.e0 + (l.q - t.rows)));
}

// Folds the staged hg edges [ps, pe) into out's rows of the tile (row r of
// the tile at out_rows + r P C): a row whose first edge is in the piece
// starts its min/max there, one that began in an earlier piece goes on from
// what it stored, and in the first piece an empty row gets 0. The work goes
// in units of (row, 32 channels), unit u to warp u mod kProgWarps, so that
// a warp's lanes share a row and its degree, each (row, channel) stays with
// one lane across pieces (which reads back only its own stores), and a
// warp's stores are one 128-byte line. Op p is max where bit p of MB is
// set, else min. The message is message() with dropout_keep's bits on the
// absolute edge index e and channel ch, the lane's part of the hash added
// once a unit; edges go two at a time, each compared in edge order.
template <typename E, int P, int MB, bool DROP>
__device__ __forceinline__ void fold_piece(const char* st, const ProgLayout& l, const ProgTile& t,
                                           const ProgArgs<E>& g, int64_t ps, int64_t pe,
                                           float* out_rows, int32_t seed, int32_t thresh,
                                           float scale) {
  const int n_chan = g.n_chan;
  const int32_t* rp_s = reinterpret_cast<const int32_t*>(st);
  const char* data = st + l.rp_bytes;
  const E* c_s = reinterpret_cast<const E*>(
      data + (reinterpret_cast<uint64_t>(g.c + static_cast<int64_t>(t.lo) * n_chan) & 15));
  const E* hg_s = reinterpret_cast<const E*>(
      data + g.hg_offset(t) + (reinterpret_cast<uint64_t>(g.hg + ps * n_chan) & 15));
  // Edge positions fit int32 (row_ptr is int32); hg_s holds edges [p0, p1).
  const int p0 = static_cast<int>(ps), p1 = static_cast<int>(pe);
  const bool first = ps == t.e0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int chunks = (n_chan + 31) / 32;
  const int units = t.rows * chunks;
  const int dr = kProgWarps / chunks, dk = kProgWarps - dr * chunks;
  int r = warp / chunks, k = warp - r * chunks;
  for (int u = warp; u < units; u += kProgWarps) {
    const int ch = 32 * k + lane;
    if (ch < n_chan) {
      const int rs = rp_s[r], re = rp_s[r + 1];
      const int end = re < p1 ? re : p1;
      int e = rs > p0 ? rs : p0;
      float* o = out_rows + static_cast<int64_t>(r) * P * n_chan + ch;
      if (e < end) {
        const float cv = widen(c_s[r * n_chan + ch]);
        const uint32_t lt = DROP ? lane_term(seed, ch) : 0u;
        const E* h = hg_s + ch;  // h[(e - p0) * n_chan]: edge e's channel ch
        auto msg = [&](int e_) {
          return message(widen(h[(e_ - p0) * n_chan]), cv, DROP,
                         DROP ? keep_of(static_cast<uint32_t>(e_) * 0x9E3779B9u + lt, thresh,
                                        scale)
                              : 0.f);
        };
        float b0, b1;
        if (rs >= p0) {
          b0 = b1 = msg(e);
          ++e;
        } else {
          b0 = o[0];
          b1 = P == 2 ? o[n_chan] : 0.f;
        }
        auto take = [&](float v) {
          if (improves(v, b0, MB & 1)) b0 = v;
          if (P == 2 && improves(v, b1, MB & 2)) b1 = v;
        };
        for (; e + 1 < end; e += 2) {
          const float v0 = msg(e), v1 = msg(e + 1);
          take(v0);
          take(v1);
        }
        if (e < end) take(msg(e));
        o[0] = b0;
        if (P == 2) o[n_chan] = b1;
      } else if (first && rs == re) {
        o[0] = 0.f;
        if (P == 2) o[n_chan] = 0.f;
      }
    }
    r += dr;
    k += dk;
    if (k >= chunks) {
      k -= chunks;
      ++r;
    }
  }
}

template <typename E, int P, int MB, bool DROP>
__global__ void __launch_bounds__(kProgThreads)
minmax_prog_kernel(ProgArgs<E> g, const int32_t* __restrict__ seed_ptr, float* __restrict__ out,
                   int32_t thresh, float scale, ProgLayout l) {
  extern __shared__ float4 prog_smem[];
  ProgTile& tile_s = *reinterpret_cast<ProgTile*>(prog_smem);
  char* st = reinterpret_cast<char*>(prog_smem) + kProgHeader;
  // Tile blockIdx.x: the rows whose item key falls in [b D, (b + 1) D).
  if (threadIdx.x < 32) {
    const int64_t keys[2] = {static_cast<int64_t>(blockIdx.x) * l.d,
                             static_cast<int64_t>(blockIdx.x + 1) * l.d};
    int found[2];
    lower_bound_items(g.row_ptr, g.n_rows, keys, found);
    if (threadIdx.x == 0) {
      tile_s = ProgTile{found[0], found[1] - found[0], __ldg(g.row_ptr + found[0]),
                        __ldg(g.row_ptr + found[1])};
    }
  }
  __syncthreads();
  const ProgTile t = tile_s;
  if (t.rows == 0) return;  // the whole block leaves
  const int32_t seed = DROP ? __ldg(seed_ptr) : 0;
  stage_tile(st, l, t, g);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // the tile is in the stage
  float* rows_out = out + static_cast<int64_t>(t.lo) * P * g.n_chan;
  const int cap = l.q - t.rows;
  for (int64_t ps = t.e0;;) {
    const int64_t pe = min64(t.e1, ps + cap);
    fold_piece<E, P, MB, DROP>(st, l, t, g, ps, pe, rows_out, seed, thresh, scale);
    if (pe >= t.e1) break;
    // A row longer than the stage: its next piece, through the same stage.
    __syncthreads();
    g.stage_hg(st + l.rp_bytes, t, pe, min64(t.e1, pe + cap));
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    ps = pe;
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

// c (n_rows, C) and hg (n_edges, C) f32 (both bf16 when bf16 != 0), out
// (n_rows, n_ops*C) f32, row_ptr (n_rows+1,) i32 with row_ptr[n_rows] <=
// n_edges; seed (1,) i32 on the device, or null for no dropout; thresh =
// int(rate * 2^31), scale = f32(1 / (1 - rate)). Each of c, hg and out
// aligned to its element. The smallest tile (one item, a stage of five)
// takes 20 C bytes of shared memory in f32 and 10 C in bf16: C up to about
// 11,600 and 23,200 (cudaErrorInvalidValue past that).
int mma_minmax_prog(const void* c, const void* hg, const void* row_ptr, const void* seed,
                    void* out, int n_rows, int64_t n_edges, int n_chan, int n_ops,
                    int max_bits, int thresh, float scale, int bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  auto launch = [&](auto elem, auto ops, auto bits, auto drop) -> cudaError_t {
    using E = decltype(elem);
    constexpr int P = decltype(ops)::value;
    auto kernel = minmax_prog_kernel<E, P, decltype(bits)::value, decltype(drop)::value>;
    const ProgLayout l = prog_layout(n_chan, sizeof(E));
    if (l.total > kMaxSmemPerBlock) return cudaErrorInvalidValue;
    // Once a device and instance: the largest stage any C may take, and
    // all of the SM's unified memory as shared memory, so that as many
    // blocks are resident as their stages allow.
    static std::atomic<uint64_t> configured{0};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    const uint64_t bit = device < 64 ? uint64_t{1} << device : 0;
    if ((configured.load() & bit) == 0 || bit == 0) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmemPerBlock);
      if (err != cudaSuccess) return err;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return err;
      configured.fetch_or(bit);
    }
    // A block a tile of l.d items, over every row and edge position.
    const int64_t n_tiles = (n_edges + n_rows + l.d - 1) / l.d;
    const ProgArgs<E> g{static_cast<const E*>(c), static_cast<const E*>(hg),
                        static_cast<const int32_t*>(row_ptr), n_rows, n_chan, n_edges};
    kernel<<<static_cast<unsigned>(n_tiles), kProgThreads, l.total,
             static_cast<cudaStream_t>(stream)>>>(g, static_cast<const int32_t*>(seed),
                                                  static_cast<float*>(out), thresh, scale, l);
    return cudaGetLastError();
  };
  // The op pair (bit p of max_bits: op p is max) and dropout at compile time.
  auto by_ops = [&](auto elem, auto drop) -> cudaError_t {
    using I1 = std::integral_constant<int, 1>;
    using I2 = std::integral_constant<int, 2>;
    switch (n_ops == 2 ? max_bits & 3 : 4 + (max_bits & 1)) {
      case 0: return launch(elem, I2(), std::integral_constant<int, 0>(), drop);
      case 1: return launch(elem, I2(), std::integral_constant<int, 1>(), drop);
      case 2: return launch(elem, I2(), std::integral_constant<int, 2>(), drop);
      case 3: return launch(elem, I2(), std::integral_constant<int, 3>(), drop);
      case 4: return launch(elem, I1(), std::integral_constant<int, 0>(), drop);
      default: return launch(elem, I1(), std::integral_constant<int, 1>(), drop);
    }
  };
  auto by_drop = [&](auto elem) {
    return seed != nullptr ? by_ops(elem, std::true_type()) : by_ops(elem, std::false_type());
  };
  return static_cast<int>(bf16 ? by_drop(bf16_t()) : by_drop(float()));
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
