// Hopper (sm_90a) kernels of the MMA node-classification forward and
// backward (the lean and the wide edge program) and of the ZINC
// convolution's sum and sum-of-squares reductions.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (mma_tpu_torch/ops/cuda/build.py). Each entry point launches
// on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper raises on a refused
// launch. Every reduction runs over the dst-sorted CSR (or its CSC twin)
// in a fixed order: each output element is written exactly once, so there
// are no atomics and the results are deterministic; rows with no edges
// get 0.
//
// Kernels 1-3 and 8-12 also read bf16 operands (the edge pipeline's
// compute_dtype="bfloat16"): kernels 1 and 8 bf16 data rows, kernels 2
// and 3 a bf16 h, kernels 9-11 bf16 d and h, kernel 12 bf16 logits and/or
// h_src. They widen each value to f32 in registers as they use it, and
// every sum and every output stays f32. Where the JAX package's kernels
// take bf16 inputs with one MXU pass, the pass rounds its f32 operands to
// bf16 (mma_tpu/ops/pallas/fused_mma.py:107-118): the message act(c + D) *
// h before kernel 2 sums it, ct and dlog in kernel 3, the square x * x in
// kernel 8, the message in kernel 12 on bf16 logits. The bf16 variants
// round at the same places (round_bf16), so that the port computes the JAX
// package's bf16 function. The wide program (kernels 9-11) runs two passes
// whatever the dtype, so its bf16 variants round nothing. The f32 kernels
// are unchanged. Conversions go through the cuda_bf16.h intrinsics alone, so
// the source also builds under -D__CUDA_NO_BFLOAT16_CONVERSIONS__.

#include <cuda_bf16.h>
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
// bf16 data (segment_sum_chunk_kernel<VEC, TILES, bf16>) halves the rows:
// 8-byte loads of 4 lanes (C % 4 == 0) or 2-byte scalars, widened to f32 in
// registers; the partials, the fixup and the output stay f32.
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
// chunk it starts in, which writes it directly, even where it runs on
// past the chunk. It is summed as a warp per row would, so where one group
// covers a row (the ZINC widths) it keeps the plain version's sequential
// bits, which the std aggregator's cancelling gradient needs: splitting
// ZINC's 4-edge rows moved a PNA train step's embedding gradient by 2e-3
// relative. A longer row is split at the chunk
// boundaries: the partial of the row that enters the chunk from an
// earlier one goes to the chunk's head slot, and that of the chunk's last
// row, when it goes on past the chunk, to its tail slot: scratch
// (n_chunks, 2, C), and the tail row's id to tail_row.
// Pass 2 (segment_sum_fixup_kernel): one warp per chunk with a tail row
// adds the tail and the later chunks' heads in chunk order and writes the
// row once. Pass 1's body (chunk_pass) takes what it adds per edge as a
// type (RowsOf, the data row itself): kernel 2's edge pass is the same two
// passes with its own message (LeanMessage).
//
// Empty rows are not the chunks' work: all the empty rows between two
// edges start at one edge position, so a graph with many of them in a row
// (a CSR that covers a few rows of many) would hand them all to the one
// warp whose chunk holds that position. A chunk's warp leaves them out and
// steps over a window of them to the next row that may have edges with
// one search of row_ptr; pass 2 also runs zeroing warps, each writing 0 to
// the empty rows among kSumZeroRows consecutive rows.
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
constexpr int kSumZeroRows = 256;  // rows a zeroing warp of pass 2 covers

int sum_chunk_edges(int n_edges) {
  int chunk = kSumMinChunk;
  while (static_cast<int64_t>(chunk) * kSumTargetChunks < n_edges) chunk <<= 1;
  return chunk;
}

int sum_n_chunks(int n_edges) {
  const int chunk = sum_chunk_edges(n_edges);
  return max(1, (n_edges + chunk - 1) / chunk);
}

// Pass 2's blocks: a warp per chunk, then the zeroing warps of n_rows rows.
int sum_fixup_blocks(int n_chunks, int n_rows) {
  const int warps = n_chunks + (n_rows + kSumZeroRows - 1) / kSumZeroRows;
  return (warps + kSumWarps - 1) / kSumWarps;
}

// Lanes per edge for rows of n_vec slots: the power of two that covers a
// narrow row, else 32 or 16 lanes, whichever divides the row (C=192: 3
// slots of 16 lanes).
int lanes_per_edge(int n_vec) {
  int lpe = 1;
  while (lpe < n_vec && lpe < kWarp) lpe <<= 1;
  if (n_vec > kWarp && n_vec % kWarp != 0 && n_vec % (kWarp / 2) == 0) lpe = kWarp / 2;
  return lpe;
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

// Slots of VEC lanes of element type E in device memory (Raw) and their f32
// value in registers (widen): f32 slots are float4 / float, bf16 slots
// an 8-byte uint2 of 4 lanes / one 16-bit lane, widened where they are
// used, so a bf16 row in flight holds half the registers of an f32 one.
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_bits(unsigned int u) {  // the low 16 bits as a bf16
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(u & 0xffffu)));
}

template <typename E>
struct Type {  // a tag: the element type of a launch's operand, chosen at run time
  using type = E;
};

template <int VEC, typename E>
struct Slots;
template <>
struct Slots<4, float> {
  using Raw = float4;
  __device__ static Raw load(const Raw* p) { return __ldg(p); }
  __device__ static float4 widen(const Raw& r) { return r; }
  __device__ static Raw zero() { return Vec<4>::zero(); }
};
template <>
struct Slots<1, float> {
  using Raw = float;
  __device__ static Raw load(const Raw* p) { return __ldg(p); }
  __device__ static float widen(Raw r) { return r; }
  __device__ static Raw zero() { return 0.f; }
};
template <>
struct Slots<4, bf16> {
  using Raw = uint2;
  __device__ static Raw load(const Raw* p) { return __ldg(p); }
  __device__ static float4 widen(const Raw& r) {
    return make_float4(bf16_bits(r.x), bf16_bits(r.x >> 16), bf16_bits(r.y), bf16_bits(r.y >> 16));
  }
  __device__ static Raw zero() { return make_uint2(0u, 0u); }
};
template <>
struct Slots<1, bf16> {
  using Raw = unsigned short;
  __device__ static Raw load(const Raw* p) { return __ldg(p); }
  __device__ static float widen(Raw r) { return bf16_bits(r); }
  __device__ static Raw zero() { return 0; }
};

// Four consecutive values of type E in shared memory (8- or 16-byte
// aligned), as f32.
template <typename E>
__device__ __forceinline__ float4 smem_lanes4(const E* p) {
  if constexpr (std::is_same<E, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return Slots<4, bf16>::widen(*reinterpret_cast<const uint2*>(p));
  }
}

// x rounded to bf16 (to nearest, ties to even) and back: the JAX kernels'
// one-pass MXU operand on bf16 inputs.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// An operand that the JAX kernel rounds to bf16 when its inputs are bf16
// (E = bf16); as it is for f32 inputs. operand4: on the 4 lanes of a slot.
template <typename E>
__device__ __forceinline__ float operand(float v) {
  if constexpr (std::is_same<E, float>::value) {
    return v;
  } else {
    return round_bf16(v);
  }
}

template <typename E>
__device__ __forceinline__ float4 operand4(const float4& v) {
  if constexpr (std::is_same<E, float>::value) {
    return v;
  } else {
    return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z), round_bf16(v.w));
  }
}

// The element types of an edge-program pass's gathered node tables and its
// rounding policy, chosen at run time (by_form): H, h's type; D, d's type;
// kRound, whether ct and each message are rounded to bf16 (the JAX lean
// kernels' one-pass contractions on a bf16 h). Kernels 2-3 take <E, float,
// E == bf16> (D is the node pass's f32 table); kernels 9-11 take <E, E,
// false>: the JAX wide kernels sum in two bf16 passes whatever the dtype
// (mma_tpu/ops/pallas/fused_mma.py:1380), about f32, so their bf16 form
// reads bf16 d and h and computes and adds in f32 with no rounding.
template <typename EH, typename ED, bool ROUND>
struct Form {
  using H = EH;
  using D = ED;
  static constexpr bool kRound = ROUND;
};

// launch(Form<...>()) for the forms the flags name: f32 (0, 0, 0), the lean
// bf16 form (1, 0, 1) and the wide bf16 form (1, 1, 0); another
// combination is refused.
template <typename Launch>
cudaError_t by_form(int h_bf16, int d_bf16, int round, Launch launch) {
  if (!h_bf16 && !d_bf16 && !round) return launch(Form<float, float, false>());
  if (h_bf16 && !d_bf16 && round) return launch(Form<bf16, float, true>());
  if (h_bf16 && d_bf16 && !round) return launch(Form<bf16, bf16, false>());
  return cudaErrorInvalidValue;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// mask and dmask of one lane.
__device__ __forceinline__ void mask_chain(float x, float p, float& m, float& dm) {
  const float sg = sigmoidf(x);
  m = p != 0.f ? sg : x;
  dm = p != 0.f ? sg * (1.f - sg) : 1.f;
}

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

// After a window of empty rows that all start (and end) at edge position
// p: the last row that starts at p, the first one after them that may
// have edges (n_rows - 1 if none).
__device__ __forceinline__ int last_row_at(const int32_t* __restrict__ row_ptr, int n_rows,
                                        int64_t p) {
  const int64_t keys[2] = {p + 1, p + 1};
  int found[2];
  lower_bound2(row_ptr, n_rows, keys, found);
  return found[0] - 1;
}

// The data row that edge position e reads, or -1 past the end re.
__device__ __forceinline__ int64_t edge_row(const int32_t* __restrict__ index, int64_t e,
                                            int64_t re) {
  return e < re ? (index != nullptr ? static_cast<int64_t>(__ldg(index + e)) : e) : -1;
}

// Pass 2's zeroing warp z: 0 in the empty rows among rows [z R, (z + 1) R),
// R = kSumZeroRows, 32 rows a step; a step of 32 empty rows is one
// contiguous store.
template <int VEC>
__device__ __forceinline__ void zero_empty_rows(const int32_t* __restrict__ row_ptr,
                                                float* __restrict__ out, int z, int n_rows,
                                                int n_vec) {
  using T = typename Vec<VEC>::T;
  const int lane = threadIdx.x % kWarp;
  const int r0 = z * kSumZeroRows;
  const int r_end = min(n_rows, r0 + kSumZeroRows);
  T* outv = reinterpret_cast<T*>(out);
  for (int rb = r0; rb < r_end; rb += kWarp) {
    const int r = rb + lane;
    const bool empty = r < r_end && __ldg(row_ptr + r) == __ldg(row_ptr + r + 1);
    unsigned m = __ballot_sync(0xffffffffu, empty);
    if (m == 0xffffffffu) {
      T* z_rows = outv + static_cast<int64_t>(rb) * n_vec;
      for (int i = lane; i < kWarp * n_vec; i += kWarp) z_rows[i] = Vec<VEC>::zero();
      continue;
    }
    while (m) {
      const int k = __ffs(m) - 1;
      m &= m - 1;
      T* z_row = outv + static_cast<int64_t>(rb + k) * n_vec;
      for (int cv = lane; cv < n_vec; cv += kWarp) z_row[cv] = Vec<VEC>::zero();
    }
  }
}

// What the chunk pass adds for each edge, on a lane's slot cv (16 bytes, or
// one float) of an output row. A message type has
//   kSums: the sums a slot keeps (an output row holds kSums blocks of
//                       n_vec slots; slot cv's sum a goes to cv + a n_vec);
//   Slot slot(row, cv): what the output row gives the slot, loaded
//                       once per row (no_slot() past the row's end);
//   Edge load(r, cv, slot): the loads of data row r, issued for several
//                       edges before any of them is added (none(): no edge);
//   kKeyed: whether the message also reads an operand of the edge itself
//                       (mask dropout's keep). If so, chunk_pass calls
//                       load(r, e, cv, slot) with the edge's position e;
//   add(acc, edge, slot): the edge's message added into acc[0 .. kSums)
//                       (static, or a member that reads the message);
//   kEmits: whether the message also writes a row per edge. If so,
//                       chunk_pass calls emit(acc, edges, slots, e, ...) in
//                       place of add for each edge it loads, with the edge's
//                       position e (-1: no edge), warp-uniformly, and
//                       zero_uncovered(a, b, lo, hi) once per chunk [a, b);
//   kFolds: whether the output row is [sum 0 || sum 1 folded over its K
//                       blocks of f_vec slots], n_vec + f_vec slots
//                       (out_slots). If so, chunk_pass calls store(acc,
//                       dst, on, t0, lpe, li) with every lane of the warp
//                       in place of its own stores, `on` for the lanes
//                       whose group holds the row;
// and in_flight<TILES>(), the edges whose loads a lane issues before it
// adds them. RowsOf is kernel 1's (the data row itself); LeanMessage,
// kernels 2 and 9's, LeanDcMessage, kernels 3 and 10's, LeanSrcMessage,
// kernel 3's, the three Lean*KeepMessage, kernels 2 and 3's with mask
// dropout's keep, LeanDcPayloadMessage, kernel 10's with its per-edge
// payload, LeanSrcFoldMessage, kernel 11's, and MaskedMessage, kernel
// 12's, are below with those kernels.
template <int VEC_, typename E = float>
struct RowsOf {
  static constexpr int VEC = VEC_;
  static constexpr int kSums = 1;
  static constexpr bool kEmits = false;
  static constexpr bool kFolds = false;
  static constexpr bool kKeyed = false;
  // About 32 floats in flight a lane.
  template <int TILES>
  __host__ __device__ static constexpr int in_flight() {
    return TILES * VEC >= 12 ? 2 : (TILES * VEC >= 8 ? 4 : 8);
  }
  using T = typename Vec<VEC>::T;
  using S = Slots<VEC, E>;
  struct Slot {};
  struct Edge {
    typename S::Raw v;
  };
  const typename S::Raw* rows;
  int n_vec;
  __device__ Slot slot(int64_t, int) const { return {}; }
  __device__ static Slot no_slot() { return {}; }
  __device__ Edge load(int64_t r, int cv, const Slot&) const {
    return {S::load(rows + r * n_vec + cv)};
  }
  __device__ static Edge none() { return {S::zero()}; }
  __device__ static void add(T (&acc)[1], const Edge& e, const Slot&) {
    Vec<VEC>::add(acc[0], S::widen(e.v));
  }
};

// The slots of an output row (and of a partial) of message Msg, whose sums
// are n_vec slots each.
template <class Msg>
__host__ __device__ __forceinline__ int out_slots(const Msg& msg, int n_vec) {
  if constexpr (Msg::kFolds) {
    return n_vec + msg.f_vec;
  } else {
    return Msg::kSums * n_vec;
  }
}

// The loads of edge position e, which reads data row r, for a lane's slot cv.
template <class Msg>
__device__ __forceinline__ typename Msg::Edge load_edge(const Msg& msg, int64_t r, int64_t e,
                                                        int cv, const typename Msg::Slot& s) {
  if constexpr (Msg::kKeyed) {
    return msg.load(r, e, cv, s);
  } else {
    return msg.load(r, cv, s);
  }
}

// Pass 1, for any message type Msg: the body of kernel 1's
// segment_sum_chunk_kernel, of kernels 2 and 9's lean_edge_kernel, of
// kernels 3, 10 and 11's lean_bwd_edge_kernel and of kernel 12's
// masked_edge_kernel. TILES: the lane's channel
// slots per edge (a compile-time bound on `tiles`; wider rows take several
// rounds over the row's edges). U: edges a group loads before it adds
// them. n_vec counts the slots of one sum; an output row (and a partial)
// holds out_slots(msg, n_vec).
template <class Msg, int TILES>
__device__ __forceinline__ void chunk_pass(const Msg& msg, const int32_t* __restrict__ row_ptr,
                                           const int32_t* __restrict__ index,
                                           float* __restrict__ out, float* __restrict__ part,
                                           int32_t* __restrict__ tail_row, int n_rows, int n_vec,
                                           int lpe, int tiles, int chunk, int n_chunks) {
  using V = Vec<Msg::VEC>;
  using T = typename V::T;
  using Slot = typename Msg::Slot;
  using Edge = typename Msg::Edge;
  constexpr int U = Msg::template in_flight<TILES>();
  constexpr int A = Msg::kSums;
  const int row_vec = out_slots(msg, n_vec);
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
  if constexpr (Msg::kEmits) msg.zero_uncovered(a, b, __ldg(row_ptr), hi);

  T* outv = reinterpret_cast<T*>(out);
  T* head_slot = reinterpret_cast<T*>(part) + static_cast<int64_t>(c) * 2 * row_vec;
  T* tail_slot = head_slot + row_vec;
  int64_t wb = -2 * kWarp;  // the index window [wb, wb + 32), empty at first
  int widx = 0;

  for (int rb = head ? i0 - 1 : i0; rb < i1; rb += kWarp) {
    const int r = rb + lane;
    const bool live = r < i1;
    const int s = live ? __ldg(row_ptr + r) : 0;
    const int e = live ? __ldg(row_ptr + r + 1) : 0;
    const unsigned live_mask = __ballot_sync(0xffffffffu, live);
    const unsigned empty = __ballot_sync(0xffffffffu, live && s == e);
    if (empty == live_mask) {
      // Empty rows only (pass 2 writes them), all at one edge position: go
      // on from the first row after them that may have edges.
      rb = max(rb, last_row_at(row_ptr, n_rows, __shfl_sync(0xffffffffu, s, 0)) - kWarp);
      continue;
    }
    // Rows shorter than half a warp step: one row a group, `groups` rows at
    // a time, each summed in CSR order, the next step's rows fetched before
    // this step's adds. The other rows with edges take the whole warp, one
    // at a time.
    const int64_t my_re = e - s > split && e > b ? b : e;
    const unsigned batched = __ballot_sync(
        0xffffffffu, groups > 1 && live && s != e && 2 * (my_re - (s > a ? s : a)) <= step);
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
                                                 : outv + static_cast<int64_t>(row) * row_vec);
      for (int t0 = 0; t0 < tiles; t0 += TILES) {
        T acc[TILES][A];
        Slot sl[TILES];
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
#pragma unroll
          for (int a_ = 0; a_ < A; ++a_) acc[t][a_] = V::zero();
          const int cv = (t0 + t) * lpe + li;
          sl[t] = cv < n_vec ? msg.slot(row, cv) : Msg::no_slot();
        }
        int64_t src[U];
#pragma unroll
        for (int u = 0; u < U; ++u) src[u] = edge_row(index, rs + u, re);
        for (unsigned j = 0; j < max_len; j += U) {
          Edge v[U][TILES];
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < TILES; ++t) {
              const int cv = (t0 + t) * lpe + li;
              v[u][t] = src[u] >= 0 && cv < n_vec ? load_edge(msg, src[u], rs + j + u, cv, sl[t])
                                                  : Msg::none();
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) src[u] = edge_row(index, rs + j + U + u, re);
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if constexpr (Msg::kEmits) {
              const int64_t pos = rs + j + u < re ? rs + j + u : -1;  // re = rs = 0 unless mine
              msg.template emit<TILES>(acc, v[u], sl, pos, t0, lpe, li);
            } else {
#pragma unroll
              for (int t = 0; t < TILES; ++t) msg.add(acc[t], v[u][t], sl[t]);
            }
          }
        }
        if constexpr (Msg::kFolds) {
          msg.template store<TILES>(acc, dst, mine >= 0, t0, lpe, li);
        } else if (mine >= 0) {
#pragma unroll
          for (int t = 0; t < TILES; ++t) {
            const int cv = (t0 + t) * lpe + li;
            if (cv < n_vec) {
#pragma unroll
              for (int a_ = 0; a_ < A; ++a_) dst[cv + a_ * n_vec] = acc[t][a_];
            }
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
      if (row_s == row_e) continue;  // empty: pass 2 writes it
      // A long row's edges inside this chunk; a short one whole.
      const int64_t rs = row_s > a ? row_s : a;
      const int64_t re = row_e - row_s > split && row_e > b ? b : row_e;
      T* dst = row < i0 ? head_slot
                        : (tail && row == i1 - 1 ? tail_slot
                                                 : outv + static_cast<int64_t>(row) * row_vec);
      for (int t0 = 0; t0 < tiles; t0 += TILES) {
        T acc[TILES][A];
        Slot sl[TILES];
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
#pragma unroll
          for (int a_ = 0; a_ < A; ++a_) acc[t][a_] = V::zero();
          const int cv = (t0 + t) * lpe + li;
          sl[t] = cv < n_vec ? msg.slot(row, cv) : Msg::no_slot();
        }
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
          Edge v[U][TILES];
#pragma unroll
          for (int u = 0; u < U; ++u) {
#pragma unroll
            for (int t = 0; t < TILES; ++t) {
              const int cv = (t0 + t) * lpe + li;
              v[u][t] = src[u] >= 0 && cv < n_vec
                            ? load_edge(msg, src[u], e0 + u * groups + g, cv, sl[t])
                            : Msg::none();
            }
          }
#pragma unroll
          for (int u = 0; u < U; ++u) {
            if constexpr (Msg::kEmits) {
              const int64_t ee = e0 + u * groups + g;
              msg.template emit<TILES>(acc, v[u], sl, u < uu && ee < re ? ee : -1, t0, lpe, li);
            } else {
#pragma unroll
              for (int t = 0; t < TILES; ++t) msg.add(acc[t], v[u][t], sl[t]);
            }
          }
        }
        if (rs < re) {
#pragma unroll
          for (int t = 0; t < TILES; ++t) {
#pragma unroll
            for (int a_ = 0; a_ < A; ++a_) {
              for (int off = lpe; off < kWarp; off <<= 1) {
                V::add(acc[t][a_], V::shfl_xor(acc[t][a_], off));
              }
            }
          }
        }
        if constexpr (Msg::kFolds) {
          msg.template store<TILES>(acc, dst, g == 0, t0, lpe, li);
        } else if (g == 0) {
#pragma unroll
          for (int t = 0; t < TILES; ++t) {
            const int cv = (t0 + t) * lpe + li;
            if (cv < n_vec) {
#pragma unroll
              for (int a_ = 0; a_ < A; ++a_) dst[cv + a_ * n_vec] = acc[t][a_];
            }
          }
        }
      }
    }
  }
}

// Pass 2: the long rows that cross a chunk boundary, one warp per chunk
// whose tail row goes on: the tail partial, then the heads of the later
// chunks the row reaches, in chunk order; then the zeroing warps, which
// write the empty rows.
template <int VEC>
__global__ void __launch_bounds__(kSumWarps* kWarp)
segment_sum_fixup_kernel(const int32_t* __restrict__ row_ptr, const float* __restrict__ part,
                         const int32_t* __restrict__ tail_row, float* __restrict__ out,
                         int n_rows, int n_vec, int chunk, int n_chunks) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int c = blockIdx.x * kSumWarps + threadIdx.x / kWarp;
  if (c >= n_chunks) {  // a zeroing warp, or past them (whole warps leave together)
    if (static_cast<int64_t>(c - n_chunks) * kSumZeroRows < n_rows) {
      zero_empty_rows<VEC>(row_ptr, out, c - n_chunks, n_rows, n_vec);
    }
    return;
  }
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

template <int VEC, int TILES, typename E>
__global__ void __launch_bounds__(kSumWarps* kWarp)
segment_sum_chunk_kernel(const E* __restrict__ data, const int32_t* __restrict__ row_ptr,
                         const int32_t* __restrict__ index, float* __restrict__ out,
                         float* __restrict__ part, int32_t* __restrict__ tail_row,
                         int n_rows, int n_vec, int lpe, int tiles, int chunk, int n_chunks) {
  using Rows = RowsOf<VEC, E>;
  const Rows rows{reinterpret_cast<const typename Rows::S::Raw*>(data), n_vec};
  chunk_pass<Rows, TILES>(rows, row_ptr, index, out, part, tail_row, n_rows, n_vec, lpe, tiles,
                          chunk, n_chunks);
}

// Pass 2 (a warp per chunk, then the zeroing warps) after pass 1 has been
// launched.
template <int VEC>
cudaError_t launch_fixup(const void* row_ptr, const void* part, const void* tail_row, void* out,
                         int n_rows, int n_vec, int chunk, int n_chunks, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_sum_fixup_kernel<VEC><<<sum_fixup_blocks(n_chunks, n_rows), kSumWarps * kWarp, 0, s>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const float*>(part),
      static_cast<const int32_t*>(tail_row), static_cast<float*>(out), n_rows, n_vec, chunk,
      n_chunks);
  return cudaGetLastError();
}

template <int VEC, int TILES, typename E>
cudaError_t launch_segment_sum(const void* data, const void* row_ptr, const void* index,
                               void* out, void* part, void* tail_row, int n_rows, int n_vec,
                               int lpe, int tiles, int chunk, int n_chunks, cudaStream_t s) {
  const int blocks = (n_chunks + kSumWarps - 1) / kSumWarps;
  segment_sum_chunk_kernel<VEC, TILES, E><<<blocks, kSumWarps * kWarp, 0, s>>>(
      static_cast<const E*>(data), static_cast<const int32_t*>(row_ptr),
      static_cast<const int32_t*>(index), static_cast<float*>(out), static_cast<float*>(part),
      static_cast<int32_t*>(tail_row), n_rows, n_vec, lpe, tiles, chunk, n_chunks);
  return launch_fixup<VEC>(row_ptr, part, tail_row, out, n_rows, n_vec, chunk, n_chunks, s);
}

// ---------------------------------------------------------------------------
// Kernel 2: edge_program_lean_fwd
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_program_fwd_lean_kernel
// (launched by _fused_program_fwd_lean):
//   S[i] = sum_{e: dst_e = i} act(c[i] + h[src_e] @ W_bot) * tile(h[src_e], K)
// with act = sigmoid on lanes where pat is 1 and the identity elsewhere.
//
// The TPU kernel recomputes h[src_e] @ W_bot for every edge on the MXU so
// that its per-edge gather is the 128-lane h row: a 192-lane [d || h] row
// hits an XLA gather cliff there. On this card the trade runs the other
// way. The per-edge product is 2 F K*F FLOPs on CUDA cores (34.4 GFLOP at
// the synthetic-large graph, 0.51 ms at the f32 peak), while 16-byte
// gathers are cheap and the 50 MB L2 holds much of the node tables. The
// product depends on src_e alone, so it is done once per node:
//
// Node pass (lean_node_kernel): D = h @ W_bot, (N, F) x (F, K*F) in f32
// FMAs, into a table of its own: the edge pass reads a D row and an h row
// per edge (one interleaved [D || h] row per edge measured 1% slower on
// the card, its node pass writing h once more). A block keeps
// W_bot's 128-lane tile in shared memory and walks blocks of 64 node rows
// (a persistent grid), staging the next block of h with 16-byte cp.async
// copies while it multiplies the current one; a thread accumulates 8 rows
// x 4 lanes in registers, over F in order. 2 N F K*F = 2.15 GFLOP at
// synthetic-large (N = 131k, F = 64, K*F = 128), 16x less than per edge.
//
// Edge pass (lean_edge_kernel, then segment_sum_fixup_kernel): kernel 1's
// two passes, the first with LeanMessage (chunk_pass), the message
// act(c[row] + D[src]) * h[src, l mod F] on each 16-byte slot: c[row] and
// the pattern are loaded once per row segment, a lane selects sigmoid or
// the identity per lane of its slot (a row may mix them), and two edges'
// D and h slots are in flight before their FMAs, in at most 64 registers
// so that 32 warps share an SM. So skew and
// determinism are kernel 1's: edge positions in chunks sized from E alone,
// one warp each; rows of at most max(chunk, 64) edges summed whole, in CSR
// order, by the chunk they start in; the power-law graph's 1,448-edge row
// split into head and tail partials that the fixup adds in chunk order.
// Every row is written once (empty rows as 0, by pass 2's zeroing warps),
// with no atomics and no host sync: bitwise equal run to run, and a call
// replays in a CUDA graph. A lane takes at most two slots of a row per
// pass, so K*F = 384 or 512 takes two rounds over each row's edges.
//
// Bound on this card: bytes. Each input read once and the output written
// once: c 67.1 + h 33.6 + src 8.4 + row_ptr 0.5 + S 67.1 ~ 177 MB at
// synthetic-large (E = 2.1M), 0.053 ms at 3.35 TB/s, above 2.15 GFLOP of
// node products and 3 E K*F = 0.81 GFLOP per edge (0.044 ms at 67
// TFLOP/s). The random table rows the edge pass gathers are E x 768 B =
// 1.61 GB, 0.481 ms, less what the L2 keeps of the 67 MB D and 34 MB h:
// that sets its time.
//
// bf16 h (lean_node_kernel<bf16>, LeanMessage<bf16>): h is read as bf16
// from device memory, staged by the node pass and gathered by the edge pass
// 8 bytes a slot; D, c and S stay f32. Of the 768 B a gathered edge row is
// only h's 256 B halve (640 B), and h in the bound's bytes 33.6 -> 16.8 MB.
//
// Mask dropout (LeanKeepMessage, f32 only): the caller's keep rows (E, K*F)
// bool are an operand, read at each edge's CSR position as one 32-bit word
// a slot, in the order the chunks walk the edges; a dropped lane adds
// nothing, a kept one its mask times 1 / (1 - rate). The keep adds E x K*F
// bytes (268 MB at synthetic-large, 0.08 ms) to the gathers' 1.61 GB, so
// the gathers still set the time. The draw is the caller's (torch.rand):
// no kernel draws.
// ---------------------------------------------------------------------------

constexpr int kLaneTile = 128;  // output lanes per block (32 lanes x 4)
constexpr int kNodeRows = 64;   // node rows per step of the node pass
constexpr int kNodeWarps = 8;   // warp w takes rows w, w + 8, ..., w + 56
constexpr int kNodeRowsPerWarp = kNodeRows / kNodeWarps;

size_t node_smem_bytes(int f, size_t h_elem) {
  // W_bot's lane tile [f][128] f32 and two row blocks of h [64][f] of h's type.
  return sizeof(float) * static_cast<size_t>(f) * kLaneTile +
         2 * static_cast<size_t>(kNodeRows) * f * h_elem;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = full ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The first `bytes` (a multiple of 8, at most 16) of 16 bytes, the rest
// filled with zeros.
__device__ __forceinline__ void cp_async16_part(void* smem, const void* gmem, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(bytes)
               : "memory");
}

// Rows [first, first + n_rows) of a row-major table of rows of `row_bytes`
// bytes (16-byte aligned, rows a multiple of 8 bytes), as the contiguous
// byte range they are, into dst in 16-byte pieces, with zeros past row
// `end`: 16-byte copies whatever the row width (a bf16 row of F % 8 == 4
// values is 8 bytes past a 16-byte multiple), with a part copy at the end.
__device__ __forceinline__ void stage_rows(void* dst, const void* table, int64_t first,
                                           int n_rows, int64_t end, int row_bytes) {
  const char* src = static_cast<const char*>(table) + first * row_bytes;
  const int64_t have = (end > first ? (end - first < n_rows ? end - first : n_rows) : 0) *
                       static_cast<int64_t>(row_bytes);
  const int pieces = n_rows * row_bytes / 16;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) {
    const int64_t off = static_cast<int64_t>(i) * 16;
    const int64_t left = have - off;
    const int bytes = left >= 16 ? 16 : (left > 0 ? static_cast<int>(left) : 0);
    cp_async16_part(static_cast<char*>(dst) + off, bytes > 0 ? src + off : table, bytes);
  }
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d = h @ w_bot, h f32 or bf16 (E), sums and d f32. A bf16 h times a
// W_bot of bf16 values gives exact f32 products, so d is then the f32 sum of
// exact products in k order. Grid: (persistent, ceil(kf / 128) lane tiles).
template <typename E>
__global__ void __launch_bounds__(kNodeWarps* kWarp)
lean_node_kernel(const E* __restrict__ h, const float* __restrict__ w_bot,
                 float* __restrict__ d, int n_rows, int f, int kf) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);        // [f][kLaneTile]
  E* h_s = reinterpret_cast<E*>(w_s + f * kLaneTile);  // [2][kNodeRows][f]
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int l_base = blockIdx.y * kLaneTile;
  const int l0 = l_base + 4 * lane;  // this thread's 4 lanes
  const int n_blocks = (n_rows + kNodeRows - 1) / kNodeRows;

  // The row block b of h into buffer buf, zeros past the last row.
  auto stage = [&](int b, int buf) {
    stage_rows(h_s + buf * kNodeRows * f, h, static_cast<int64_t>(b) * kNodeRows, kNodeRows,
               n_rows, f * static_cast<int>(sizeof(E)));
    cp_async_commit();
  };

  int b = blockIdx.x;
  if (b < n_blocks) stage(b, 0);
  for (int idx = threadIdx.x; idx < f * kLaneTile; idx += blockDim.x) {
    const int l = l_base + idx % kLaneTile;
    w_s[idx] = l < kf ? __ldg(w_bot + static_cast<int64_t>(idx / kLaneTile) * kf + l) : 0.f;
  }
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + lane;
  for (int buf = 0; b < n_blocks; b += gridDim.x, buf ^= 1) {
    if (b + static_cast<int>(gridDim.x) < n_blocks) {
      stage(b + gridDim.x, buf ^ 1);  // in flight below
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // block b's rows (and W_bot's tile) are in shared memory
    const E* hb = h_s + buf * kNodeRows * f;
    float acc[kNodeRowsPerWarp][4] = {};
#pragma unroll 2
    for (int k = 0; k < f; k += 4) {
      float4 w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) w[kk] = w4[(k + kk) * (kLaneTile / 4)];
#pragma unroll
      for (int i = 0; i < kNodeRowsPerWarp; ++i) {
        // Every lane of the warp reads the same h row: a broadcast.
        const float4 hv = smem_lanes4(hb + (warp + kNodeWarps * i) * f + k);
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          acc[i][0] = fmaf(hk[kk], w[kk].x, acc[i][0]);
          acc[i][1] = fmaf(hk[kk], w[kk].y, acc[i][1]);
          acc[i][2] = fmaf(hk[kk], w[kk].z, acc[i][2]);
          acc[i][3] = fmaf(hk[kk], w[kk].w, acc[i][3]);
        }
      }
    }
    if (l0 < kf) {  // kf % 4 == 0, so all 4 lanes or none
#pragma unroll
      for (int i = 0; i < kNodeRowsPerWarp; ++i) {
        const int row = b * kNodeRows + warp + kNodeWarps * i;
        if (row < n_rows) {
          *reinterpret_cast<float4*>(d + static_cast<int64_t>(row) * kf + l0) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        }
      }
    }
    __syncthreads();  // this buffer is read before the next step restages it
  }
}

// The edge pass's message: act(c[row] + d[r]) * h[r, l mod F] on slots of 4
// lanes, in the form Fm (Form): h and d read as Fm::H and Fm::D and widened to
// f32; with Fm::kRound the message is rounded to bf16 before it is added, as
// the JAX lean kernel's one-pass contraction rounds it.
template <class Fm>
struct LeanMessage {
  static constexpr int VEC = 4;
  static constexpr int kSums = 1;
  static constexpr bool kEmits = false;
  static constexpr bool kFolds = false;
  static constexpr bool kKeyed = false;
  // Two edges' d and h slots in flight (see lean_edge_kernel).
  template <int TILES>
  __host__ __device__ static constexpr int in_flight() {
    return 2;
  }
  using HS = Slots<4, typename Fm::H>;
  using DS = Slots<4, typename Fm::D>;
  struct Slot {
    float4 c, p;  // c[row] and the pattern on the slot's 4 lanes
    int hv;       // the slot of h that the lanes read: cv mod F/4
  };
  struct Edge {
    typename DS::Raw d;
    typename HS::Raw h;
  };
  const float4* c;
  const float4* pat;
  const typename DS::Raw* d;
  const typename HS::Raw* h;
  int n_vec, f_vec;  // slots of a K*F row (c, d) and of an F row (h)

  __device__ Slot slot(int64_t row, int cv) const {
    return {__ldg(c + row * n_vec + cv), __ldg(pat + cv), cv % f_vec};
  }
  __device__ static Slot no_slot() { return {Vec<4>::zero(), Vec<4>::zero(), 0}; }
  __device__ Edge load(int64_t r, int cv, const Slot& s) const {
    return {DS::load(d + r * n_vec + cv), HS::load(h + r * f_vec + s.hv)};
  }
  __device__ static Edge none() { return {DS::zero(), HS::zero()}; }
  __device__ static float term(float acc, float c, float p, float d, float h) {
    const float x = c + d;
    if constexpr (!Fm::kRound) {
      return fmaf(p != 0.f ? sigmoidf(x) : x, h, acc);
    } else {
      return acc + round_bf16(__fmul_rn(p != 0.f ? sigmoidf(x) : x, h));
    }
  }
  __device__ static void add(float4 (&acc)[1], const Edge& e, const Slot& s) {
    const float4 d = DS::widen(e.d);
    const float4 h = HS::widen(e.h);
    acc[0].x = term(acc[0].x, s.c.x, s.p.x, d.x, h.x);
    acc[0].y = term(acc[0].y, s.c.y, s.p.y, d.y, h.y);
    acc[0].z = term(acc[0].z, s.c.z, s.p.z, d.z, h.z);
    acc[0].w = term(acc[0].w, s.c.w, s.p.w, d.w, h.w);
  }
};

// Mask dropout's keep (N2), an operand of kernels 2 and 3: the caller's
// (E, K*F) bool rows of torch.rand(...) >= rate, one byte a lane (0 or 1),
// row e for the edge at CSR position e. No kernel draws. A slot's 4 lanes
// are one aligned 32-bit word, so a lane group reads an edge's K*F bytes
// in one coalesced pass (128 B at K*F = 128, a quarter of its D row). The
// forward and the dst pass read row e at the CSR position they walk; the
// src pass walks the CSC and reads row perm[j] (Graph.src_perm, the CSR
// edge of CSC position j), a dependent load beside its c and ct gathers. A
// kept lane's factor is scale = 1 / (1 - rate) (as torch's f32 division by
// a scalar computes it on the card), a dropped lane's 0.
struct KeepRows {
  const uint32_t* words;  // row e's slot cv: words[e * n_vec + cv]
  const int32_t* perm;    // the row of position e: perm[e], or e when null
  float scale;

  __device__ uint32_t load(int64_t e, int cv, int n_vec) const {
    const int64_t row = perm != nullptr ? static_cast<int64_t>(__ldg(perm + e)) : e;
    return __ldg(words + row * n_vec + cv);
  }
  // Lane b (0-3) of a slot's word: scale if kept, 0 if dropped.
  __device__ float factor(uint32_t w, int b) const {
    return (w >> (8 * b)) & 0xffu ? scale : 0.f;
  }
};

// Kernel 2's edge pass with mask dropout: LeanMessage's loads and the edge's
// keep word, and the message (keep ? act(c[row] + d[r]) * scale : 0) *
// h[r, l mod F]. float32 tables only (the bf16 forms keep their route).
// Bound on this card as LeanMessage: the gathers of D and h rows set the
// time; the keep adds E x K*F bytes read in CSR order (268 MB at the
// synthetic-large graph, 0.08 ms at 3.35 TB/s) and one register an edge.
struct LeanKeepMessage : LeanMessage<Form<float, float, false>> {
  using Base = LeanMessage<Form<float, float, false>>;
  static constexpr bool kKeyed = true;
  struct Edge {
    Base::Edge tables;
    uint32_t keep;
  };
  KeepRows keep;

  __device__ Edge load(int64_t r, int64_t e, int cv, const Slot& s) const {
    return {Base::load(r, cv, s), keep.load(e, cv, n_vec)};
  }
  __device__ static Edge none() { return {Base::none(), 0u}; }
  __device__ static float term(float acc, float c, float p, float d, float h, float k) {
    const float x = c + d;
    return k != 0.f ? fmaf((p != 0.f ? sigmoidf(x) : x) * k, h, acc) : acc;
  }
  __device__ void add(float4 (&acc)[1], const Edge& e, const Slot& s) const {
    const float4 d = e.tables.d;
    const float4 h = e.tables.h;
    acc[0].x = term(acc[0].x, s.c.x, s.p.x, d.x, h.x, keep.factor(e.keep, 0));
    acc[0].y = term(acc[0].y, s.c.y, s.p.y, d.y, h.y, keep.factor(e.keep, 1));
    acc[0].z = term(acc[0].z, s.c.z, s.p.z, d.z, h.z, keep.factor(e.keep, 2));
    acc[0].w = term(acc[0].w, s.c.w, s.p.w, d.w, h.w, keep.factor(e.keep, 3));
  }
};

// Pass 1 of the edge pass (of kernel 9 too, with the caller's d). Two edges
// in flight and at most 64 registers,
// so that four blocks (32 warps) share an SM: chosen on the card over 4
// and 8 edges in flight and over 2 or 3 blocks per SM, because the
// sigmoids of one warp's edges then run while other warps wait on their
// gathers.
template <class Msg, int TILES>
__global__ void __launch_bounds__(kSumWarps* kWarp, 4)
lean_edge_kernel(const Msg msg, const int32_t* __restrict__ row_ptr,
                 const int32_t* __restrict__ src, float* __restrict__ out,
                 float* __restrict__ part, int32_t* __restrict__ tail_row, int n_rows,
                 int n_vec, int lpe, int tiles, int chunk, int n_chunks) {
  chunk_pass<Msg, TILES>(msg, row_ptr, src, out, part, tail_row, n_rows, n_vec, lpe, tiles,
                         chunk, n_chunks);
}

template <class Msg, int TILES>
cudaError_t launch_lean_edges(const Msg& msg, const void* row_ptr, const void* src,
                              void* out, void* part, void* tail_row, int n_rows, int n_vec,
                              int lpe, int tiles, int chunk, int n_chunks, cudaStream_t s) {
  const int blocks = (n_chunks + kSumWarps - 1) / kSumWarps;
  lean_edge_kernel<Msg, TILES><<<blocks, kSumWarps * kWarp, 0, s>>>(
      msg, static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(src),
      static_cast<float*>(out), static_cast<float*>(part), static_cast<int32_t*>(tail_row),
      n_rows, n_vec, lpe, tiles, chunk, n_chunks);
  return launch_fixup<4>(row_ptr, part, tail_row, out, n_rows, n_vec, chunk, n_chunks, s);
}

// ---------------------------------------------------------------------------
// Kernel 3: edge_program_lean_bwd
//
// Replaces mma_tpu/ops/pallas/fused_mma.py::_program_bwd_lean_kernel
// (launched by _fused_program_bwd_lean), the backward of kernel 2. With
// D = h @ W_bot, on edge e = (s -> i): x_e = c[i] + D[s], mask_e and
// dmask_e the activation and its derivative (sigmoid on the pattern's
// lanes, the identity elsewhere),
//   dlog_e = ct[i] * tile(h[s], K) * dmask_e,   gm_e = ct[i] * mask_e;
//   dc[i]  = sum_{e: dst = i} dlog_e                          (N, K*F)
//   dD[s]  = sum_{e: src = s} dlog_e,  G[s] = sum_{e: src = s} gm_e
//   dW_bot = h^T dD                                           (F, K*F)
//   dh[s]  = sum_k G[s, kF:(k+1)F] + dD[s] @ W_bot^T          (N, F)
// The TPU kernel recomputes h[s] @ W_bot per edge on the MXU, accumulates
// h[s]^T dlog_e per edge and emits a per-edge dh_e = sum_k gm_e + dlog_e @
// W_bot^T, which its caller sums by source. Every one of those products
// depends on the source alone, so here each is done once per node, and
// nothing per edge is stored.
//
// Bound on this card: operations, barely. Each input read once and each
// output written once (c, ct, h, W_bot, the pattern, src, dst_csc, both
// pointer arrays; dc, dW_bot, dh) is about 286 MB at the synthetic-large
// graph (E = 2.1M, N = 131k, F = 64, K*F = 128), 0.085 ms at 3.35 TB/s;
// three node-level products (6 N F K*F = 6.4 GFLOP) and about 10
// operations per edge and lane (2.7 GFLOP) take 0.136 ms at 67 TFLOP/s.
// What sets the time is the random node rows the two edge passes gather,
// E x (768 + 1,024) B = 3.76 GB (1.12 ms), less what the 50 MB L2 keeps.
//
// Design: four steps, eight launches, no per-edge tensor, no per-edge
// product.
// 1. D = h @ W_bot by kernel 2's node pass (lean_node_kernel), recomputed:
//    saving it from the forward would hold 67 MB per layer.
// 2. The dst pass (lean_bwd_edge_kernel<LeanDcMessage>, then kernel 1's
//    fixup): kernel 1's chunk pass over the CSR, gathering through src.
//    c[i], ct[i] and the pattern are loaded once per row segment; per edge
//    a lane gathers its D[s] and h[s] slots and adds dlog_e into dc.
// 3. The src pass (lean_bwd_edge_kernel<LeanSrcMessage>, then the fixup):
//    the same chunk pass over the CSC, gathering through dst_csc. D[s],
//    h[s] and the pattern are loaded once per row segment, c[i] and ct[i]
//    per edge, and a slot keeps two sums that share the edge's loads:
//    dlog_e into dD and gm_e into G, one (N, 2 K*F) row [dD || G].
//    Both passes split a long row (the power-law graph's heaviest
//    destination and heaviest source each have 1,448 edges) into chunk
//    partials that the fixup adds in chunk order, and leave empty rows to
//    the fixup's zeroing warps. Each pass is its own __global__ with its
//    own launch bounds (a bound shared with kernel 1 slows kernel 1):
//    the dst pass at 64 registers (32 warps an SM), the src pass, which
//    keeps twice the sums, at 80 (24 warps), chosen on the card over 3
//    and 4 blocks an SM for the one and 2, 3 and 4 for the other.
// 4. The node pass: lean_dh_kernel (dh = fold_K(G) + dD @ W_bot^T) and
//    lean_dw_kernel (dW_bot's partials h^T dD over slabs of node rows),
//    then sum_slabs_kernel adds the slabs in order. Both are FFMA tiles as
//    lean_node_kernel is, with blocks of rows staged by 16-byte cp.async,
//    double-buffered; lean_dh_kernel streams W_bot in slices of kDhSlice
//    lanes of K*F through shared memory beside the same lanes of dD and
//    of G, whose lanes it folds as they pass (W_bot is 256 KB at F = 128,
//    K*F = 512, more than a block's 227 KB).
// Every partition depends on E, N and the widths alone, never on the card:
// the chunks on E, the slabs on N, F and K*F. Every output row is written
// once, with no atomics and no host sync: bitwise equal run to run, and a
// call replays in a CUDA graph.
// With a bf16 h (LeanDcMessage<bf16>, LeanSrcMessage<bf16>, lean_node_kernel
// and lean_dw_kernel <bf16>) every part that reads h reads it as bf16, ct is
// rounded to bf16 where it is loaded and dlog_e before it is added (the JAX
// kernel's one-pass contractions); lean_dh_kernel and sum_slabs_kernel
// read only f32. dD = sum of the rounded dlog_e, so dW_bot = h^T dD and dD @
// W_bot^T equal the JAX kernel's per-edge sums of the same rounded values.
// With mask dropout (f32 only) the dst and src passes take the keep as an
// operand (LeanDcKeepMessage, LeanSrcKeepMessage): dlog_e and gm_e carry a
// kept lane's factor 1 / (1 - rate) and a dropped lane's 0. The dst pass
// reads the keep at the CSR position it walks; the src pass walks the CSC
// and reads the keep of CSC position j at row src_perm[j], one 128-byte
// row an edge at K*F = 128, a load that waits on src_perm[j] beside the c
// and ct gathers. Two keep reads, 537 MB at synthetic-large, beside the
// passes' 3.76 GB of gathered rows; D, the node pass and the partitions
// are unchanged, and the backward stores no per-edge tensor.
// ---------------------------------------------------------------------------

// The dst pass's message: dlog_e on slots of 4 lanes of a K*F row of dc, in
// the form Fm (Form): h and d read as Fm::H and Fm::D. With Fm::kRound, ct is
// rounded to bf16 as it is loaded and dlog_e before it is added, as in the
// JAX lean kernel.
template <class Fm>
struct LeanDcMessage {
  static constexpr int VEC = 4;
  static constexpr int kSums = 1;
  static constexpr bool kEmits = false;
  static constexpr bool kFolds = false;
  static constexpr bool kKeyed = false;
  static constexpr int kMinBlocks = 4;  // blocks an SM: 64 registers
  template <int TILES>
  __host__ __device__ static constexpr int in_flight() {
    return 2;
  }
  using HS = Slots<4, typename Fm::H>;
  using DS = Slots<4, typename Fm::D>;
  using RoundAs = typename std::conditional<Fm::kRound, bf16, float>::type;
  struct Slot {
    float4 c, ct, p;  // c[row], ct[row] and the pattern on the slot's 4 lanes
    int hv;           // the slot of h that the lanes read: cv mod F/4
  };
  struct Edge {
    typename DS::Raw d;
    typename HS::Raw h;
  };
  const float4* c;
  const float4* ct;
  const float4* pat;
  const typename DS::Raw* d;
  const typename HS::Raw* h;
  int n_vec, f_vec;  // slots of a K*F row (c, ct, d) and of an F row (h)

  __device__ Slot slot(int64_t row, int cv) const {
    return {__ldg(c + row * n_vec + cv), operand4<RoundAs>(__ldg(ct + row * n_vec + cv)),
            __ldg(pat + cv), cv % f_vec};
  }
  __device__ static Slot no_slot() {
    return {Vec<4>::zero(), Vec<4>::zero(), Vec<4>::zero(), 0};
  }
  __device__ Edge load(int64_t r, int cv, const Slot& s) const {
    return {DS::load(d + r * n_vec + cv), HS::load(h + r * f_vec + s.hv)};
  }
  __device__ static Edge none() { return {DS::zero(), HS::zero()}; }
  __device__ static float term(float acc, float c, float ct, float p, float d, float h) {
    float m, dm;
    mask_chain(c + d, p, m, dm);
    if constexpr (!Fm::kRound) {
      return acc + ct * h * dm;
    } else {
      return acc + round_bf16(__fmul_rn(__fmul_rn(ct, h), dm));
    }
  }
  __device__ static void add(float4 (&acc)[1], const Edge& e, const Slot& s) {
    const float4 d = DS::widen(e.d);
    const float4 h = HS::widen(e.h);
    acc[0].x = term(acc[0].x, s.c.x, s.ct.x, s.p.x, d.x, h.x);
    acc[0].y = term(acc[0].y, s.c.y, s.ct.y, s.p.y, d.y, h.y);
    acc[0].z = term(acc[0].z, s.c.z, s.ct.z, s.p.z, d.z, h.z);
    acc[0].w = term(acc[0].w, s.c.w, s.ct.w, s.p.w, d.w, h.w);
  }
};

// Kernel 3's dst pass with mask dropout: LeanDcMessage's loads and the
// edge's keep word (row e, the CSR position), and dlog_e = ct[i] * h[s] *
// factor * dmask_e. float32 tables only. Bound as LeanDcMessage, plus the
// keep's E x K*F bytes in CSR order.
struct LeanDcKeepMessage : LeanDcMessage<Form<float, float, false>> {
  using Base = LeanDcMessage<Form<float, float, false>>;
  static constexpr bool kKeyed = true;
  struct Edge {
    Base::Edge tables;
    uint32_t keep;
  };
  KeepRows keep;

  __device__ Edge load(int64_t r, int64_t e, int cv, const Slot& s) const {
    return {Base::load(r, cv, s), keep.load(e, cv, n_vec)};
  }
  __device__ static Edge none() { return {Base::none(), 0u}; }
  __device__ static float term(float acc, float c, float ct, float p, float d, float h,
                               float k) {
    float m, dm;
    mask_chain(c + d, p, m, dm);
    return k != 0.f ? acc + ct * h * k * dm : acc;
  }
  __device__ void add(float4 (&acc)[1], const Edge& e, const Slot& s) const {
    const float4 d = e.tables.d;
    const float4 h = e.tables.h;
    acc[0].x = term(acc[0].x, s.c.x, s.ct.x, s.p.x, d.x, h.x, keep.factor(e.keep, 0));
    acc[0].y = term(acc[0].y, s.c.y, s.ct.y, s.p.y, d.y, h.y, keep.factor(e.keep, 1));
    acc[0].z = term(acc[0].z, s.c.z, s.ct.z, s.p.z, d.z, h.z, keep.factor(e.keep, 2));
    acc[0].w = term(acc[0].w, s.c.w, s.ct.w, s.p.w, d.w, h.w, keep.factor(e.keep, 3));
  }
};

// The K-fold of one round's slots v[t] of a K*F row (slot cv = (t0 + t)
// lpe + li of the lane's group, 0 past the row) into q[0 .. f_vec): q[j]
// adds the slots j, j + f_vec, ... Every lane of the warp calls it; the
// lanes `on` store, with streaming 16-byte stores.
//   - butterfly (lpe % f_vec == 0, the main path's K*F = 128, F = 64): every
//     slot of a lane is its feature li mod f_vec, so the lane adds its
//     slots, then the group adds across lanes f_vec apart by shuffles, and
//     lanes li < f_vec store;
//   - otherwise (F = 12, 96, ...) the group stages the round's slots in
//     shared memory and lane li adds the slots of features li, li + lpe, ...
//     in k order.
// Where a row takes several rounds (K*F > 256: TILES = 2 slots a lane a
// round), a round adds its part of the fold to what the earlier rounds
// stored: the same lane owns the same feature of the same row in every
// round, so it reads back its own store.
__device__ __forceinline__ void store_fold(float4* q, float4 v, bool later_round) {
  if (later_round) {
    const float4 before = *q;
    v = make_float4(before.x + v.x, before.y + v.y, before.z + v.z, before.w + v.w);
  }
  __stcs(q, v);
}

template <int TILES>
__device__ __forceinline__ void fold_k(const float4 (&v)[TILES], float4* q, bool on, int t0,
                                       int lpe, int li, int f_vec, bool butterfly) {
  __shared__ float4 stage[kSumWarps][kWarp * TILES];  // the round's slots, per group
  if (butterfly) {
    float4 fold = Vec<4>::zero();
#pragma unroll
    for (int t = 0; t < TILES; ++t) Vec<4>::add(fold, v[t]);
    for (int off = f_vec; off < lpe; off <<= 1) Vec<4>::add(fold, Vec<4>::shfl_xor(fold, off));
    if (on && li < f_vec) store_fold(q + li, fold, t0 > 0);
    return;
  }
  float4* grp = stage[threadIdx.x / kWarp] + (threadIdx.x % kWarp - li) * TILES;
#pragma unroll
  for (int t = 0; t < TILES; ++t) grp[t * lpe + li] = v[t];
  __syncwarp();
  if (on) {
    for (int j = li; j < f_vec; j += lpe) {
      float4 sum = Vec<4>::zero();
      for (int k = j - t0 * lpe; k < TILES * lpe; k += f_vec) {
        if (k >= 0) Vec<4>::add(sum, grp[k]);
      }
      store_fold(q + j, sum, t0 > 0);
    }
  }
  __syncwarp();  // the stage is read before the next call overwrites it
}

// Kernel 10's dst pass with its per-edge payload: LeanDcMessage's sums
// into dc (the same bits), and at each covered edge's CSR position e the
// payload row [dlog_e || fold_K(ct[i] * mask_e)] of n_vec + f_vec slots,
// written by the edge's lane group with streaming 16-byte stores from the
// loads the sums already made (the K-fold by fold_k). Positions the CSR
// does not cover get zero rows from the chunk that holds them
// (zero_uncovered). E: the element type of d and h (kernel 10's forms,
// Form<E, E, false>).
template <typename E>
struct LeanDcPayloadMessage : LeanDcMessage<Form<E, E, false>> {
  using Base = LeanDcMessage<Form<E, E, false>>;
  using typename Base::Edge;
  using typename Base::Slot;
  using Base::f_vec;
  using Base::n_vec;
  static constexpr bool kEmits = true;
  // 80 registers (3 blocks an SM) and LeanDcMessage's two edges in flight:
  // on the card, 2 or 4 blocks an SM and four edges in flight all came
  // within 5% of it, since the payload's stores, not the gathers' latency,
  // set the time. A different in_flight would also change which rows a
  // narrow K*F sums by group, and so dc's bits against the pass without
  // the payload.
  static constexpr int kMinBlocks = 3;
  float4* payload;    // (n_edges, n_vec + f_vec) slots
  int64_t n_edges;
  bool butterfly;     // lpe % f_vec == 0

  // Zero payload rows for the positions of [a, b) outside [lo, hi).
  __device__ void zero_uncovered(int64_t a, int64_t b, int64_t lo, int64_t hi) const {
    const int64_t width = n_vec + f_vec;
    const int64_t end = b < n_edges ? b : n_edges;
    const int64_t from[2] = {a, a > hi ? a : hi};
    const int64_t to[2] = {end < lo ? end : lo, end};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      for (int64_t i = from[k] * width + threadIdx.x % kWarp; i < to[k] * width; i += kWarp) {
        __stcs(payload + i, Vec<4>::zero());
      }
    }
  }

  // One slot's lanes: dl = dlog_e, gm = ct[i] * mask_e, and acc as
  // LeanDcMessage adds. dl and gm take rounded products that the compiler
  // may not share with term's expression or fuse: term then compiles as
  // it does alone, and dc has the same bits with or without the payload.
  __device__ static void terms(float& acc, float& dl, float& gm, float c, float ct, float p,
                               float d, float h) {
    acc = Base::term(acc, c, ct, p, d, h);
    float m, dm;
    mask_chain(c + d, p, m, dm);
    dl = __fmul_rn(__fmul_rn(ct, h), dm);
    gm = __fmul_rn(ct, m);
  }

  template <int TILES>
  __device__ void emit(float4 (&acc)[TILES][1], const Edge (&ed)[TILES], const Slot (&sl)[TILES],
                       int64_t e, int t0, int lpe, int li) const {
    float4* prow = payload + (e < 0 ? 0 : e) * (n_vec + f_vec);
    float4 gm[TILES];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      float4 dl;
      const float4 d = Base::DS::widen(ed[t].d);
      const float4 h = Base::HS::widen(ed[t].h);
      terms(acc[t][0].x, dl.x, gm[t].x, sl[t].c.x, sl[t].ct.x, sl[t].p.x, d.x, h.x);
      terms(acc[t][0].y, dl.y, gm[t].y, sl[t].c.y, sl[t].ct.y, sl[t].p.y, d.y, h.y);
      terms(acc[t][0].z, dl.z, gm[t].z, sl[t].c.z, sl[t].ct.z, sl[t].p.z, d.z, h.z);
      terms(acc[t][0].w, dl.w, gm[t].w, sl[t].c.w, sl[t].ct.w, sl[t].p.w, d.w, h.w);
      const int cv = (t0 + t) * lpe + li;
      if (e >= 0 && cv < n_vec) __stcs(prow + cv, dl);
    }
    fold_k<TILES>(gm, prow + n_vec, e >= 0, t0, lpe, li, f_vec, butterfly);
  }
};

// The src pass's message: on slots of 4 lanes of a K*F row, dlog_e into the
// row's dD block and gm_e into its G block, in the form Fm (Form), rounded as
// LeanDcMessage rounds.
template <class Fm>
struct LeanSrcMessage {
  static constexpr int VEC = 4;
  static constexpr int kSums = 2;
  static constexpr bool kEmits = false;
  static constexpr bool kFolds = false;
  static constexpr bool kKeyed = false;
  static constexpr int kMinBlocks = 3;  // blocks an SM: 80 registers
  template <int TILES>
  __host__ __device__ static constexpr int in_flight() {
    return 2;
  }
  using HS = Slots<4, typename Fm::H>;
  using DS = Slots<4, typename Fm::D>;
  using RoundAs = typename std::conditional<Fm::kRound, bf16, float>::type;
  struct Slot {
    float4 d, h, p;  // d[row], tile(h[row], K) and the pattern on the slot's 4 lanes
  };
  struct Edge {
    float4 c, ct;
  };
  const float4* c;
  const float4* ct;
  const float4* pat;
  const typename DS::Raw* d;
  const typename HS::Raw* h;
  int n_vec, f_vec;

  __device__ Slot slot(int64_t row, int cv) const {
    return {DS::widen(DS::load(d + row * n_vec + cv)),
            HS::widen(HS::load(h + row * f_vec + cv % f_vec)), __ldg(pat + cv)};
  }
  __device__ static Slot no_slot() { return {Vec<4>::zero(), Vec<4>::zero(), Vec<4>::zero()}; }
  __device__ Edge load(int64_t r, int cv, const Slot&) const {
    return {__ldg(c + r * n_vec + cv), operand4<RoundAs>(__ldg(ct + r * n_vec + cv))};
  }
  __device__ static Edge none() { return {Vec<4>::zero(), Vec<4>::zero()}; }
  __device__ static void term(float& dd, float& g, float c, float ct, float p, float d,
                              float h) {
    float m, dm;
    mask_chain(c + d, p, m, dm);
    if constexpr (!Fm::kRound) {
      dd += ct * h * dm;
    } else {
      dd += round_bf16(__fmul_rn(__fmul_rn(ct, h), dm));
    }
    g += ct * m;
  }
  __device__ static void add(float4 (&acc)[2], const Edge& e, const Slot& s) {
    term(acc[0].x, acc[1].x, e.c.x, e.ct.x, s.p.x, s.d.x, s.h.x);
    term(acc[0].y, acc[1].y, e.c.y, e.ct.y, s.p.y, s.d.y, s.h.y);
    term(acc[0].z, acc[1].z, e.c.z, e.ct.z, s.p.z, s.d.z, s.h.z);
    term(acc[0].w, acc[1].w, e.c.w, e.ct.w, s.p.w, s.d.w, s.h.w);
  }
};

// Kernel 3's src pass with mask dropout: over the CSC, LeanSrcMessage's c
// and ct gathers and the keep word of row perm[j] (the CSR edge of CSC
// position j); dlog_e = ct[i] * h[s] * factor * dmask_e into dD and
// ct[i] * (mask_e * factor) into G. float32 tables only. Bound as
// LeanSrcMessage, plus the keep's E x K*F bytes, gathered a row an edge
// through perm (each row one 128-byte line at K*F = 128).
struct LeanSrcKeepMessage : LeanSrcMessage<Form<float, float, false>> {
  using Base = LeanSrcMessage<Form<float, float, false>>;
  static constexpr bool kKeyed = true;
  struct Edge {
    float4 c, ct;
    uint32_t keep;
  };
  KeepRows keep;

  __device__ Edge load(int64_t r, int64_t e, int cv, const Slot&) const {
    return {__ldg(c + r * n_vec + cv), __ldg(ct + r * n_vec + cv), keep.load(e, cv, n_vec)};
  }
  __device__ static Edge none() { return {Vec<4>::zero(), Vec<4>::zero(), 0u}; }
  __device__ static void term(float& dd, float& g, float c, float ct, float p, float d, float h,
                              float k) {
    float m, dm;
    mask_chain(c + d, p, m, dm);
    if (k != 0.f) {
      dd += ct * h * k * dm;
      g += ct * (m * k);
    }
  }
  __device__ void add(float4 (&acc)[2], const Edge& e, const Slot& s) const {
    term(acc[0].x, acc[1].x, e.c.x, e.ct.x, s.p.x, s.d.x, s.h.x, keep.factor(e.keep, 0));
    term(acc[0].y, acc[1].y, e.c.y, e.ct.y, s.p.y, s.d.y, s.h.y, keep.factor(e.keep, 1));
    term(acc[0].z, acc[1].z, e.c.z, e.ct.z, s.p.z, s.d.z, s.h.z, keep.factor(e.keep, 2));
    term(acc[0].w, acc[1].w, e.c.w, e.ct.w, s.p.w, s.d.w, s.h.w, keep.factor(e.keep, 3));
  }
};

// Kernel 11's src pass: LeanSrcMessage's loads and sums over the caller's
// d, with the G block folded over the K aggregator blocks as it is stored
// (kFolds): an output row, and a head or tail partial, is [dd || fold_K(G)],
// n_vec + f_vec slots. The fold is linear, so kernel 1's fixup adds folded
// partials as they are. E: the element type of d and h (kernel 11's forms,
// Form<E, E, false>).
template <typename E>
struct LeanSrcFoldMessage : LeanSrcMessage<Form<E, E, false>> {
  using Base = LeanSrcMessage<Form<E, E, false>>;
  using Base::f_vec;
  using Base::n_vec;
  static constexpr bool kFolds = true;
  // 64 registers (4 blocks an SM), with spills, and LeanSrcMessage's two
  // edges in flight: on the card 2 and 3 blocks an SM were 17-18% slower at
  // the synthetic-large graph, and four edges in flight slower at 2, 3 and
  // 4 blocks. 32 warps an SM hide the c and ct gathers' latency better than
  // fewer spills do.
  static constexpr int kMinBlocks = 4;
  bool butterfly;  // lpe % f_vec == 0

  // The round's slots of a row at dst: dd on the lane's own slots, the G
  // slots through fold_k. Every lane of the warp calls it; `on` for the
  // lanes whose group holds the row.
  template <int TILES>
  __device__ void store(const float4 (&acc)[TILES][2], float4* dst, bool on, int t0, int lpe,
                        int li) const {
    float4 g[TILES];
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int cv = (t0 + t) * lpe + li;
      if (on && cv < n_vec) dst[cv] = acc[t][0];
      g[t] = acc[t][1];  // 0 past the row
    }
    fold_k<TILES>(g, dst + n_vec, on, t0, lpe, li, f_vec, butterfly);
  }
};

// Pass 1 of the dst pass (Msg = LeanDcMessage<Fm>; kernel 10 with the
// caller's d, and with its payload LeanDcPayloadMessage<E>) and of the src
// pass (LeanSrcMessage<Fm>; kernel 11 with the caller's d,
// LeanSrcFoldMessage<E>), each at its message's launch bounds.
template <class Msg, int TILES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kSumWarps* kWarp, MIN_BLOCKS)
lean_bwd_edge_kernel(const Msg msg, const int32_t* __restrict__ ptr,
                     const int32_t* __restrict__ index, float* __restrict__ out,
                     float* __restrict__ part, int32_t* __restrict__ tail_row, int n_rows,
                     int n_vec, int lpe, int tiles, int chunk, int n_chunks) {
  chunk_pass<Msg, TILES>(msg, ptr, index, out, part, tail_row, n_rows, n_vec, lpe, tiles, chunk,
                         n_chunks);
}

// Both passes of a dst or src pass over n_edges edge positions of the CSR
// (or CSC) ptr, reading the other endpoint through index; out holds
// out_slots(msg, kf / 4) 16-byte slots a row, part as many a slot.
template <class Msg>
cudaError_t launch_lean_bwd_edges(const Msg& msg, const void* ptr, const void* index, void* out,
                                  void* part, void* tail_row, int n_rows, int kf, int n_edges,
                                  cudaStream_t s) {
  const int n_vec = kf / 4;
  const int lpe = lanes_per_edge(n_vec);
  const int tiles = (n_vec + lpe - 1) / lpe;
  const int chunk = sum_chunk_edges(n_edges);
  const int n_chunks = sum_n_chunks(n_edges);
  const int blocks = (n_chunks + kSumWarps - 1) / kSumWarps;
  auto launch = [&](auto t) {
    lean_bwd_edge_kernel<Msg, decltype(t)::value, Msg::kMinBlocks>
        <<<blocks, kSumWarps * kWarp, 0, s>>>(
            msg, static_cast<const int32_t*>(ptr), static_cast<const int32_t*>(index),
            static_cast<float*>(out), static_cast<float*>(part),
            static_cast<int32_t*>(tail_row), n_rows, n_vec, lpe, tiles, chunk, n_chunks);
  };
  if (tiles <= 1) {
    launch(std::integral_constant<int, 1>());
  } else {
    launch(std::integral_constant<int, 2>());  // two slots a lane, several rounds past 256 lanes
  }
  return launch_fixup<4>(ptr, part, tail_row, out, n_rows, out_slots(msg, n_vec), chunk,
                         n_chunks, s);
}

// The node pass. lean_dh_kernel: a thread owns kDhRowsPerThread rows and
// the features lq + LPR j (j < 4) of dh, LPR lanes a row (4 LPR >= F),
// kWarp / LPR row groups a warp; a step stages, for the block's rows,
// kDhSlice lanes of K*F of dD and the same lanes of G, and those lanes of
// W_bot for 4 LPR features (rows padded to kDhSliceP floats, so that the
// lanes of a row group read W_bot's rows without bank conflicts).
constexpr int kDhSlice = 32;
constexpr int kDhSliceP = kDhSlice + 4;
constexpr int kDhRowsPerThread = 8;

template <int LPR>
__host__ __device__ constexpr int dh_rows() {  // node rows of a block step
  return kNodeWarps * (kWarp / LPR) * kDhRowsPerThread;
}

template <int LPR>
__host__ __device__ constexpr int dh_tile_floats() {  // a stage buffer: dD, G and W_bot slices
  return 2 * dh_rows<LPR>() * kDhSlice + 4 * LPR * kDhSliceP;
}

// dh = fold_K(G) + dD @ W_bot^T from ddg (n_rows, 2 kf) = [dD || G].
// Grid: persistent over blocks of dh_rows<LPR>() rows; each block walks
// its row blocks slice by slice, staging the next (block, slice) while it
// multiplies the current one and adds the current G lanes that fall on
// its features.
template <int LPR>
__global__ void __launch_bounds__(kNodeWarps* kWarp)
lean_dh_kernel(const float* __restrict__ ddg, const float* __restrict__ w_bot,
               float* __restrict__ dh, int n_rows, int f, int kf) {
  constexpr int kGroups = kWarp / LPR;
  constexpr int kRows = dh_rows<LPR>();
  constexpr int kTile = dh_tile_floats<LPR>();
  constexpr int kRowStep = kNodeWarps * kGroups;  // between a thread's rows
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int lq = lane % LPR;
  const int r0 = warp * kGroups + lane / LPR;  // rows r0 + kRowStep i of the block
  const int n_slices = (kf + kDhSlice - 1) / kDhSlice;
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  const int64_t stride = 2 * static_cast<int64_t>(kf);  // a [dD || G] row
  // This block's k-th step: row block blockIdx.x + (k / n_slices) gridDim.x,
  // slice k mod n_slices.
  auto block_of = [&](int k) { return static_cast<int>(blockIdx.x + (k / n_slices) * gridDim.x); };

  auto stage = [&](int k, int buf) {
    float* dds = smem + buf * kTile;     // [2][kRows][kDhSlice]: dD, then G
    float* ws = dds + 2 * kRows * kDhSlice;  // [4 LPR][kDhSliceP]
    const int64_t first = static_cast<int64_t>(block_of(k)) * kRows;
    const int l0 = (k % n_slices) * kDhSlice;
    constexpr int kQ = kDhSlice / 4;
    for (int i = threadIdx.x; i < 2 * kRows * kQ; i += blockDim.x) {
      const int r = (i / kQ) % kRows, l = l0 + 4 * (i % kQ);
      const int half = i / (kRows * kQ);  // 0: dD, 1: G (kf lanes further on)
      const bool in = first + r < n_rows && l < kf;
      cp_async16(dds + (half * kRows + r) * kDhSlice + (l - l0),
                 in ? ddg + (first + r) * stride + half * kf + l : ddg, in);
    }
    for (int i = threadIdx.x; i < 4 * LPR * kQ; i += blockDim.x) {
      const int r = i / kQ, l = l0 + 4 * (i % kQ);
      const bool in = r < f && l < kf;
      cp_async16(ws + r * kDhSliceP + (l - l0),
                 in ? w_bot + static_cast<int64_t>(r) * kf + l : w_bot, in);
    }
    cp_async_commit();
  };

  if (block_of(0) < n_blocks) stage(0, 0);
  float acc[kDhRowsPerThread][4] = {};
  for (int k = 0, buf = 0; block_of(k) < n_blocks; ++k, buf ^= 1) {
    if (block_of(k + 1) < n_blocks) {
      stage(k + 1, buf ^ 1);  // in flight below
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // step k's slices are in shared memory
    const float* dds = smem + buf * kTile;
    const float* gs = dds + kRows * kDhSlice;
    const float* ws = gs + kRows * kDhSlice;
#pragma unroll 2
    for (int l = 0; l < kDhSlice; l += 4) {
      float4 w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[j] = *reinterpret_cast<const float4*>(ws + (lq + LPR * j) * kDhSliceP + l);
      }
#pragma unroll
      for (int i = 0; i < kDhRowsPerThread; ++i) {
        // The lanes of a row group read the same dD row: a broadcast.
        const float4 x =
            *reinterpret_cast<const float4*>(dds + (r0 + kRowStep * i) * kDhSlice + l);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(x.x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(x.y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(x.z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(x.w, w[j].w, acc[i][j]);
        }
      }
    }
    // fold_K(G): the slice's G lanes l0 + d with (l0 + d) mod f on a feature.
    const int l0 = (k % n_slices) * kDhSlice;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ff = lq + LPR * j;
      if (ff >= f) continue;
      for (int d = ((ff - l0) % f + f) % f; d < kDhSlice; d += f) {
#pragma unroll
        for (int i = 0; i < kDhRowsPerThread; ++i) {
          acc[i][j] += gs[(r0 + kRowStep * i) * kDhSlice + d];
        }
      }
    }
    if (k % n_slices == n_slices - 1) {  // the row block's last slice: store
#pragma unroll
      for (int i = 0; i < kDhRowsPerThread; ++i) {
        const int64_t row = static_cast<int64_t>(block_of(k)) * kRows + r0 + kRowStep * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ff = lq + LPR * j;
          if (row < n_rows && ff < f) dh[row * f + ff] = acc[i][j];
          acc[i][j] = 0.f;
        }
      }
    }
    __syncthreads();  // this buffer is read before the next step restages it
  }
}

// lean_dw_kernel: block (slab, lane tile) adds h[n]^T dD[n] over the
// slab's rows n, in order, kDwRows at a time; warp w owns the features
// RF w .. RF w + RF - 1 (8 RF >= F), a thread 4 lanes of the 128-lane
// tile. The slab partials (n_slabs, F, K*F) stay near kDwPartialFloats.
constexpr int kDwRows = 32;
constexpr int64_t kDwPartialFloats = 1 << 20;
constexpr int kDwMinSlabs = 16;
constexpr int kDwMaxSlabs = 128;

int dw_slab_rows(int n_rows, int f, int kf) {
  int64_t slabs = kDwPartialFloats / (static_cast<int64_t>(f) * kf);
  slabs = slabs < kDwMinSlabs ? kDwMinSlabs : (slabs > kDwMaxSlabs ? kDwMaxSlabs : slabs);
  const int64_t per = (n_rows + slabs - 1) / slabs;
  const int64_t steps = (per + kDwRows - 1) / kDwRows;
  return static_cast<int>((steps > 0 ? steps : 1) * kDwRows);
}

int dw_n_slabs(int n_rows, int f, int kf) {
  const int rows = dw_slab_rows(n_rows, f, kf);
  return max(1, (n_rows + rows - 1) / rows);
}

// The h tile ([kDwRows][f] of h's type E) is padded past its last row by 8
// RF values: a warp whose features run past F reads them (and drops what it
// sums). The dD tile ([kDwRows][kLaneTile] f32) follows, 16-byte aligned.
__host__ __device__ inline size_t dw_h_bytes(int f, int rf, size_t h_elem) {
  return (static_cast<size_t>(kDwRows) * f + 8 * rf) * h_elem;
}

__host__ __device__ inline size_t dw_tile_bytes(int f, int rf, size_t h_elem) {
  return dw_h_bytes(f, rf, h_elem) + sizeof(float) * kDwRows * kLaneTile;
}

template <int RF, typename E>
__global__ void __launch_bounds__(kNodeWarps* kWarp)
lean_dw_kernel(const float* __restrict__ ddg, const E* __restrict__ h,
               float* __restrict__ part, int n_rows, int f, int kf, int slab_rows) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const size_t tile = dw_tile_bytes(f, RF, sizeof(E));
  const size_t h_bytes = dw_h_bytes(f, RF, sizeof(E));
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int l_base = blockIdx.y * kLaneTile;
  const int row_begin = blockIdx.x * slab_rows;
  const int row_end = min(n_rows, row_begin + slab_rows);
  const int n_steps = (row_end - row_begin + kDwRows - 1) / kDwRows;
  const int64_t stride = 2 * static_cast<int64_t>(kf);  // a [dD || G] row

  auto stage = [&](int st, int buf) {
    E* hs = reinterpret_cast<E*>(smem + buf * tile);            // [kDwRows][f] + padding
    float* ds = reinterpret_cast<float*>(smem + buf * tile + h_bytes);  // [kDwRows][kLaneTile]
    const int first = row_begin + st * kDwRows;
    stage_rows(hs, h, first, kDwRows, row_end, f * static_cast<int>(sizeof(E)));
    for (int i = threadIdx.x; i < kDwRows * (kLaneTile / 4); i += blockDim.x) {
      const int r = i / (kLaneTile / 4), l = l_base + 4 * (i % (kLaneTile / 4));
      const bool in = first + r < row_end && l < kf;
      cp_async16(ds + r * kLaneTile + (l - l_base),
                 in ? ddg + static_cast<int64_t>(first + r) * stride + l : ddg, in);
    }
    cp_async_commit();
  };

  float acc[RF][4] = {};
  if (n_steps > 0) stage(0, 0);
  for (int st = 0, buf = 0; st < n_steps; ++st, buf ^= 1) {
    if (st + 1 < n_steps) {
      stage(st + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const E* hs = reinterpret_cast<const E*>(smem + buf * tile) + RF * warp;
    const float4* d4 = reinterpret_cast<const float4*>(smem + buf * tile + h_bytes) + lane;
#pragma unroll 2
    for (int n = 0; n < kDwRows; ++n) {
      const float4 dv = d4[n * (kLaneTile / 4)];
#pragma unroll
      for (int r4 = 0; r4 < RF; r4 += 4) {
        // Every lane of the warp reads the same h features: a broadcast.
        const float4 hv = smem_lanes4(hs + n * f + r4);
        const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[r4 + q][0] = fmaf(hr[q], dv.x, acc[r4 + q][0]);
          acc[r4 + q][1] = fmaf(hr[q], dv.y, acc[r4 + q][1]);
          acc[r4 + q][2] = fmaf(hr[q], dv.z, acc[r4 + q][2]);
          acc[r4 + q][3] = fmaf(hr[q], dv.w, acc[r4 + q][3]);
        }
      }
    }
    __syncthreads();  // this buffer is read before the next step restages it
  }
  const int l0 = l_base + 4 * lane;
  if (l0 < kf) {  // kf % 4 == 0, so all 4 lanes or none
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int ff = RF * warp + r;
      if (ff < f) {
        *reinterpret_cast<float4*>(part + (static_cast<int64_t>(blockIdx.x) * f + ff) * kf + l0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
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

// Sets a kernel's dynamic shared memory and gives the blocks of
// kNodeWarps warps that the card holds at once (at least 1).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kNodeWarps * kWarp, smem);
  *blocks = max(1, n_sm * per_sm);
  return err;
}

template <int LPR>
cudaError_t launch_dh(const float* ddg, const float* w_bot, float* dh, int n_rows, int f,
                      int kf, cudaStream_t s) {
  const size_t smem = sizeof(float) * dh_tile_floats<LPR>() * 2;
  int resident = 0;
  cudaError_t err = resident_blocks(lean_dh_kernel<LPR>, smem, &resident);
  if (err != cudaSuccess) return err;
  const int row_blocks = (n_rows + dh_rows<LPR>() - 1) / dh_rows<LPR>();
  lean_dh_kernel<LPR><<<min(row_blocks, resident), kNodeWarps * kWarp, smem, s>>>(
      ddg, w_bot, dh, n_rows, f, kf);
  return cudaGetLastError();
}

template <int RF, typename E>
cudaError_t launch_dw(const float* ddg, const E* h, float* part, int n_rows, int f, int kf,
                      cudaStream_t s) {
  const size_t smem = dw_tile_bytes(f, RF, sizeof(E)) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      lean_dw_kernel<RF, E>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(dw_n_slabs(n_rows, f, kf), (kf + kLaneTile - 1) / kLaneTile);
  lean_dw_kernel<RF, E><<<grid, kNodeWarps * kWarp, smem, s>>>(ddg, h, part, n_rows, f, kf,
                                                               dw_slab_rows(n_rows, f, kf));
  return cudaGetLastError();
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
//
// bf16 data (E = bf16): each value is widened to f32 as it is loaded and
// both sums stay f32. The square of a bf16 value is exact in f32, and the
// JAX kernel's one-pass contraction on bf16 data (precision "fastest")
// then rounds it to bf16 before it is summed (_contract at
// mma_tpu/ops/pallas/fused_mma.py:108-119): so does this kernel.
// ---------------------------------------------------------------------------

template <typename E>
__global__ void segment_sum_sq_kernel(const E* __restrict__ data,
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
      const float x = Slots<1, E>::widen(Slots<1, E>::load(
          reinterpret_cast<const typename Slots<1, E>::Raw*>(data + e * n_chan + ch)));
      s1 = __fadd_rn(s1, x);
      s2 = __fadd_rn(s2, operand<E>(__fmul_rn(x, x)));
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
//              (E, K*F+F) at the edge's CSR position, 0 for positions outside
//              [row_ptr[0], row_ptr[n]);
//   kernel 11: out[s] = [sum_{e: src=s} dlog_e || sum_{e: src=s} sum_k (ct[i] * mask_e)_k]
//              over the CSC, i = dst_csc[e].
//
// Bound on this card: bytes. Each input read once and each output written
// once is small for kernels 9 and 11 and for kernel 10 without the payload
// (0.07-0.1 ms at the synthetic-large graph); kernel 10's payload, E x (K*F
// + F) x 4 B = 1.61 GB at F = 64, K = 2, is written once: 0.48 ms at 3.35
// TB/s. What sets the time is the random node rows gathered per edge, E x
// 768 B (d and h by src; kernel 11: c and ct by dst, E x 1,024 B), less
// what the 50 MB L2 keeps of the tables.
//
// Kernels 9 and 10 are the edge-balanced chunk pass of kernels 1-3, with
// the caller's d in place of kernel 2's D = h @ W_bot: kernel 9 is kernel
// 2's edge pass (lean_edge_kernel with LeanMessage, then kernel 1's fixup),
// kernel 10 kernel 3's dst pass (lean_bwd_edge_kernel<LeanDcMessage>, then
// the fixup), and with the payload the same pass with
// LeanDcPayloadMessage, which writes each edge's payload row in the pass
// that already gathers d[s] and h[s]. So skew, determinism and the empty
// rows are kernel 1's: chunks fixed by E, long rows split and joined in
// chunk order, every output row and payload row written once, no atomics,
// no host sync.
//
// Kernel 11 is kernel 3's src pass over the caller's d, and writes its
// [dd || dh] row as it stores: lean_bwd_edge_kernel<LeanSrcFoldMessage>,
// then kernel 1's fixup. The chunk pass runs over the CSC, gathering
// c[i] and ct[i] through dst_csc per edge, with d[s], tile(h[s], K) and the
// pattern loaded once per row segment; a slot keeps dd and G = sum ct[i] *
// mask_e, and G's K blocks are folded as the row (or a chunk's partial) is
// stored, so rows and partials are K*F + F wide, not 2 K*F. The power-law
// graph's heaviest source (1,448 edges) is split over chunks and joined
// by the fixup in chunk order, as the other passes' heavy rows are.
//
// bf16 d and h (the form Form<bf16, bf16, false>: LeanMessage,
// LeanDcMessage, LeanDcPayloadMessage<bf16>, LeanSrcFoldMessage<bf16>): the
// tables are read as bf16, 8 bytes a slot, and widened to f32 in
// registers; c, ct, the payload, dc and [dd || dh] stay f32, and no term is
// rounded. The JAX wide kernels contract in two bf16 passes whatever the
// dtype (mma_tpu/ops/pallas/fused_mma.py:1380), f32 to about 2^-17, and
// round dc, dd and dh once to their inputs' dtypes at the end (:1449),
// which the Python wrapper does. At the synthetic-large graph a gathered
// [d || h] row drops from 768 to 384 B, and the d and h tables from 100.7
// to 50.3 MB, about the 50 MB L2.
// ---------------------------------------------------------------------------

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
// (1.6 GFLOP, 0.024 ms at the f32 rate). bf16 logits and h_src halve the
// edge rows (0.81 GB, a bound of about 0.26 ms).
//
// Design: kernel 1's edge-balanced two passes (chunk_pass, then
// segment_sum_fixup_kernel) with MaskedMessage, as kernels 2, 3 and 9-11
// run them. A warp per destination row made the power-law graph's heaviest
// row (1,448 edges, 1.1 MB in f32) one warp's sequential loop, which set
// most of the call's time (0.588 of 0.903 ms in f32, 0.663 of 0.862 in
// bf16). Here edge positions go in chunks sized from E alone, one warp
// each; a row of at most max(chunk, 64) edges is summed whole by the chunk
// it starts in, a longer one split at chunk boundaries into head and tail
// partials that the fixup adds in chunk order, and the fixup's zeroing
// warps write the empty rows. Edge position e reads its own logits and
// h_src rows (no index): the loads stream, coalesced. A lane's slot is 4
// lanes of the K*F row (16-byte f32 or 8-byte bf16 loads, F % 4 == 0 and
// aligned rows) or one lane (VEC = 1); the slot loads the pattern's lanes
// once per row segment and reads h_src's slot cv mod F/VEC.
//
// The scalar path takes the vector path's lanes per edge (lanes_per_edge
// of K*F / 4 slots) and edges in flight (set by the lanes a round covers,
// not by VEC), so its groups, chunks and butterflies sum each output lane
// in the same order: rows off their 4-lane alignment give the same bits.
//
// Launch bounds and edges in flight: MMA_MASKED_MIN_BLOCKS blocks an SM
// (4: 64 registers, 32 warps) and MMA_MASKED_EDGES edges in flight a lane
// while a round covers at most 4 lanes (2; half past that, twice for bf16
// logits and h_src), chosen on the card over 2 and 3 blocks an SM and over
// 1 and 4 edges (PERF.md §6): at 64 registers some instances spill a few
// hundred bytes, but fewer warps an SM cost more (5-48% slower). They are
// compile-time so that scripts/torch_redesign_compare.py can build and time
// other settings beside these.
//
// Every row is written once, with no atomics and no host sync: bitwise
// equal run to run, and a call replays in a CUDA graph. The summation
// order is the chunk pass's, not a warp's walk in edge order: within 1e-5
// of the plain version's index_add_.
//
// bf16 logits and/or h_src (MaskedMessage<VEC, EL, EH>, each operand's
// type on its own) are widened to f32 in registers; the mask and the
// message are computed in f32. With bf16 logits the message is rounded to
// bf16 before it is added, whatever h_src's type: the JAX wrapper keys its
// one pass on the logits' dtype (mma_tpu/ops/pallas/fused_mma.py:1574) and
// its contraction rounds the f32 message (:108-119). With f32 logits the
// sum is an fmaf. The output and the partials stay f32.
// ---------------------------------------------------------------------------

#ifndef MMA_MASKED_MIN_BLOCKS
#define MMA_MASKED_MIN_BLOCKS 4
#endif
#ifndef MMA_MASKED_EDGES
#define MMA_MASKED_EDGES 2
#endif

constexpr int kMaxKF = 512;

template <int VEC_, typename EL, typename EH>
struct MaskedMessage {
  static constexpr int VEC = VEC_;
  static constexpr int kSums = 1;
  static constexpr bool kEmits = false;
  static constexpr bool kFolds = false;
  static constexpr bool kKeyed = false;
  static constexpr int kMinBlocks = MMA_MASKED_MIN_BLOCKS;
  // The same for VEC = 4 at TILES and VEC = 1 at 4 TILES (see above).
  template <int TILES>
  __host__ __device__ static constexpr int in_flight() {
    return (TILES * VEC <= 4 ? MMA_MASKED_EDGES : (MMA_MASKED_EDGES + 1) / 2) *
           (sizeof(EL) == 2 && sizeof(EH) == 2 ? 2 : 1);
  }
  using V = Vec<VEC>;
  using T = typename V::T;
  using LS = Slots<VEC, EL>;
  using HS = Slots<VEC, EH>;
  struct Slot {
    T p;     // the pattern on the slot's lanes
    int hv;  // the slot of h_src that the lanes read: cv mod F/VEC
  };
  struct Edge {
    typename LS::Raw l;
    typename HS::Raw h;
  };
  const typename LS::Raw* logits;
  const typename HS::Raw* h;
  const T* pat;
  int n_vec, f_vec;  // slots of a K*F row (logits) and of an F row (h_src)

  __device__ Slot slot(int64_t, int cv) const { return {__ldg(pat + cv), cv % f_vec}; }
  __device__ static Slot no_slot() { return {V::zero(), 0}; }
  __device__ Edge load(int64_t r, int cv, const Slot& s) const {
    return {LS::load(logits + r * n_vec + cv), HS::load(h + r * f_vec + s.hv)};
  }
  __device__ static Edge none() { return {LS::zero(), HS::zero()}; }
  __device__ static float term(float acc, float p, float x, float hx) {
    const float m = p != 0.f ? sigmoidf(x) : x;
    if constexpr (std::is_same<EL, float>::value) {
      return fmaf(m, hx, acc);
    } else {  // the JAX kernel's one pass on bf16 logits
      return acc + round_bf16(__fmul_rn(m, hx));
    }
  }
  __device__ static void add(T (&acc)[1], const Edge& e, const Slot& s) {
    if constexpr (VEC == 4) {
      const float4 l = LS::widen(e.l);
      const float4 hx = HS::widen(e.h);
      acc[0].x = term(acc[0].x, s.p.x, l.x, hx.x);
      acc[0].y = term(acc[0].y, s.p.y, l.y, hx.y);
      acc[0].z = term(acc[0].z, s.p.z, l.z, hx.z);
      acc[0].w = term(acc[0].w, s.p.w, l.w, hx.w);
    } else {
      acc[0] = term(acc[0], s.p, LS::widen(e.l), HS::widen(e.h));
    }
  }
};

// Pass 1 of kernel 12, at its message's launch bounds.
template <class Msg, int TILES>
__global__ void __launch_bounds__(kSumWarps* kWarp, Msg::kMinBlocks)
masked_edge_kernel(const Msg msg, const int32_t* __restrict__ row_ptr, float* __restrict__ out,
                   float* __restrict__ part, int32_t* __restrict__ tail_row, int n_rows,
                   int n_vec, int lpe, int tiles, int chunk, int n_chunks) {
  chunk_pass<Msg, TILES>(msg, row_ptr, nullptr, out, part, tail_row, n_rows, n_vec, lpe, tiles,
                         chunk, n_chunks);
}

template <class Msg, int TILES>
cudaError_t launch_masked(const Msg& msg, const void* row_ptr, void* out, void* part,
                          void* tail_row, int n_rows, int n_vec, int lpe, int tiles, int chunk,
                          int n_chunks, cudaStream_t s) {
  const int blocks = (n_chunks + kSumWarps - 1) / kSumWarps;
  masked_edge_kernel<Msg, TILES><<<blocks, kSumWarps * kWarp, 0, s>>>(
      msg, static_cast<const int32_t*>(row_ptr), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<int32_t*>(tail_row), n_rows, n_vec, lpe, tiles,
      chunk, n_chunks);
  return launch_fixup<Msg::VEC>(row_ptr, part, tail_row, out, n_rows, n_vec, chunk, n_chunks, s);
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

// data (R, C) f32 (bf16 when data_bf16 != 0), row_ptr (n_rows+1,) i32 with
// row_ptr[n_rows] <= n_edges, index (n_edges,) i32 or null (then R =
// n_edges), out (n_rows, C) f32; scratch part (n_chunks, 2, C) f32 and
// tail_row (n_chunks,) i32. Row e of the CSR reads data[index[e]] (data[e]
// without an index). vec4 != 0 requires C % 4 == 0, 16-byte aligned out and
// part, and data aligned to 4 of its elements (16 bytes f32, 8 bf16).
int mma_segment_sum_csr(const void* data, const void* row_ptr, const void* index,
                        void* out, void* part, void* tail_row, int n_rows, int n_chan,
                        int n_edges, int vec4, int data_bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  const int n_vec = vec4 ? n_chan / 4 : n_chan;
  const int lpe = lanes_per_edge(n_vec);
  const int tiles = (n_vec + lpe - 1) / lpe;
  const int chunk = sum_chunk_edges(n_edges);
  const int n_chunks = sum_n_chunks(n_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define MMA_SUM_ARGS \
  data, row_ptr, index, out, part, tail_row, n_rows, n_vec, lpe, tiles, chunk, n_chunks, s
  auto by_width = [&](auto elem) {
    using E = typename decltype(elem)::type;
    if (vec4) {
      return tiles <= 1   ? launch_segment_sum<4, 1, E>(MMA_SUM_ARGS)
             : tiles <= 2 ? launch_segment_sum<4, 2, E>(MMA_SUM_ARGS)
             : tiles <= 3 ? launch_segment_sum<4, 3, E>(MMA_SUM_ARGS)
                          : launch_segment_sum<4, 4, E>(MMA_SUM_ARGS);
    }
    return tiles <= 1   ? launch_segment_sum<1, 1, E>(MMA_SUM_ARGS)
           : tiles <= 4 ? launch_segment_sum<1, 4, E>(MMA_SUM_ARGS)
                        : launch_segment_sum<1, 16, E>(MMA_SUM_ARGS);
  };
  err = data_bf16 ? by_width(Type<bf16>()) : by_width(Type<float>());
#undef MMA_SUM_ARGS
  return static_cast<int>(err);
}

// Kernel 2's node pass: d = h @ w_bot. h (n_rows, f) f32 (bf16 when h_bf16
// != 0), w_bot (f, kf) and d (n_rows, kf) f32. Requires f % 4 == 0, f <=
// 128, kf % 4 == 0, kf <= 512 and 16-byte aligned h and d.
int mma_edge_program_lean_node(const void* h, const void* w_bot, void* d, int n_rows, int f,
                               int kf, int h_bf16, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  auto launch = [&](auto elem) {
    using E = typename decltype(elem)::type;
    const size_t smem = node_smem_bytes(f, sizeof(E));
    // Persistent grid: as many blocks as fit on the card at once, spread
    // over the lane tiles, but no more than the row blocks need.
    int resident = 0;
    const cudaError_t err = resident_blocks(lean_node_kernel<E>, smem, &resident);
    if (err != cudaSuccess) return err;
    const int tiles = (kf + kLaneTile - 1) / kLaneTile;
    const int row_blocks = (n_rows + kNodeRows - 1) / kNodeRows;
    dim3 grid(min(row_blocks, max(1, resident / tiles)), tiles);
    lean_node_kernel<E><<<grid, kNodeWarps * kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(h), static_cast<const float*>(w_bot), static_cast<float*>(d),
        n_rows, f, kf);
    return cudaGetLastError();
  };
  return static_cast<int>(h_bf16 ? launch(Type<bf16>()) : launch(Type<float>()));
}

// Kernel 2's edge pass, and kernel 9: out[i] = sum_{e in row i} act(c[i] +
// d[src_e]) * tile(h[src_e], K). c (n_rows, kf), pat (kf,) 0/1 f32; node
// tables d (R, kf) (kernel 2: h @ w_bot; kernel 9: the caller's) and h (R,
// f), R any row count above every src; src (n_edges,) i32, row_ptr
// (n_rows+1,) i32 with row_ptr[n_rows] <= n_edges, out (n_rows, kf) f32;
// scratch part (n_chunks, 2, kf) f32 and tail_row (n_chunks,) i32, n_chunks
// = mma_segment_sum_n_chunks(n_edges). The form (by_form): h_bf16, d_bf16,
// round = 0, 0, 0 (f32 tables), 1, 0, 1 (kernel 2's bf16 h: each message
// rounded to bf16) or 1, 1, 0 (kernel 9's bf16 d and h: f32 messages).
// Unless keep is null, mask dropout (kernel 2's f32 form only): keep
// (n_edges, kf) bool bytes, row e the keep of CSR position e, and a kept
// lane's factor keep_scale. Requires f % 4 == 0, kf % f == 0, 16-byte
// aligned c, pat and out, d and h aligned to 4 of their elements and keep
// to 4 bytes.
int mma_edge_program_lean_edges(const void* c, const void* pat, const void* d, const void* h,
                                const void* src, const void* row_ptr,
                                void* out, void* part, void* tail_row, int n_rows, int f,
                                int kf, int n_edges, int h_bf16, int d_bf16, int round,
                                const void* keep, float keep_scale, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  const int n_vec = kf / 4;
  const int lpe = lanes_per_edge(n_vec);
  const int tiles = (n_vec + lpe - 1) / lpe;
  const int chunk = sum_chunk_edges(n_edges);
  const int n_chunks = sum_n_chunks(n_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto by_tiles = [&](const auto& msg) {
    using Msg = std::decay_t<decltype(msg)>;
    return tiles <= 1 ? launch_lean_edges<Msg, 1>(msg, row_ptr, src, out, part, tail_row, n_rows,
                                                  n_vec, lpe, tiles, chunk, n_chunks, s)
                      : launch_lean_edges<Msg, 2>(msg, row_ptr, src, out, part, tail_row, n_rows,
                                                  n_vec, lpe, tiles, chunk, n_chunks, s);
  };
  auto launch = [&](auto form) -> cudaError_t {
    using Fm = decltype(form);
    using Msg = LeanMessage<Fm>;
    const Msg msg{static_cast<const float4*>(c), static_cast<const float4*>(pat),
                  static_cast<const typename Msg::DS::Raw*>(d),
                  static_cast<const typename Msg::HS::Raw*>(h), n_vec, f / 4};
    if (keep == nullptr) return by_tiles(msg);
    if constexpr (std::is_same<Msg, LeanKeepMessage::Base>::value) {
      return by_tiles(LeanKeepMessage{
          msg, KeepRows{static_cast<const uint32_t*>(keep), nullptr, keep_scale}});
    } else {
      return cudaErrorInvalidValue;  // the keep is kernel 2's f32 form's alone
    }
  };
  return static_cast<int>(by_form(h_bf16, d_bf16, round, launch));
}

// The dst pass of kernels 3 and 10: dc[i] = sum_{e in row i} dlog_e. c, ct
// (n_rows, kf), pat (kf,) 0/1 f32; node tables d (R, kf) (kernel 3: h @
// w_bot; kernel 10: the caller's) and h (R, f) f32, R above every src; src
// (n_edges,) i32, row_ptr (n_rows+1,) i32 with row_ptr[n_rows] <= n_edges,
// dc (n_rows, kf) f32; scratch part (n_chunks, 2, kf) f32 and tail_row
// (n_chunks,) i32, n_chunks = mma_segment_sum_n_chunks(n_edges). Unless
// payload is null, also kernel 10's payload (n_edges, kf + f) f32: row e
// is [dlog_e || sum_k (ct[i] * mask_e)_k] for the positions the CSR covers
// and 0 for the others. The form as mma_edge_program_lean_edges': 1, 0, 1
// is kernel 3's bf16 h (ct and each dlog_e rounded to bf16; no payload), 1,
// 1, 0 kernel 10's bf16 d and h. Unless keep is null, mask dropout as
// mma_edge_program_lean_edges takes it (kernel 3's f32 form, no payload).
// Requires f % 4 == 0, kf % f == 0, 16-byte aligned c, ct, pat, dc and
// payload, d and h aligned to 4 of their elements and keep to 4 bytes.
int mma_edge_program_lean_bwd_dst(const void* c, const void* ct, const void* pat, const void* d,
                                  const void* h, const void* src, const void* row_ptr, void* dc,
                                  void* payload, void* part, void* tail_row, int n_rows, int f,
                                  int kf, int n_edges, int h_bf16, int d_bf16, int round,
                                  const void* keep, float keep_scale, void* stream) {
  if (n_rows <= 0 && payload == nullptr) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto form) -> cudaError_t {
    using Fm = decltype(form);
    using Msg = LeanDcMessage<Fm>;
    const Msg msg{static_cast<const float4*>(c),   static_cast<const float4*>(ct),
                  static_cast<const float4*>(pat), static_cast<const typename Msg::DS::Raw*>(d),
                  static_cast<const typename Msg::HS::Raw*>(h), kf / 4, f / 4};
    if (keep != nullptr) {
      if constexpr (std::is_same<Msg, LeanDcKeepMessage::Base>::value) {
        if (payload != nullptr) return cudaErrorInvalidValue;
        const LeanDcKeepMessage kmsg{
            msg, KeepRows{static_cast<const uint32_t*>(keep), nullptr, keep_scale}};
        return launch_lean_bwd_edges(kmsg, row_ptr, src, dc, part, tail_row, n_rows, kf,
                                     n_edges, s);
      } else {
        return cudaErrorInvalidValue;  // the keep is kernel 3's f32 form's alone
      }
    }
    if (payload == nullptr) {
      return launch_lean_bwd_edges(msg, row_ptr, src, dc, part, tail_row, n_rows, kf, n_edges,
                                   s);
    }
    if constexpr (Fm::kRound || !std::is_same<typename Fm::H, typename Fm::D>::value) {
      return cudaErrorInvalidValue;  // the payload is kernel 10's alone
    } else {
      const LeanDcPayloadMessage<typename Fm::H> pmsg{msg, static_cast<float4*>(payload), n_edges,
                                                      lanes_per_edge(kf / 4) % (f / 4) == 0};
      return launch_lean_bwd_edges(pmsg, row_ptr, src, dc, part, tail_row, n_rows, kf, n_edges,
                                   s);
    }
  };
  return static_cast<int>(by_form(h_bf16, d_bf16, round, launch));
}

// Kernel 3's src pass over the CSC: out[s] = [dD[s] || G[s]] (n_rows, 2
// kf) f32. Node tables c, ct (R, kf) gathered through dst_csc (n_edges,)
// i32, R above every dst_csc; d (n_rows, kf), h (n_rows, f), pat (kf,);
// col_ptr (n_rows+1,) i32 with col_ptr[n_rows] <= n_edges; scratch part
// (n_chunks, 2, 2 kf) f32 and tail_row (n_chunks,) i32; h bf16 when h_bf16
// != 0. Unless keep is null, mask dropout (f32 h only): keep as
// mma_edge_program_lean_edges takes it, in CSR rows, and keep_perm
// (n_edges,) i32, the CSR row of each CSC position (Graph.src_perm). Same
// width and alignment requirements as mma_edge_program_lean_bwd_dst.
int mma_edge_program_lean_bwd_src(const void* c, const void* ct, const void* pat, const void* d,
                                  const void* h, const void* dst_csc, const void* col_ptr,
                                  void* out, void* part, void* tail_row, int n_rows, int f,
                                  int kf, int n_edges, int h_bf16, const void* keep,
                                  const void* keep_perm, float keep_scale, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto form) {
    using Msg = LeanSrcMessage<decltype(form)>;
    const Msg msg{static_cast<const float4*>(c),   static_cast<const float4*>(ct),
                  static_cast<const float4*>(pat), static_cast<const float4*>(d),
                  static_cast<const typename Msg::HS::Raw*>(h), kf / 4, f / 4};
    return launch_lean_bwd_edges(msg, col_ptr, dst_csc, out, part, tail_row, n_rows, kf,
                                 n_edges, s);
  };
  if (keep != nullptr) {
    if (h_bf16 || keep_perm == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const LeanSrcKeepMessage msg{
        {static_cast<const float4*>(c), static_cast<const float4*>(ct),
         static_cast<const float4*>(pat), static_cast<const float4*>(d),
         static_cast<const float4*>(h), kf / 4, f / 4},
        KeepRows{static_cast<const uint32_t*>(keep), static_cast<const int32_t*>(keep_perm),
                 keep_scale}};
    return static_cast<int>(
        launch_lean_bwd_edges(msg, col_ptr, dst_csc, out, part, tail_row, n_rows, kf, n_edges, s));
  }
  // Kernel 3's forms: f32, or a bf16 h with ct and dlog_e rounded.
  return static_cast<int>(h_bf16 ? launch(Form<bf16, float, true>())
                                 : launch(Form<float, float, false>()));
}

// Kernel 11, the src pass with G's K blocks folded as it stores: out[s] =
// [dd[s] || dh[s]] (n_rows, kf + f) f32, scratch part (n_chunks, 2, kf + f)
// f32; the other arguments and requirements as
// mma_edge_program_lean_bwd_src's, with the caller's d. tables_bf16 != 0:
// d and h are bf16 (c and ct stay f32), and every term is f32 (the form 1,
// 1, 0).
int mma_edge_program_bwd_csc(const void* c, const void* ct, const void* pat, const void* d,
                             const void* h, const void* dst_csc, const void* col_ptr, void* out,
                             void* part, void* tail_row, int n_rows, int f, int kf, int n_edges,
                             int tables_bf16, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  auto launch = [&](auto elem) {
    using E = typename decltype(elem)::type;
    using Msg = LeanSrcFoldMessage<E>;
    const typename Msg::Base src{
        static_cast<const float4*>(c),   static_cast<const float4*>(ct),
        static_cast<const float4*>(pat), static_cast<const typename Msg::DS::Raw*>(d),
        static_cast<const typename Msg::HS::Raw*>(h), kf / 4, f / 4};
    const Msg msg{src, lanes_per_edge(kf / 4) % (f / 4) == 0};
    return launch_lean_bwd_edges(msg, col_ptr, dst_csc, out, part, tail_row, n_rows, kf,
                                 n_edges, static_cast<cudaStream_t>(stream));
  };
  return static_cast<int>(tables_bf16 ? launch(Type<bf16>()) : launch(Type<float>()));
}

// The slab count of mma_edge_program_lean_bwd_node; the caller sizes the
// (n_slabs, f, kf) f32 dW_bot partials from it.
int mma_edge_program_lean_bwd_n_slabs(int n_rows, int f, int kf) {
  return dw_n_slabs(n_rows, f, kf);
}

// Kernel 3's node pass: dh = fold_K(G) + dD @ w_bot^T (n_rows, f) and dw =
// h^T dD (f, kf), from ddg (n_rows, 2 kf) = [dD || G], h (n_rows, f) f32
// (bf16 when h_bf16 != 0) and w_bot (f, kf) f32; dh and dw f32; scratch
// dw_part (n_slabs, f, kf) f32. Requires f % 4 == 0, f <= 128, kf % f == 0,
// kf <= 512 and 16-byte aligned ddg, h and w_bot.
int mma_edge_program_lean_bwd_node(const void* ddg, const void* h, const void* w_bot, void* dh,
                                   void* dw, void* dw_part, int n_rows, int f, int kf,
                                   int h_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dd = static_cast<const float*>(ddg);
  float* part = static_cast<float*>(dw_part);
  const int64_t len = static_cast<int64_t>(f) * kf;
  if (n_rows <= 0) {  // no rows: dW_bot is 0
    return static_cast<int>(launch_sum_slabs(part, 0, len, static_cast<float*>(dw), s));
  }
  const float* w = static_cast<const float*>(w_bot);
  float* out = static_cast<float*>(dh);
  cudaError_t err = f <= 32   ? launch_dh<8>(dd, w, out, n_rows, f, kf, s)
                    : f <= 64 ? launch_dh<16>(dd, w, out, n_rows, f, kf, s)
                              : launch_dh<32>(dd, w, out, n_rows, f, kf, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dw_pass = [&](auto elem) {
    using E = typename decltype(elem)::type;
    const E* hp = static_cast<const E*>(h);
    return f <= 64 ? launch_dw<8, E>(dd, hp, part, n_rows, f, kf, s)
                   : launch_dw<16, E>(dd, hp, part, n_rows, f, kf, s);
  };
  err = h_bf16 ? dw_pass(Type<bf16>()) : dw_pass(Type<float>());
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_slabs(part, dw_n_slabs(n_rows, f, kf), len,
                                           static_cast<float*>(dw), s));
}

// data (E, C) f32 (bf16 when data_bf16 != 0), row_ptr (n_rows+1,) i32, out
// (n_rows, 2C) f32.
int mma_segment_sum_sq_csr(const void* data, const void* row_ptr, void* out, int n_rows,
                           int n_chan, int data_bf16, void* stream) {
  if (n_rows <= 0 || n_chan <= 0) return static_cast<int>(cudaSuccess);
  // Threads along x cover channels (a multiple of 32, at most 128); the
  // rest of the 256-thread block along y covers rows.
  int bx = ((n_chan + kWarp - 1) / kWarp) * kWarp;
  if (bx > 128) bx = 128;
  const int by = 256 / bx;
  auto launch = [&](auto elem) {
    using E = typename decltype(elem)::type;
    segment_sum_sq_kernel<E><<<(n_rows + by - 1) / by, dim3(bx, by), 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(data), static_cast<const int32_t*>(row_ptr),
        static_cast<float*>(out), n_rows, n_chan);
  };
  data_bf16 ? launch(Type<bf16>()) : launch(Type<float>());
  return static_cast<int>(cudaGetLastError());
}

// logits (n_edges, kf) f32 (bf16 when logits_bf16 != 0), h_src (n_edges, f)
// f32 (bf16 when h_bf16 != 0), pat (kf,) 0/1 f32, row_ptr (n_rows+1,) i32
// with row_ptr[n_rows] <= n_edges, out (n_rows, kf) f32; scratch part
// (n_chunks, 2, kf) f32 and tail_row (n_chunks,) i32, n_chunks =
// mma_segment_sum_n_chunks(n_edges). Requires kf % f == 0, kf <= 512;
// vec4 != 0 requires f % 4 == 0, 16-byte aligned pat, out and part, and
// logits and h_src aligned to 4 of their elements.
int mma_masked_segment_sum(const void* logits, const void* h_src, const void* pat,
                           const void* row_ptr, void* out, void* part, void* tail_row,
                           int n_rows, int f, int kf, int n_edges, int vec4, int logits_bf16,
                           int h_bf16, void* stream) {
  if (n_rows <= 0) return static_cast<int>(cudaSuccess);
  if (f <= 0 || kf % f != 0 || kf > kMaxKF || (vec4 && f % 4 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The vector path's lanes per edge, for both paths (see the note above).
  const int lpe = lanes_per_edge((kf + 3) / 4);
  const int n_vec = vec4 ? kf / 4 : kf;
  const int tiles = (n_vec + lpe - 1) / lpe;
  const int chunk = sum_chunk_edges(n_edges);
  const int n_chunks = sum_n_chunks(n_edges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto by_types = [&](auto el, auto eh) -> cudaError_t {
    using EL = typename decltype(el)::type;
    using EH = typename decltype(eh)::type;
    auto launch = [&](auto vec, auto eight) -> cudaError_t {
      constexpr int VEC = decltype(vec)::value;
      using Msg = MaskedMessage<VEC, EL, EH>;
      const Msg msg{static_cast<const typename Msg::LS::Raw*>(logits),
                    static_cast<const typename Msg::HS::Raw*>(h_src),
                    static_cast<const typename Msg::T*>(pat), n_vec, f / VEC};
      // A round covers 4 lanes of a lane's slots, or 8 (several rounds past that).
      constexpr int TILES = (decltype(eight)::value ? 8 : 4) / VEC;
      return launch_masked<Msg, TILES>(msg, row_ptr, out, part, tail_row, n_rows, n_vec, lpe,
                                       tiles, chunk, n_chunks, s);
    };
    const bool wide = tiles * (vec4 ? 4 : 1) > 4;
    if (vec4) {
      return wide ? launch(std::integral_constant<int, 4>(), std::true_type())
                  : launch(std::integral_constant<int, 4>(), std::false_type());
    }
    return wide ? launch(std::integral_constant<int, 1>(), std::true_type())
                : launch(std::integral_constant<int, 1>(), std::false_type());
  };
  auto by_h = [&](auto el) {
    return h_bf16 ? by_types(el, Type<bf16>()) : by_types(el, Type<float>());
  };
  return static_cast<int>(logits_bf16 ? by_h(Type<bf16>()) : by_h(Type<float>()));
}

}  // extern "C"
