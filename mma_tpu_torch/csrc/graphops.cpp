// mma_tpu native graph ops — host-side graph construction fast paths.
//
// The reference reaches its native graph machinery through scipy/networkx
// (C-backed CSR construction, node_classification/utils.py:66-71,139-146).
// This library provides the equivalent first-class native components for
// the TPU framework's ingest pipeline: stable edge sorting (two-pass
// counting sort, O(E+N) vs numpy lexsort's comparison sort), CSR offset
// construction, degree computation, symmetrization with deduplication,
// and edge-balanced partition boundaries for multi-host sharding.
//
// Exposed as a C ABI consumed via ctypes; a NumPy fallback keeps the
// framework fully functional without the build.
//
// The port's own copy of the JAX package's native/graphops.cpp, with the
// same results, the sampler's per-node draw in a function of its own
// (sample_node), and one more entry point, mma_sample_picks: the host
// version of the card's sampler kernel (csrc/sampler.cu).
// mma_tpu_torch/graph/native.py compiles it with the host g++ at first use
// into mma_tpu_torch/_build/ and binds it.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Stable sort of edges by (dst major, src minor): two-pass counting sort.
// out_perm receives the permutation applied (for carrying edge features).
void mma_sort_edges(const int32_t* src, const int32_t* dst, int64_t e,
                    int32_t n, int32_t* out_src, int32_t* out_dst,
                    int32_t* out_perm) {
  std::vector<int64_t> count(static_cast<size_t>(n) + 1, 0);
  std::vector<int32_t> tmp_perm(static_cast<size_t>(e));

  // Pass 1: stable counting sort by src.
  for (int64_t i = 0; i < e; ++i) count[src[i] + 1]++;
  for (int32_t v = 0; v < n; ++v) count[v + 1] += count[v];
  {
    std::vector<int64_t> pos(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < e; ++i)
      tmp_perm[pos[src[i]]++] = static_cast<int32_t>(i);
  }

  // Pass 2: stable counting sort by dst over the src-sorted order.
  std::fill(count.begin(), count.end(), 0);
  for (int64_t i = 0; i < e; ++i) count[dst[i] + 1]++;
  for (int32_t v = 0; v < n; ++v) count[v + 1] += count[v];
  {
    std::vector<int64_t> pos(count.begin(), count.end() - 1);
    for (int64_t i = 0; i < e; ++i) {
      int32_t idx = tmp_perm[i];
      int64_t p = pos[dst[idx]]++;
      out_perm[p] = idx;
      out_src[p] = src[idx];
      out_dst[p] = dst[idx];
    }
  }
}

// CSR row offsets over a dst-sorted edge list (row_ptr has n+1 entries).
void mma_build_row_ptr(const int32_t* dst_sorted, int64_t e, int32_t n,
                       int32_t* row_ptr) {
  std::memset(row_ptr, 0, sizeof(int32_t) * (static_cast<size_t>(n) + 1));
  for (int64_t i = 0; i < e; ++i) row_ptr[dst_sorted[i] + 1]++;
  for (int32_t v = 0; v < n; ++v) row_ptr[v + 1] += row_ptr[v];
}

// Float in-degrees from destination ids.
void mma_degrees(const int32_t* dst, int64_t e, int32_t n, float* deg) {
  std::memset(deg, 0, sizeof(float) * static_cast<size_t>(n));
  for (int64_t i = 0; i < e; ++i) deg[dst[i]] += 1.0f;
}

// Symmetrize + deduplicate a directed edge list (drops self-loops, adds
// both directions, removes duplicates). Returns the new edge count;
// out_src/out_dst must have capacity 2*e. Two-phase usage: call once to
// get the count (outputs may be larger), buffers are filled directly.
int64_t mma_symmetrize(const int32_t* src, const int32_t* dst, int64_t e,
                       int32_t n, int32_t* out_src, int32_t* out_dst) {
  std::vector<int64_t> keys;
  keys.reserve(static_cast<size_t>(2 * e));
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] == dst[i]) continue;  // no self-loops (utils.py semantics)
    keys.push_back(static_cast<int64_t>(dst[i]) * n + src[i]);
    keys.push_back(static_cast<int64_t>(src[i]) * n + dst[i]);
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  int64_t m = static_cast<int64_t>(keys.size());
  for (int64_t i = 0; i < m; ++i) {
    out_dst[i] = static_cast<int32_t>(keys[i] / n);
    out_src[i] = static_cast<int32_t>(keys[i] % n);
  }
  return m;
}

// Edge-balanced contiguous row partition: choose num_parts-1 row cut
// points so each part holds ~e/num_parts edges (multi-host sharding with
// whole rows per shard — SURVEY §7 "edge-balanced partitions").
void mma_balanced_row_cuts(const int32_t* row_ptr, int32_t n,
                           int32_t num_parts, int32_t* cuts /*num_parts+1*/) {
  int64_t total = row_ptr[n];
  cuts[0] = 0;
  int32_t row = 0;
  for (int32_t p = 1; p < num_parts; ++p) {
    int64_t target = total * p / num_parts;
    while (row < n && row_ptr[row] < target) ++row;
    cuts[p] = row;
  }
  cuts[num_parts] = n;
}

// Locality-aware streaming graph partition (Linear Deterministic Greedy).
//
// `mma_balanced_row_cuts` balances edges but ignores locality: on graphs
// whose node order scrambles community structure, contiguous cuts make
// nearly every edge a shard-boundary edge. LDG (Stanton & Kliot, KDD'12)
// streams nodes in descending-degree order and assigns each to the part
// with the most already-assigned neighbors, damped by a load factor —
// O(E), deterministic, and recovers clustered structure without a full
// multilevel partitioner. Parts are edge-weight balanced (load = in-deg).
// out_part: (n) part id per node.
void mma_partition_ldg(const int64_t* row_ptr, const int32_t* src_sorted,
                       int32_t n, int32_t num_parts, float slack,
                       int32_t* out_part) {
  // Degree-descending visit order (counting sort, stable).
  std::vector<int32_t> order(static_cast<size_t>(n));
  {
    int64_t max_deg = 0;
    for (int32_t v = 0; v < n; ++v)
      max_deg = std::max(max_deg, row_ptr[v + 1] - row_ptr[v]);
    std::vector<int64_t> cnt(static_cast<size_t>(max_deg) + 2, 0);
    for (int32_t v = 0; v < n; ++v)
      cnt[max_deg - (row_ptr[v + 1] - row_ptr[v]) + 1]++;
    for (size_t i = 1; i < cnt.size(); ++i) cnt[i] += cnt[i - 1];
    for (int32_t v = 0; v < n; ++v)
      order[cnt[max_deg - (row_ptr[v + 1] - row_ptr[v])]++] = v;
  }
  std::fill(out_part, out_part + n, -1);
  std::vector<double> load(num_parts, 0.0);
  const double cap =
      std::max(1.0, (double)row_ptr[n] * slack / num_parts);
  std::vector<int64_t> nbr_cnt(num_parts, 0);
  std::vector<int32_t> touched;
  touched.reserve(num_parts);
  for (int32_t i = 0; i < n; ++i) {
    const int32_t v = order[i];
    for (int64_t e = row_ptr[v]; e < row_ptr[v + 1]; ++e) {
      const int32_t p = out_part[src_sorted[e]];
      if (p >= 0) {
        if (nbr_cnt[p] == 0) touched.push_back(p);
        nbr_cnt[p]++;
      }
    }
    double best_score = -1.0;
    int32_t best = 0;
    for (int32_t p = 0; p < num_parts; ++p) {
      const double w = 1.0 - load[p] / cap;
      if (w <= 0.0) continue;
      const double s = (static_cast<double>(nbr_cnt[p]) + 1e-3) * w;
      if (s > best_score) {
        best_score = s;
        best = p;
      }
    }
    if (best_score < 0.0) {
      // all parts at capacity (shouldn't happen with slack > 1): least load
      best = static_cast<int32_t>(
          std::min_element(load.begin(), load.end()) - load.begin());
    }
    out_part[v] = best;
    load[best] += static_cast<double>(row_ptr[v + 1] - row_ptr[v]) + 1.0;
    for (int32_t p : touched) nbr_cnt[p] = 0;
    touched.clear();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multithreaded layered neighbor sampler (GraphSAGE-style).
//
// The torch ecosystem reaches this through C++ samplers (pyg-lib /
// torch_sparse neighbor_sample); the reference itself has none (its ZINC
// loader is whole-graph). This is the host-side producer for the
// ogbn-scale sampled regime: the NumPy sampler costs ~2.7 s/batch
// (argsort-based per-segment top-k + np.unique relabel) and starves the
// device (~1.5 s/step). Design:
//
// - hop expansion parallelizes over frontier chunks; each thread samples
//   its nodes' in-neighbors into a thread-local buffer (all-edges when
//   deg <= fanout, else an O(deg) reservoir);
// - per-node counter-based RNG (splitmix64 of rng_seed ^ node ^ hop) so
//   results are deterministic and independent of the thread count;
// - merge + relabel is one sequential pass in (thread, node) order over
//   a flat local-id table — assignment order (and thus the node layout)
//   is deterministic;
// - within-node duplicate sources (multi-edges) are dropped via a tiny
//   sort of the <= fanout picks — the global (src, dst) pair dedup the
//   NumPy path does with np.unique, for free.
//
// Emits LOCAL edge endpoints (per-hop node layout: seeds first, then
// each hop's new nodes — matching hop_node_pads/ELL bucketing) and the
// per-hop new-node counts. Returns the edge count, or -1 (node overflow)
// / -2 (edge overflow).

namespace {

inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(splitmix64(seed)) {}
  inline uint64_t next() { return s = splitmix64(s); }
  // Unbiased-enough bounded draw (128-bit multiply trick).
  inline uint64_t below(uint64_t n) {
    return (uint64_t)(((__uint128_t)next() * n) >> 64);
  }
};

// The picks of node u at one hop: up to fanout of its in-edges (all of them
// when deg <= fanout, else an O(deg) reservoir over the edge positions,
// deterministic per (rng_seed, node, hop) and thread-count independent),
// resolved to sources, sorted, with within-node duplicates (multi-edges)
// dropped, into out; returns how many.
inline int32_t sample_node(const int64_t* row_ptr, const int32_t* src_sorted,
                           int32_t u, int32_t fanout, int32_t hop,
                           uint64_t rng_seed, int32_t* out) {
  const int64_t lo_e = row_ptr[u], deg = row_ptr[u + 1] - lo_e;
  int64_t pick[64];  // fanout <= 64 enforced at the wrapper
  int32_t k;
  if (deg <= fanout) {
    k = static_cast<int32_t>(deg);
    for (int32_t j = 0; j < k; ++j) pick[j] = lo_e + j;
  } else {
    Rng rng(rng_seed ^ (static_cast<uint64_t>(u) << 20) ^ hop);
    k = fanout;
    for (int32_t j = 0; j < fanout; ++j) pick[j] = lo_e + j;
    for (int64_t j = fanout; j < deg; ++j) {
      const uint64_t r = rng.below(static_cast<uint64_t>(j + 1));
      if (r < static_cast<uint64_t>(fanout))
        pick[r] = lo_e + j;
    }
  }
  int32_t vals[64];
  for (int32_t j = 0; j < k; ++j)
    vals[j] = src_sorted[pick[j]];
  std::sort(vals, vals + k);
  int32_t m = 0;
  for (int32_t j = 0; j < k; ++j) {
    if (j > 0 && vals[j] == vals[j - 1]) continue;
    out[m++] = vals[j];
  }
  return m;
}

}  // namespace

extern "C" {

int64_t mma_sample_layered(
    const int64_t* row_ptr, const int32_t* src_sorted, int64_t n_nodes,
    const int32_t* seeds, int64_t n_seeds,
    const int32_t* fanouts, int32_t n_hops,
    uint64_t rng_seed, int32_t n_threads,
    int32_t* out_nodes, int64_t* hop_counts,
    int32_t* out_src, int32_t* out_dst,
    int64_t node_cap, int64_t edge_cap) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int32_t> local_of(static_cast<size_t>(n_nodes), -1);

  int64_t n_local = 0;   // rows assigned
  int64_t n_edges = 0;
  std::vector<int32_t> frontier;  // global ids to expand next
  frontier.reserve(static_cast<size_t>(n_seeds));

  if (n_seeds > node_cap) return -1;
  for (int64_t i = 0; i < n_seeds; ++i) {
    int32_t s = seeds[i];
    out_nodes[n_local] = s;
    if (local_of[s] < 0) {
      local_of[s] = static_cast<int32_t>(n_local);
      frontier.push_back(s);
    }
    // duplicate seed rows keep their own (edgeless) row, as the NumPy
    // path's first-occurrence mapping does.
    ++n_local;
  }
  hop_counts[0] = n_seeds;

  std::vector<int32_t> next_frontier;
  for (int32_t hop = 0; hop < n_hops; ++hop) {
    const int32_t fanout = fanouts[hop];
    const int64_t nf = static_cast<int64_t>(frontier.size());
    const int32_t nt = static_cast<int32_t>(
        std::min<int64_t>(n_threads, std::max<int64_t>(nf, 1)));
    // Thread-local buffers of (src_global, dst_local) pairs.
    std::vector<std::vector<int32_t>> buf_src(nt), buf_dst(nt);

    auto work = [&](int32_t t) {
      const int64_t lo = nf * t / nt, hi = nf * (t + 1) / nt;
      auto& bs = buf_src[t];
      auto& bd = buf_dst[t];
      bs.reserve(static_cast<size_t>((hi - lo) * fanout));
      bd.reserve(static_cast<size_t>((hi - lo) * fanout));
      int32_t vals[64];  // fanout <= 64 enforced at the wrapper
      for (int64_t i = lo; i < hi; ++i) {
        const int32_t u = frontier[i];
        const int32_t du = local_of[u];
        const int32_t m = sample_node(row_ptr, src_sorted, u, fanout, hop, rng_seed, vals);
        for (int32_t j = 0; j < m; ++j) {
          bs.push_back(vals[j]);
          bd.push_back(du);
        }
      }
    };
    if (nt == 1) {
      work(0);
    } else {
      std::vector<std::thread> threads;
      threads.reserve(nt);
      for (int32_t t = 0; t < nt; ++t) threads.emplace_back(work, t);
      for (auto& th : threads) th.join();
    }

    // Sequential merge: assign new local ids in (thread, emit) order.
    next_frontier.clear();
    const int64_t row_base = n_local;
    for (int32_t t = 0; t < nt; ++t) {
      const auto& bs = buf_src[t];
      const auto& bd = buf_dst[t];
      if (n_edges + static_cast<int64_t>(bs.size()) > edge_cap) return -2;
      for (size_t j = 0; j < bs.size(); ++j) {
        const int32_t sg = bs[j];
        int32_t sl = local_of[sg];
        if (sl < 0) {
          if (n_local >= node_cap) return -1;
          sl = static_cast<int32_t>(n_local);
          local_of[sg] = sl;
          out_nodes[n_local++] = sg;
          next_frontier.push_back(sg);
        }
        out_src[n_edges] = sl;
        out_dst[n_edges] = bd[j];
        ++n_edges;
      }
    }
    hop_counts[hop + 1] = n_local - row_base;
    frontier.swap(next_frontier);
    if (frontier.empty()) {
      for (int32_t h = hop + 1; h < n_hops; ++h) hop_counts[h + 1] = 0;
      break;
    }
  }
  return n_edges;
}

// One hop's picks for a frontier, as mma_tpu_torch/csrc/sampler.cu gives
// them on the card: picks (n_slots, fanout) the sorted distinct sources of
// each of the first n_frontier slots (sample_node), -1 after them; count
// (n_slots,).
void mma_sample_picks(const int64_t* row_ptr, const int32_t* src_sorted,
                      const int32_t* frontier, int64_t n_frontier, int64_t n_slots,
                      int32_t fanout, int32_t hop, uint64_t rng_seed,
                      int32_t* picks, int32_t* count) {
  for (int64_t i = 0; i < n_slots; ++i) {
    int32_t* out = picks + i * fanout;
    const int32_t m = i < n_frontier ? sample_node(row_ptr, src_sorted, frontier[i], fanout,
                                                   hop, rng_seed, out)
                                     : 0;
    count[i] = m;
    std::fill(out + m, out + fanout, -1);
  }
}

}  // extern "C"
