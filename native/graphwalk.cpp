// Native graph-walk runtime: Eulerian bicycle decomposition, biwalk cover,
// chain following.
//
// These are the reference's `bigraph::algo` capabilities (Eulerian
// decomposition eulertigs/mod.rs:119 via crate call, walk cover
// pathtigs/mod.rs:38) re-implemented as flat-array C++ passes: O(E)
// pointer-chasing that is not a fit for the device path but must not
// run as per-edge Python either.  Called via ctypes on int64 arrays.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <unordered_map>
#include <vector>

#ifdef __linux__
#include <sys/mman.h>
#endif

namespace {
using i64 = long long;

// Ask the kernel for transparent huge pages on a freshly-allocated,
// not-yet-touched range: the pointer-chasing passes issue tens of
// millions of random loads over 100MB+ arrays, where 4KB pages cost a
// TLB miss per load.  Must run before first touch so the faults map
// huge pages directly (khugepaged would collapse too late for a
// one-shot pass).  No-op off Linux / when THP is disabled.
static void advise_huge(void* p, size_t bytes) {
#if defined(__linux__) && defined(MADV_HUGEPAGE)
  const uintptr_t HUGE = (uintptr_t)1 << 21;
  uintptr_t a = (uintptr_t)p;
  uintptr_t lo = (a + HUGE - 1) & ~(HUGE - 1);
  uintptr_t hi = (a + bytes) & ~(HUGE - 1);
  if (hi > lo) madvise((void*)lo, hi - lo, MADV_HUGEPAGE);
#else
  (void)p;
  (void)bytes;
#endif
}

// MATCHTIGS_NATIVE_TRACE=1 prints per-phase wall times to stderr
// (observability analog of the reference's --dijkstra-performance-data).
struct PhaseTimer {
  const char* name;
  bool on;
  std::chrono::steady_clock::time_point t0;
  explicit PhaseTimer(const char* n)
      : name(n), on(std::getenv("MATCHTIGS_NATIVE_TRACE") != nullptr) {
    if (on) t0 = std::chrono::steady_clock::now();
  }
  void lap(const char* phase) {
    if (!on) return;
    auto t1 = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[native] %s %s: %.3fs\n", name, phase,
                 std::chrono::duration<double>(t1 - t0).count());
    t0 = t1;
  }
};

template <class I>
static i64 stitch_tours(i64 n_nodes, i64 n_edges, const I* dst,
                        const I* mirror, std::vector<I>& tour_data,
                        const std::vector<i64>& tour_off, i64* cycles_out,
                        i64* cycle_offsets, PhaseTimer& timer);

// Eulerian bicycle decomposition core, templated on the index type: at
// <2^31 edges the working arrays are int32, halving the cache traffic of
// the pointer-chasing phases (measured 1.5s -> ~0.9s at 3.5M edges).
// Tours live in one flat arena (data + offsets) instead of one heap
// vector per subtour.  Traversal order is identical across
// instantiations (parity/golden tests pin the output).
template <class I>
static i64 euler_decompose_impl(i64 n_nodes, i64 n_edges, const i64* src64,
                                const i64* dst64, const i64* mirror64,
                                const i64* out_off64, const i64* out_edges64,
                                i64* cycles_out, i64* cycle_offsets) {
  PhaseTimer timer("euler_decompose");
  std::vector<I> src(src64, src64 + n_edges);
  std::vector<I> dst(dst64, dst64 + n_edges);
  std::vector<I> mirror(mirror64, mirror64 + n_nodes);
  std::vector<I> out_off(out_off64, out_off64 + n_nodes + 1);
  std::vector<I> out_edges(out_edges64, out_edges64 + n_edges);

  std::vector<char> used(n_edges, 0);
  std::vector<I> cursor(out_off.begin(), out_off.end() - 1);

  auto next_unused_out = [&](I v) -> I {
    I c = cursor[v];
    I end = out_off[v + 1];
    while (c < end && used[out_edges[c]]) ++c;
    cursor[v] = c;
    return c < end ? out_edges[c] : (I)-1;
  };

  // Phase A: raw closed Hierholzer subtours (mirror consumption) into a
  // flat arena; tour t occupies tour_data[tour_off[t] .. tour_off[t+1]).
  std::vector<I> tour_data;
  tour_data.reserve(n_edges / 2 + 1);
  std::vector<i64> tour_off{0};
  for (i64 e0 = 0; e0 < n_edges; ++e0) {
    if (used[e0]) continue;
    tour_data.push_back((I)e0);
    used[e0] = 1;
    used[e0 ^ 1] = 1;
    I start = src[e0];
    I cur = dst[e0];
    for (;;) {
      while (cur != start) {
        I e = next_unused_out(cur);
        if (e < 0) return -1;  // open walk: unbalanced graph
        tour_data.push_back(e);
        used[e] = 1;
        used[e ^ 1] = 1;
        cur = dst[e];
      }
      I e = next_unused_out(start);
      if (e < 0) break;
      tour_data.push_back(e);
      used[e] = 1;
      used[e ^ 1] = 1;
      cur = dst[e];
    }
    tour_off.push_back((i64)tour_data.size());
  }
  timer.lap("A subtours");
  return stitch_tours<I>(n_nodes, n_edges, dst.data(), mirror.data(),
                         tour_data, tour_off, cycles_out, cycle_offsets,
                         timer);
}

// Phases B + C shared by the Hierholzer and pairing decompositions:
// bucket subtours by binode, stitch each shared-binode group into one
// bicycle per mirror-connected component.
template <class I>
static i64 stitch_tours(i64 n_nodes, i64 n_edges, const I* dst,
                        const I* mirror, std::vector<I>& tour_data,
                        const std::vector<i64>& tour_off, i64* cycles_out,
                        i64* cycle_offsets, PhaseTimer& timer) {
  const i64 n_tours = (i64)tour_off.size() - 1;
  const i64 n_tour_edges = (i64)tour_data.size();

  // Phase B: bucket tour-edge occurrences by binode key min(v, mirror(v))
  // via counting sort (flat CSR; a std::map of vectors here cost ~6s at
  // 3M edges from tree lookups and per-binode allocations).  Bucket
  // entries keep tour order (ti ascending), so Phase C's BFS discovery
  // order is identical to the python oracle's per-binode tour lists.
  std::vector<I> tour_of(n_edges, (I)-1);
  for (i64 ti = 0; ti < n_tours; ++ti)
    for (i64 i = tour_off[ti]; i < tour_off[ti + 1]; ++i)
      tour_of[tour_data[i]] = (I)ti;
  std::vector<I> boff(n_nodes + 1, 0);
  for (i64 i = 0; i < n_tour_edges; ++i) {
    I v = dst[tour_data[i]];
    I m = mirror[v];
    I b = v < m ? v : m;
    ++boff[b + 1];
  }
  for (i64 v = 0; v < n_nodes; ++v) boff[v + 1] += boff[v];
  std::vector<I> bedges(n_tour_edges);
  {
    std::vector<I> bcur(boff.begin(), boff.end() - 1);
    for (i64 i = 0; i < n_tour_edges; ++i) {
      I e = tour_data[i];
      I v = dst[e];
      I m = mirror[v];
      I b = v < m ? v : m;
      bedges[bcur[b]++] = e;
    }
  }
  timer.lap("B buckets");

  // Phase C: stitch each shared-binode group into one bicycle, merging
  // subtours in BFS order; an incoming subtour sharing only the mirror
  // side is flipped (reverse + e^1) in place before splicing.
  std::vector<I> nxt(n_edges, (I)-1);
  std::vector<char> visited(n_tours, 0);
  std::vector<I> occ(n_nodes, (I)-1);
  std::vector<I> occ_touched;
  std::vector<I> queue;
  i64 pos = 0;
  i64 n_cycles = 0;
  for (i64 t0 = 0; t0 < n_tours; ++t0) {
    if (visited[t0]) continue;
    visited[t0] = 1;
    occ_touched.clear();
    const i64 a_lo = tour_off[t0], a_hi = tour_off[t0 + 1];
    for (i64 i = a_lo; i + 1 < a_hi; ++i) nxt[tour_data[i]] = tour_data[i + 1];
    nxt[tour_data[a_hi - 1]] = tour_data[a_lo];
    for (i64 i = a_lo; i < a_hi; ++i) {
      I v = dst[tour_data[i]];
      if (occ[v] < 0) {
        occ[v] = tour_data[i];
        occ_touched.push_back(v);
      }
    }
    i64 total_len = a_hi - a_lo;
    I head = tour_data[a_lo];

    queue.clear();
    queue.push_back((I)t0);
    for (std::size_t qi = 0; qi < queue.size(); ++qi) {
      I t = queue[qi];
      for (i64 i = tour_off[t]; i < tour_off[t + 1]; ++i) {
        I v = dst[tour_data[i]];
        I m = mirror[v];
        I b = v < m ? v : m;
        for (I bi = boff[b]; bi < boff[b + 1]; ++bi) {
          I tn = tour_of[bedges[bi]];
          if (visited[tn]) continue;
          visited[tn] = 1;
          queue.push_back(tn);
          const i64 s_lo = tour_off[tn], s_hi = tour_off[tn + 1];
          I anchor = -1;
          for (i64 si = s_lo; si < s_hi; ++si) {
            I u = dst[tour_data[si]];
            if (occ[u] >= 0) {
              anchor = occ[u];
              break;
            }
            I mu = mirror[u];
            if (occ[mu] >= 0) {
              // flip the subtour to its mirror representation in place
              for (i64 x = s_lo, y = s_hi - 1; x < y; ++x, --y) {
                I tmp = tour_data[x];
                tour_data[x] = tour_data[y];
                tour_data[y] = tmp;
              }
              for (i64 x = s_lo; x < s_hi; ++x) tour_data[x] ^= 1;
              anchor = occ[mu];
              break;
            }
          }
          if (anchor < 0) return -2;  // BFS neighbor without shared node
          I av = dst[anchor];
          I sub_anchor = -1;
          for (i64 x = s_lo; x < s_hi; ++x)
            if (dst[tour_data[x]] == av) {
              sub_anchor = tour_data[x];
              break;
            }
          for (i64 x = s_lo; x + 1 < s_hi; ++x)
            nxt[tour_data[x]] = tour_data[x + 1];
          nxt[tour_data[s_hi - 1]] = tour_data[s_lo];
          I tmp = nxt[anchor];
          nxt[anchor] = nxt[sub_anchor];
          nxt[sub_anchor] = tmp;
          for (i64 x = s_lo; x < s_hi; ++x) {
            I u = dst[tour_data[x]];
            if (occ[u] < 0) {
              occ[u] = tour_data[x];
              occ_touched.push_back(u);
            }
          }
          total_len += s_hi - s_lo;
        }
      }
    }

    I e = head;
    for (i64 i = 0; i < total_len; ++i) {
      cycles_out[pos++] = e;
      e = nxt[e];
    }
    if (e != head) return -3;  // stitched chain not circular
    cycle_offsets[n_cycles++] = pos;
    for (I v : occ_touched) occ[v] = -1;  // reset for the next group
  }
  timer.lap("C stitch");
  return n_cycles;
}


// Shared by the pairing and splice decompositions: the deterministic
// mirror-compatible arc pairing pi (see ops/euler.py for the math): the
// i-th in-arc at v (= mirror of the i-th out-arc at mirror(v)) pairs
// with the i-th out-arc at v; self-mirror nodes use a fixpoint-free
// adjacent-rank involution on their in-arcs.  Returns false when the
// graph is unbalanced.
static bool build_pairing_pi(i64 n_nodes, const int32_t* mirror,
                             const i64* out_off, const int32_t* out_edges,
                             i64 n_threads, int32_t* pi,
                             i64 stride = 1) {
  using I = int32_t;
  std::atomic<bool> balanced{true};
  auto build = [&](i64 lo, i64 hi) {
    for (i64 v = lo; v < hi; ++v) {
      I mv = mirror[v];
      if ((i64)mv < v) continue;  // the representative handles both sides
      const i64 ob = out_off[v], oe = out_off[v + 1];
      const i64 odeg = oe - ob;
      if ((i64)mv != v) {
        const i64 ib = out_off[mv];
        if (out_off[mv + 1] - ib != odeg) {
          balanced.store(false, std::memory_order_relaxed);
          return;
        }
        for (i64 i = 0; i < odeg; ++i) {
          const I a = out_edges[ib + i] ^ (I)1;  // in-arc at v
          const I b = out_edges[ob + i];         // out-arc at v
          pi[(i64)a * stride] = b;
          pi[(i64)(b ^ 1) * stride] = a ^ 1;
        }
      } else {
        if (odeg & 1) {
          balanced.store(false, std::memory_order_relaxed);
          return;
        }
        for (i64 i = 0; i + 1 < odeg; i += 2) {
          const I b0 = out_edges[ob + i], b1 = out_edges[ob + i + 1];
          pi[(i64)(b0 ^ 1) * stride] = b1;
          pi[(i64)(b1 ^ 1) * stride] = b0;
        }
      }
    }
  };
  if (n_threads > 1 && n_nodes > (i64)1 << 16) {
    std::vector<std::thread> ts;
    const i64 chunk = (n_nodes + n_threads - 1) / n_threads;
    for (i64 t = 0; t < n_threads; ++t) {
      const i64 lo = t * chunk;
      if (lo >= n_nodes) break;
      ts.emplace_back(build, lo, std::min(n_nodes, lo + chunk));
    }
    for (auto& t : ts) t.join();
  } else {
    build(0, n_nodes);
  }
  return balanced.load();
}

// Pairing-based Eulerian bicycle decomposition (the parallel-friendly
// phase A replacement; see ops/euler.py for the math).  A deterministic
// mirror-compatible arc pairing pi is built per binode (in-arc i pairs
// with out-arc i; in-arcs at v are the mirrors of out-arcs at mirror(v),
// in that derived order).  pi never maps an arc to its own mirror, so no
// pi-cycle is its own mirror image: cycles come in mirror pairs, and
// scanning start arcs in ascending order while marking both e and e^1
// visited keeps exactly one cycle per pair (each biedge covered once).
// The chase costs ~1 random read per arc vs the Hierholzer cursor scan's
// ~4-6, and the pairing build is thread-parallel.
static i64 pairing_decompose_impl(i64 n_nodes, i64 n_edges,
                                  const int32_t* dst, const int32_t* mirror,
                                  const i64* out_off,
                                  const int32_t* out_edges, i64 n_threads,
                                  i64* cycles_out, i64* cycle_offsets) {
  using I = int32_t;
  PhaseTimer timer("euler_pairing");
  std::vector<I> pi(n_edges);
  if (!build_pairing_pi(n_nodes, mirror, out_off, out_edges, n_threads,
                        pi.data()))
    return -1;
  timer.lap("A' pairing");

  // Extract one cycle per mirror pair, ascending start arc.  e and e^1
  // sit in the same bitmap word (adjacent bits).
  std::vector<uint64_t> visited((n_edges + 63) / 64, 0);
  std::vector<I> tour_data;
  tour_data.reserve(n_edges / 2 + 1);
  std::vector<i64> tour_off{0};
  for (i64 e0 = 0; e0 < n_edges; ++e0) {
    if ((visited[e0 >> 6] >> (e0 & 63)) & 1) continue;
    I cur = (I)e0;
    do {
      tour_data.push_back(cur);
      visited[(i64)cur >> 6] |= (1ull << (cur & 63)) | (1ull << ((cur ^ 1) & 63));
      cur = pi[cur];
    } while (cur != (I)e0);
    tour_off.push_back((i64)tour_data.size());
  }
  pi.clear();
  pi.shrink_to_fit();
  timer.lap("A' extract");

  return stitch_tours<I>(n_nodes, n_edges, dst, mirror, tour_data, tour_off,
                         cycles_out, cycle_offsets, timer);
}

// Splice-based decomposition: pairing pi + ONE merged walk per
// mirror-connected component, no tour arena / bucket sort / stitch.
//
// Invariants that make it work (see ops/euler.py for the pairing math):
//  * marking e and e^1 together drops each cycle's mirror image, so an
//    unvisited in-arc at node v always belongs to a whole-cycle-unvisited
//    pi-cycle — splicing it can never consume both orientations of a
//    biedge;
//  * every cycle pair incident to binode {v, mirror v} has an in-arc AT v
//    among its two mirror representations (a cycle through mirror(v) has
//    an out-arc there, whose mirror is an in-arc at v), so scanning
//    in-arcs of the walk's own nodes reaches every pair of the component
//    — the representation found IS the correctly flipped one;
//  * in-arcs at v are the mirrors of out-arcs at mirror(v): the cursor
//    walks the out-CSR slice of mirror(v), no in-CSR needed.
//
// The splice itself is the classic Hierholzer rotation over pi: at emit
// position `cur` (an in-arc at v) an unvisited in-arc a2 at v swaps
// pi[cur] <-> pi[a2]; the walk detours through a2's cycle and returns.
// Label every arc with a canonical representative of its pi-cycle (the
// cycle's minimal arc id).  The serial chase over all E arcs is the
// latency wall (one dependent load per arc); here splitter arcs (every
// STEP-th id) cut cycles into independent segments chased CONCURRENTLY —
// W in-flight chains per thread hide the DRAM latency behind
// memory-level parallelism — then a vectorized relabel maps provisional
// segment ids to cycle representatives.  Cycles containing no splitter
// are labeled in a final interleaved sweep (ascending start arc, so the
// first unlabeled arc of such a cycle IS its minimum).
//
// The representative is the cycle's MINIMUM ARC ID (each segment tracks
// its own minimum during the chase; phase 2 takes the minimum over a
// cycle's segments) — a canonical id that the python oracle can compute
// with a plain per-cycle min, which the parallel-splice decomposition's
// deterministic pair/orientation rules depend on.
static constexpr i64 LABEL_STEP = 64;  // splitter density (1/STEP of arcs)

static void label_pi_cycles(i64 n_edges, const int32_t* pm32, i64 pm_stride,
                            i64 n_threads, int32_t* rep) {
  using I = int32_t;
  constexpr i64 STEP = LABEL_STEP;
  constexpr int W = 16;  // in-flight chains per thread
  const i64 n_spl = (n_edges + STEP - 1) / STEP;
  std::vector<I> seg_next(n_spl);  // splitter k -> next splitter index
  std::vector<I> seg_min(n_spl);   // splitter k -> min arc in its segment
  std::fill(rep, rep + n_edges, (I)-1);

  // Phase 1: chase each splitter's segment, writing provisional labels
  // (= splitter index) and recording the successor splitter and the
  // segment's minimum arc id.
  auto chase_block = [&](i64 lo, i64 hi) {
    i64 cur_k[W];
    I cur_arc[W];
    I cur_min[W];
    int live = 0;
    i64 next_k = lo;
    auto refill = [&] {
      while (live < W && next_k < hi) {
        cur_k[live] = next_k;
        cur_arc[live] = (I)(next_k * STEP);
        cur_min[live] = (I)(next_k * STEP);
        rep[next_k * STEP] = (I)(next_k * STEP) / STEP;  // provisional
        ++live;
        ++next_k;
      }
    };
    refill();
    while (live) {
      for (int w = 0; w < live;) {
        const I nxt = pm32[(i64)(uint32_t)cur_arc[w] * pm_stride];
        if ((nxt % STEP) == 0) {  // reached a splitter: segment done
          seg_next[cur_k[w]] = nxt / STEP;
          seg_min[cur_k[w]] = cur_min[w];
          cur_k[w] = cur_k[live - 1];
          cur_arc[w] = cur_arc[live - 1];
          cur_min[w] = cur_min[live - 1];
          --live;
          refill();
        } else {
          rep[nxt] = (I)cur_k[w];  // provisional: this segment's splitter
          if (nxt < cur_min[w]) cur_min[w] = nxt;
          cur_arc[w] = nxt;
          ++w;
        }
      }
    }
  };
  if (n_threads > 1 && n_spl > 1024) {
    std::vector<std::thread> ts;
    const i64 chunk = (n_spl + n_threads - 1) / n_threads;
    for (i64 t = 0; t < n_threads; ++t) {
      const i64 lo = t * chunk;
      if (lo >= n_spl) break;
      ts.emplace_back(chase_block, lo, std::min(n_spl, lo + chunk));
    }
    for (auto& th : ts) th.join();
  } else if (n_spl) {
    chase_block(0, n_spl);
  }

  // Phase 2 (serial, n_spl items): group splitters into cycles via the
  // seg_next permutation; representative = min arc id over the cycle's
  // segments (= the cycle's true minimum arc).
  std::vector<I> spl_rep(n_spl, (I)-1);
  for (i64 k0 = 0; k0 < n_spl; ++k0) {
    if (spl_rep[k0] >= 0) continue;
    I mn = seg_min[k0];
    i64 k = seg_next[k0];
    while (k != k0) {
      if (seg_min[k] < mn) mn = seg_min[k];
      k = seg_next[k];
    }
    spl_rep[k0] = mn;
    k = seg_next[k0];
    while (k != k0) {
      spl_rep[k] = mn;
      k = seg_next[k];
    }
  }

  // Phase 3 (MT, linear): provisional segment id -> cycle representative.
  {
    const i64 nt = std::max<i64>(1, n_threads);
    std::vector<std::thread> ts;
    const i64 chunk = (n_edges + nt - 1) / nt;
    auto relabel = [&](i64 lo, i64 hi) {
      for (i64 e = lo; e < hi; ++e)
        if (rep[e] >= 0) rep[e] = spl_rep[rep[e]];
    };
    if (nt > 1 && n_edges > (i64)1 << 16) {
      for (i64 t = 0; t < nt; ++t) {
        const i64 lo = t * chunk;
        if (lo >= n_edges) break;
        ts.emplace_back(relabel, lo, std::min(n_edges, lo + chunk));
      }
      for (auto& th : ts) th.join();
    } else {
      relabel(0, n_edges);
    }
  }

  // Phase 4: splitterless cycles, serial (two interleaved chases could
  // otherwise claim the same cycle).  Cycle-length mass is measured
  // random-permutation-like — a handful of giant cycles hold ~97% of
  // arcs and the splitterless remainder is ~0.00% — so this sweep is
  // noise.  Ascending starts keep the representative = cycle minimum.
  for (i64 e0 = 0; e0 < n_edges; ++e0) {
    if (rep[e0] >= 0) continue;
    rep[e0] = (I)e0;
    I cur = pm32[e0 * pm_stride];
    while ((i64)cur != e0) {
      rep[cur] = (I)e0;
      cur = pm32[(i64)(uint32_t)cur * pm_stride];
    }
  }
}

static i64 splice_decompose_impl(i64 n_nodes, i64 n_edges, const int32_t* dst,
                                 const int32_t* mirror, const i64* out_off,
                                 const int32_t* out_edges, i64 n_threads,
                                 i64* cycles_out, i64* cycle_offsets) {
  using I = int32_t;
  PhaseTimer timer("euler_splice");
  // The emit loop is DRAM-latency bound: one dependent random load per
  // arc.  Interleave pi (mutable successor) and mdst (= mirror[dst[e]],
  // static) as the two int32 halves of ONE uint64 per arc, so the emit
  // step's two per-arc reads are a single cache line hit, and back the
  // array with huge pages (advised before first touch) to kill the
  // per-load TLB miss.  Traversal order is identical to the unpacked
  // version (golden tests pin it).
  uint64_t* pm =
      static_cast<uint64_t*>(std::malloc((size_t)n_edges * sizeof(uint64_t)));
  if (!pm) return -5;
  advise_huge(pm, (size_t)n_edges * sizeof(uint64_t));
  I* pm32 = reinterpret_cast<I*>(pm);  // pm32[2e] = pi, pm32[2e+1] = mdst
  {
    // First touch inside the MT gather (pages fault huge): fill the mdst
    // halves, then the pairing writes the pi halves.
    const i64 nt = std::max<i64>(1, std::min<i64>(n_threads, 16));
    std::vector<std::thread> ts;
    const i64 chunk = (n_edges + nt - 1) / nt;
    for (i64 t = 0; t < nt; ++t) {
      ts.emplace_back([&, t] {
        const i64 lo = t * chunk, hi = std::min<i64>(n_edges, lo + chunk);
        for (i64 e = lo; e < hi; ++e) pm32[2 * e + 1] = mirror[dst[e]];
      });
    }
    for (auto& th : ts) th.join();
  }
  timer.lap("mdst gather");
  if (!build_pairing_pi(n_nodes, mirror, out_off, out_edges, n_threads, pm32,
                        /*stride=*/2)) {
    std::free(pm);
    return -1;
  }
  timer.lap("A' pairing");

  // The serial emit walk is a dependent-load chain: one pi load per arc.
  // The old mark-cycle pass DOUBLED that chain (every cycle chased once
  // to mark e/e^1 visited, once to emit).  Precomputing per-arc cycle
  // labels with the MT segmented chase halves the serial chain: cycle
  // membership becomes one label load + an L2-resident merged bitset,
  // and the splice decisions (hence the emitted tigs) are unchanged.
  I* rep = static_cast<I*>(std::malloc((size_t)n_edges * sizeof(I)));
  if (!rep) {
    std::free(pm);
    return -5;
  }
  advise_huge(rep, (size_t)n_edges * sizeof(I));
  label_pi_cycles(n_edges, pm32, /*pm_stride=*/2, n_threads, rep);
  timer.lap("cycle labels");

  std::vector<uint64_t> merged((n_edges + 63) / 64, 0);
  auto is_merged = [&](I e) -> bool {
    const I r = rep[(i64)(uint32_t)e];
    return (merged[(i64)r >> 6] >> (r & 63)) & 1;
  };
  auto mark_merged = [&](I e) {
    // mark the cycle and its mirror image (the serial mark pass set
    // visited on e and e^1 together for the whole cycle)
    const I r = rep[(i64)(uint32_t)e];
    const I rm = rep[(i64)(uint32_t)(e ^ 1)];
    merged[(i64)r >> 6] |= 1ull << (r & 63);
    merged[(i64)rm >> 6] |= 1ull << (rm & 63);
  };
  // Persistent per-node cursor over the in-arc list (= out-CSR of
  // mirror).  The scan runs to exhaustion on a node's first visit, so
  // revisits (mean ~half of emits at degree ~2) need only the -1
  // sentinel read — not the out_off[mv + 1] bound.  int32 (edge count
  // is < 2^31 on this interface) halves the cursor cache traffic.
  std::vector<I> cursor(n_nodes);
  for (i64 v = 0; v < n_nodes; ++v)
    cursor[v] = out_off[v] < out_off[v + 1] ? (I)out_off[v] : (I)-1;

  i64 pos = 0;
  i64 n_cycles = 0;
  for (i64 e0 = 0; e0 < n_edges; ++e0) {
    if (is_merged((I)e0)) continue;
    mark_merged((I)e0);
    I cur = (I)e0;
    do {
      cycles_out[pos++] = cur;
      const uint64_t pr = pm[(i64)(uint32_t)cur];
      const I mv = (I)(pr >> 32);  // in-arcs at dst[cur]: mv's out slice
      I nxt = (I)(uint32_t)pr;     // pi half; updated by splices below
      i64 c = cursor[mv];
      if (c >= 0) {
        const i64 end = out_off[mv + 1];
        do {
          const I a2 = out_edges[c] ^ (I)1;
          if (!is_merged(a2)) {
            mark_merged(a2);
            const I t = nxt;  // splice: swap pi[cur] <-> pi[a2]
            nxt = pm32[2 * (i64)a2];
            pm32[2 * (i64)cur] = nxt;
            pm32[2 * (i64)a2] = t;
          }
        } while (++c < end);
        cursor[mv] = -1;
      }
      cur = nxt;
    } while (cur != (I)e0);
    cycle_offsets[n_cycles++] = pos;
  }
  timer.lap("splice walk");
  std::free(rep);
  std::free(pm);
  return n_cycles;
}

// ---------------------------------------------------------------------
// Parallel-splice decomposition: the serial Hierholzer rotation walk
// (one dependent DRAM load per emitted arc — the last serial chain of
// the downstream at 60M bases) is replaced by a STRUCTURAL formulation
// whose every heavy pass is thread-parallel:
//
//   1. pairing pi (MT) and per-arc cycle labels rep[] (MT segmented
//      chase; rep = the cycle's minimum arc id);
//   2. cycle PAIRS (a pi-cycle and its mirror image, canonical id
//      pairlabel(e) = min(rep[e], rep[e^1])) are connected exactly where
//      the old walk could splice: at a node v where both have in-arcs.
//      An MT scan over the in-arc lists (out-CSR slices of mirror[v])
//      emits one record per (node, new-pair) encounter; a deterministic
//      Kruskal over the records (node-ascending) picks a spanning forest
//      — one tree edge per pair beyond its component's root, exactly the
//      set of splices the old walk performed, chosen structurally;
//   3. orientation propagation: the root pair emits the orientation
//      containing its minimum arc; a child pair emits the orientation
//      whose record in-arc sits at the same node as the parent's CHOSEN
//      orientation (flipping a record = mapping in-arc a at v to
//      pi[a]^1, an in-arc at mirror(v) of the mirror cycle).  Each tree
//      edge becomes one classic rotation splice: swap pi[aP] <-> pi[aC];
//      all swaps are computed against the pristine pi, then applied
//      sequentially (deterministic);
//   4. emission: the final one-cycle-per-component permutation pi' is
//      cut at "start" arcs (chosen-orientation splitters every
//      LABEL_STEP-th arc id, plus each splice's successors) into pieces
//      chased CONCURRENTLY (W in-flight chains per thread hide the DRAM
//      latency), then stitched by a serial piece walk and an MT widening
//      copy into the output.
//
// Output contract is the same as splice_decompose_impl (one circular
// arc sequence per mirror-connected component, each biedge in exactly
// one orientation); the traversal ORDER differs (golden tests re-pin).
// The python oracle in ops/euler.py follows this spec bit-for-bit.
// gids (nullable): per-arc GLOBAL ids for a component-sliced subgraph
// (ops/euler.py:decompose_break_wcc_part).  The renumbering is
// order-preserving, so every phase except the splitter start set is
// automatically identical to the global run restricted to the slice;
// with gids the splitter test becomes gids[e] % LABEL_STEP == 0, making
// slice outputs EXACT sub-multisets of the global run's cycles (same
// content, same rotation, same relative order).  n_assembled_out
// (nullable) receives the piece-assembled cycle count (the leftover
// splitterless cycles trail it) so slices can be merged by
// (class, first-arc) into the global emission order.
static i64 parsplice_decompose_impl(i64 n_nodes, i64 n_edges,
                                    const int32_t* dst, const int32_t* mirror,
                                    const i64* out_off,
                                    const int32_t* out_edges, i64 n_threads,
                                    i64* cycles_out, i64* cycle_offsets,
                                    const i64* gids = nullptr,
                                    i64* n_assembled_out = nullptr) {
  using I = int32_t;
  (void)dst;  // binode incidence is read via the out-CSR of mirror[v]
  PhaseTimer timer("euler_parsplice");
  const i64 nt = std::max<i64>(1, std::min<i64>(n_threads, 16));

  I* pi = static_cast<I*>(std::malloc((size_t)n_edges * sizeof(I)));
  I* rep = static_cast<I*>(std::malloc((size_t)n_edges * sizeof(I)));
  if (!pi || !rep) {
    std::free(pi);
    std::free(rep);
    return -5;
  }
  advise_huge(pi, (size_t)n_edges * sizeof(I));
  advise_huge(rep, (size_t)n_edges * sizeof(I));
  if (!build_pairing_pi(n_nodes, mirror, out_off, out_edges, n_threads, pi)) {
    std::free(pi);
    std::free(rep);
    return -1;
  }
  timer.lap("A' pairing");
  label_pi_cycles(n_edges, pi, /*pm_stride=*/1, n_threads, rep);
  timer.lap("cycle labels");

  auto pairlabel = [&](I a) -> I {
    const I r1 = rep[(i64)(uint32_t)a];
    const I r2 = rep[(i64)(uint32_t)(a ^ 1)];  // mirror cycle's rep
    return r1 < r2 ? r1 : r2;
  };

  // Default chosen orientation per pair: the cycle containing the pair's
  // minimum arc (bit set at that cycle's rep).  Serial sequential scan.
  const i64 n_words = (n_edges + 63) / 64;
  std::vector<uint64_t> chosen(n_words, 0);
  auto bit_get = [](const std::vector<uint64_t>& b, I e) -> bool {
    return (b[(i64)(uint32_t)e >> 6] >> (e & 63)) & 1;
  };
  auto bit_set = [](std::vector<uint64_t>& b, I e) {
    b[(i64)(uint32_t)e >> 6] |= 1ull << (e & 63);
  };
  auto bit_clear = [](std::vector<uint64_t>& b, I e) {
    b[(i64)(uint32_t)e >> 6] &= ~(1ull << (e & 63));
  };
  for (i64 e = 0; e < n_edges; ++e) {
    if (rep[e] == (I)e) {
      const I pl = pairlabel((I)e);
      if (pl == (I)e) bit_set(chosen, (I)e);
    }
  }
  timer.lap("chosen defaults");

  // Records: one per (node, newly seen pair) beyond the node's first
  // pair, in (node asc, CSR position asc) order.  MT over node ranges;
  // per-thread vectors concatenate back in range order.
  struct Rec {
    I a0, a;    // in-arcs at the same node, in two different pairs
    I pA, pB;   // their pairlabels (carried to skip the Kruskal rescan)
  };
  std::vector<std::vector<Rec>> recs_t(nt);
  {
    std::vector<std::thread> ts;
    const i64 chunk = (n_nodes + nt - 1) / nt;
    auto scan = [&](i64 t, i64 lo, i64 hi) {
      auto& out = recs_t[t];
      I pls[64];  // distinct pairs seen at this node (tiny in practice)
      I arcs[64];
      for (i64 v = lo; v < hi; ++v) {
        const I mv = mirror[v];
        const i64 b = out_off[mv], e = out_off[mv + 1];
        if (e - b < 2) continue;
        // fast path: all in-arcs in one pair
        const I a0 = out_edges[b] ^ (I)1;
        const I pl0 = pairlabel(a0);
        i64 c = b + 1;
        for (; c < e; ++c) {
          if (pairlabel(out_edges[c] ^ (I)1) != pl0) break;
        }
        if (c == e) continue;
        int np = 1;
        pls[0] = pl0;
        arcs[0] = a0;
        for (; c < e; ++c) {
          const I a = out_edges[c] ^ (I)1;
          const I pl = pairlabel(a);
          int j = 0;
          while (j < np && pls[j] != pl) ++j;
          if (j == np) {
            if (np < 64) {
              pls[np] = pl;
              arcs[np] = a;
              ++np;
            }
            out.push_back({a0, a, pl0, pl});
          }
        }
      }
    };
    for (i64 t = 0; t < nt; ++t) {
      const i64 lo = t * chunk;
      if (lo >= n_nodes) break;
      ts.emplace_back(scan, t, lo, std::min(n_nodes, lo + chunk));
    }
    for (auto& th : ts) th.join();
  }
  timer.lap("pair records");

  // Kruskal over the records, on DENSE pair ids: the hash-map DSU the
  // first version used cost 0.7-0.9s at 60M bases (one unordered_map
  // probe per find step); collecting the record pairlabels first,
  // sort+unique, and running an array DSU over their dense indices cuts
  // the phase to sort speed.  Record order (hence the accepted forest)
  // is unchanged.
  std::vector<I> rec_pairs;  // sorted unique pairlabels in any record
  {
    size_t total = 0;
    for (i64 t = 0; t < nt; ++t) total += recs_t[t].size();
    rec_pairs.reserve(total * 2);
  }
  for (i64 t = 0; t < nt; ++t)
    for (const Rec& r : recs_t[t]) {
      rec_pairs.push_back(r.pA);
      rec_pairs.push_back(r.pB);
    }
  std::sort(rec_pairs.begin(), rec_pairs.end());
  rec_pairs.erase(std::unique(rec_pairs.begin(), rec_pairs.end()),
                  rec_pairs.end());
  const i64 n_rp = (i64)rec_pairs.size();
  auto dense_id = [&](I p) -> i64 {
    return std::lower_bound(rec_pairs.begin(), rec_pairs.end(), p) -
           rec_pairs.begin();
  };
  std::vector<I> parent(n_rp);
  for (i64 i = 0; i < n_rp; ++i) parent[i] = (I)i;
  auto find = [&](I x) -> I {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  struct Edge {
    I a0, a;    // record arcs (a0 in pair d0, a in pair d)
    I d0, d;    // dense pair ids
  };
  std::vector<Edge> tree;
  for (i64 t = 0; t < nt; ++t) {
    for (const Rec& r : recs_t[t]) {
      const I dA = (I)dense_id(r.pA), dB = (I)dense_id(r.pB);
      const I fa = find(dA), fb = find(dB);
      if (fa != fb) {
        parent[fa] = fb;
        tree.push_back({r.a0, r.a, dA, dB});
      }
    }
    recs_t[t].clear();
    recs_t[t].shrink_to_fit();
  }
  timer.lap("kruskal");

  // Roots: min pairlabel per DSU class = first dense id hitting the
  // class (dense ids ascend with pairlabel).
  std::vector<I> root_of(n_rp, (I)-1);  // find-class -> root dense id
  std::vector<I> roots;                 // root dense ids, ascending
  for (i64 d = 0; d < n_rp; ++d) {
    const I f = find((I)d);
    if (root_of[f] == (I)-1) {
      root_of[f] = (I)d;
      roots.push_back((I)d);
    }
  }

  // BFS orientation propagation + splice list (against pristine pi).
  // Tree adjacency as CSR over dense pair ids (was per-pair hash-map
  // vectors).
  std::vector<int> adj_off(n_rp + 1, 0);
  for (const Edge& e : tree) {
    ++adj_off[e.d0 + 1];
    ++adj_off[e.d + 1];
  }
  for (i64 d = 0; d < n_rp; ++d) adj_off[d + 1] += adj_off[d];
  std::vector<int> adj_edges(tree.size() * 2);
  {
    std::vector<int> cur(adj_off.begin(), adj_off.end() - 1);
    for (size_t i = 0; i < tree.size(); ++i) {
      adj_edges[cur[tree[i].d0]++] = (int)i;
      adj_edges[cur[tree[i].d]++] = (int)i;
    }
  }
  std::vector<uint64_t> has_start(n_words, 0);
  struct Swap {
    I x, y;
  };
  std::vector<Swap> swaps;
  swaps.reserve(tree.size());
  {
    std::vector<char> visited(n_rp, 0);
    std::vector<I> queue;
    for (I r0 : roots) {
      if (visited[r0]) continue;
      visited[r0] = 1;
      queue.clear();
      queue.push_back(r0);
      for (size_t qi = 0; qi < queue.size(); ++qi) {
        const I P = queue[qi];
        for (int ai = adj_off[P]; ai < adj_off[P + 1]; ++ai) {
          const int ei = adj_edges[ai];
          const Edge& ed = tree[ei];
          const I C = ed.d0 == P ? ed.d : ed.d0;
          if (visited[C]) continue;
          visited[C] = 1;
          I aP = ed.d0 == P ? ed.a0 : ed.a;
          I aC = ed.d0 == P ? ed.a : ed.a0;
          if (!bit_get(chosen, rep[(i64)(uint32_t)aP])) {
            // flip the record to the mirror node's representations
            aP = pi[(i64)(uint32_t)aP] ^ (I)1;
            aC = pi[(i64)(uint32_t)aC] ^ (I)1;
            if (!bit_get(chosen, rep[(i64)(uint32_t)aP])) {
              std::free(pi);
              std::free(rep);
              return -4;  // parent orientation invariant broken
            }
          }
          const I rC = rep[(i64)(uint32_t)aC];
          bit_set(chosen, rC);
          bit_clear(chosen, rep[(i64)(uint32_t)(aC ^ 1)]);
          bit_set(has_start, rep[(i64)(uint32_t)aP]);
          bit_set(has_start, rC);
          swaps.push_back({aP, aC});
          queue.push_back(C);
        }
      }
    }
  }
  // Apply the splices sequentially (order = BFS generation order).
  for (const Swap& s : swaps) {
    const I t = pi[(i64)(uint32_t)s.x];
    pi[(i64)(uint32_t)s.x] = pi[(i64)(uint32_t)s.y];
    pi[(i64)(uint32_t)s.y] = t;
  }
  timer.lap("forest + splices");

  // Start set: chosen-orientation splitters + each splice's successors.
  std::vector<uint64_t> sset(n_words, 0);
  if (gids == nullptr) {
    for (i64 e = 0; e < n_edges; e += LABEL_STEP) {
      const I r = rep[e];
      if (bit_get(chosen, r)) {
        bit_set(sset, (I)e);
        bit_set(has_start, r);
      }
    }
  } else {
    // component slice: splitters are the arcs whose GLOBAL id is a
    // LABEL_STEP multiple (LABEL_STEP is a power of two)
    for (i64 e = 0; e < n_edges; ++e) {
      if (gids[e] & (LABEL_STEP - 1)) continue;
      const I r = rep[e];
      if (bit_get(chosen, r)) {
        bit_set(sset, (I)e);
        bit_set(has_start, r);
      }
    }
  }
  for (const Swap& s : swaps) {
    bit_set(sset, pi[(i64)(uint32_t)s.x]);
    bit_set(sset, pi[(i64)(uint32_t)s.y]);
  }
  std::vector<I> starts;
  starts.reserve(n_edges / LABEL_STEP + 2 * swaps.size() + 1);
  for (i64 w = 0; w < n_words; ++w) {
    uint64_t bits = sset[w];
    while (bits) {
      const int b = __builtin_ctzll(bits);
      bits &= bits - 1;
      starts.push_back((I)(w * 64 + b));
    }
  }
  const i64 n_starts = (i64)starts.size();
  timer.lap("start set");

  // MT piece chase: follow pi' from each start until the next start,
  // writing the arc sequence into a per-thread arena.  W in-flight
  // chains per thread hide the dependent-load latency.
  struct Piece {
    I next_start;
    const I* src;
    i64 len;
    i64 dst;  // filled by the assembly walk
  };
  std::vector<Piece> pieces(n_starts);
  std::vector<std::vector<I>> arena_t(nt);
  {
    constexpr int W = 16;
    std::vector<std::thread> ts;
    const i64 chunk = (n_starts + nt - 1) / nt;
    auto chase = [&](i64 t, i64 lo, i64 hi) {
      auto& arena = arena_t[t];
      arena.reserve((size_t)((n_edges / 2) / nt + (hi - lo) * 4 + 64));
      // chain slots: piece index, current arc
      i64 slot_p[W];
      I slot_cur[W];
      std::vector<std::vector<I>> bufs(W);
      int live = 0;
      i64 next_i = lo;
      auto refill = [&] {
        while (live < W && next_i < hi) {
          slot_p[live] = next_i;
          slot_cur[live] = starts[next_i];
          bufs[live].clear();
          bufs[live].push_back(starts[next_i]);
          ++live;
          ++next_i;
        }
      };
      refill();
      while (live) {
        for (int w = 0; w < live;) {
          const I nxt = pi[(i64)(uint32_t)slot_cur[w]];
          if ((sset[(i64)(uint32_t)nxt >> 6] >> (nxt & 63)) & 1) {
            // piece done: flush to the arena
            Piece& pc = pieces[slot_p[w]];
            pc.next_start = nxt;
            pc.len = (i64)bufs[w].size();
            const size_t at = arena.size();
            arena.insert(arena.end(), bufs[w].begin(), bufs[w].end());
            pc.src = arena.data() + at;  // arena may realloc: fix below
            pc.dst = at;                 // stash arena offset in dst
            std::swap(bufs[w], bufs[live - 1]);
            slot_p[w] = slot_p[live - 1];
            slot_cur[w] = slot_cur[live - 1];
            --live;
            refill();
          } else {
            bufs[w].push_back(nxt);
            slot_cur[w] = nxt;
            ++w;
          }
        }
      }
      // re-base src pointers now that the arena is final
      for (i64 i = lo; i < std::min(hi, n_starts); ++i)
        pieces[i].src = arena.data() + pieces[i].dst;
    };
    for (i64 t = 0; t < nt; ++t) {
      const i64 lo = t * chunk;
      if (lo >= n_starts) break;
      ts.emplace_back(chase, t, lo, std::min(n_starts, lo + chunk));
    }
    for (auto& th : ts) th.join();
  }
  timer.lap("piece chase");

  // Serial assembly: order pieces along each component cycle (ascending
  // first-start order), assigning destination offsets.
  i64 pos = 0;
  i64 n_cycles = 0;
  {
    std::vector<char> piece_done(n_starts, 0);
    auto piece_of = [&](I s) -> i64 {
      // starts[] is ascending: binary search
      i64 lo = 0, hi = n_starts - 1;
      while (lo < hi) {
        const i64 mid = (lo + hi) >> 1;
        if (starts[mid] < s)
          lo = mid + 1;
        else
          hi = mid;
      }
      return lo;
    };
    for (i64 i = 0; i < n_starts; ++i) {
      if (piece_done[i]) continue;
      i64 j = i;
      do {
        piece_done[j] = 1;
        pieces[j].dst = pos;
        pos += pieces[j].len;
        j = piece_of(pieces[j].next_start);
      } while (j != i);
      cycle_offsets[n_cycles++] = pos;
    }
  }
  timer.lap("assembly");

  // MT widening copy of the pieces into the output.
  {
    std::vector<std::thread> ts;
    const i64 chunk = (n_starts + nt - 1) / nt;
    auto copy = [&](i64 lo, i64 hi) {
      for (i64 i = lo; i < hi; ++i) {
        const Piece& pc = pieces[i];
        i64* out = cycles_out + pc.dst;
        for (i64 t = 0; t < pc.len; ++t) out[t] = (i64)pc.src[t];
      }
    };
    for (i64 t = 0; t < nt; ++t) {
      const i64 lo = t * chunk;
      if (lo >= n_starts) break;
      ts.emplace_back(copy, lo, std::min(n_starts, lo + chunk));
    }
    for (auto& th : ts) th.join();
  }
  timer.lap("widening copy");
  if (n_assembled_out) *n_assembled_out = n_cycles;

  // Leftovers: singleton splitterless pairs (no start anywhere in their
  // component) — chase serially from the chosen rep.  Ascending rep
  // order; appended after the piece-assembled cycles.
  for (i64 w = 0; w < n_words; ++w) {
    uint64_t bits = chosen[w] & ~has_start[w];
    while (bits) {
      const int b = __builtin_ctzll(bits);
      bits &= bits - 1;
      const I r = (I)(w * 64 + b);
      I cur = r;
      do {
        cycles_out[pos++] = (i64)cur;
        cur = pi[(i64)(uint32_t)cur];
      } while (cur != r);
      cycle_offsets[n_cycles++] = pos;
    }
  }
  timer.lap("leftovers");

  std::free(pi);
  std::free(rep);
  if (pos != n_edges / 2) return -3;  // every biedge exactly once
  return n_cycles;
}
}

extern "C" {

// Follow functional chains: next[i] = unique successor or -1.
// starts[]: chain heads.  Emits the concatenated chain node lists into
// order_out (capacity n) and per-chain end offsets into offsets_out
// (capacity n_chains).  Returns number of chains emitted.
i64 follow_chains(i64 n, const i64* next, i64 n_starts, const i64* starts,
                  i64* order_out, i64* offsets_out) {
  std::vector<char> visited(n, 0);
  i64 pos = 0;
  i64 chains = 0;
  for (i64 s = 0; s < n_starts; ++s) {
    i64 u = starts[s];
    if (visited[u]) continue;
    while (u >= 0 && !visited[u]) {
      visited[u] = 1;
      order_out[pos++] = u;
      u = next[u];
    }
    offsets_out[chains++] = pos;
  }
  // isolated cycles (every node internal)
  for (i64 u0 = 0; u0 < n; ++u0) {
    if (visited[u0]) continue;
    i64 u = u0;
    while (u >= 0 && !visited[u]) {
      visited[u] = 1;
      order_out[pos++] = u;
      u = next[u];
    }
    offsets_out[chains++] = pos;
  }
  return chains;
}

// Eulerian bicycle decomposition of a balanced bidirected graph.
//
// Edges come in mirror pairs (mirror(e) == e ^ 1); traversing an edge
// consumes its mirror.  Hierholzer subtours (guaranteed closed on balanced
// graphs) are spliced into one bicycle per mirror-connected component via
// O(1) circular successor swaps at shared nodes (occ[] holds, per node, an
// edge of a merged cycle ending there).  Mirror-side sharing is handled by
// flipping a subtour to its mirror representation (reverse + ^1).
//
// Inputs: n_edges E, edge endpoints src/dst (int64 [E]), mirror_node
// (int64 [N]), out-CSR (out_off int64 [N+1], out_edges int64 [E] sorted by
// src).  Outputs: cycles_out (capacity E) receives concatenated cycle edge
// lists, cycle_offsets (capacity E) the per-cycle end offsets.  Returns
// the number of cycles, or -1 if an open walk was found (graph not
// balanced).
i64 euler_decompose(i64 n_nodes, i64 n_edges, const i64* src, const i64* dst,
                    const i64* mirror_node, const i64* out_off,
                    const i64* out_edges, i64* cycles_out,
                    i64* cycle_offsets) {
  if (n_edges < (i64)INT32_MAX - 1 && n_nodes < (i64)INT32_MAX - 1)
    return euler_decompose_impl<int32_t>(n_nodes, n_edges, src, dst,
                                         mirror_node, out_off, out_edges,
                                         cycles_out, cycle_offsets);
  return euler_decompose_impl<i64>(n_nodes, n_edges, src, dst, mirror_node,
                                   out_off, out_edges, cycles_out,
                                   cycle_offsets);
}

// Pairing-based Eulerian bicycle decomposition (the default production
// path; euler_decompose above is the Hierholzer variant kept for
// comparison/regression).  Takes the graph's native int32 arrays
// directly -- no int64 conversion copies on either side.  Requires
// n_edges < 2^31.  Returns like euler_decompose (-1 = unbalanced).
i64 euler_decompose_pairing(i64 n_nodes, i64 n_edges, const int32_t* dst,
                            const int32_t* mirror_node, const i64* out_off,
                            const int32_t* out_edges, i64 n_threads,
                            i64* cycles_out, i64* cycle_offsets) {
  if (n_edges >= (i64)INT32_MAX - 1 || n_nodes >= (i64)INT32_MAX - 1)
    return -4;  // int32 interface ceiling
  return pairing_decompose_impl(n_nodes, n_edges, dst, mirror_node, out_off,
                                out_edges, n_threads < 1 ? 1 : n_threads,
                                cycles_out, cycle_offsets);
}

// Splice decomposition (pairing pi + one merged Hierholzer-rotation walk
// per component; see splice_decompose_impl).  Same interface/returns as
// euler_decompose_pairing.
i64 euler_decompose_splice(i64 n_nodes, i64 n_edges, const int32_t* dst,
                           const int32_t* mirror_node, const i64* out_off,
                           const int32_t* out_edges, i64 n_threads,
                           i64* cycles_out, i64* cycle_offsets) {
  if (n_edges >= (i64)INT32_MAX - 1 || n_nodes >= (i64)INT32_MAX - 1)
    return -4;  // int32 interface ceiling
  return splice_decompose_impl(n_nodes, n_edges, dst, mirror_node, out_off,
                               out_edges, n_threads < 1 ? 1 : n_threads,
                               cycles_out, cycle_offsets);
}

// Parallel-splice decomposition (see parsplice_decompose_impl): same
// contract as euler_decompose_splice, every heavy pass thread-parallel;
// traversal order differs (structural spanning-forest splices + piece
// emission).  -2 impossible; -3 = internal coverage error; -4 = int32
// ceiling or orientation invariant broken; -5 = alloc failure.
i64 euler_decompose_parsplice(i64 n_nodes, i64 n_edges, const int32_t* dst,
                              const int32_t* mirror_node, const i64* out_off,
                              const int32_t* out_edges, i64 n_threads,
                              i64* cycles_out, i64* cycle_offsets) {
  if (n_edges >= (i64)INT32_MAX - 1 || n_nodes >= (i64)INT32_MAX - 1)
    return -4;  // int32 interface ceiling
  return parsplice_decompose_impl(n_nodes, n_edges, dst, mirror_node, out_off,
                                  out_edges, n_threads < 1 ? 1 : n_threads,
                                  cycles_out, cycle_offsets);
}

// Parsplice over a component-sliced subgraph carrying global arc ids
// (gids, int64 [E] ascending; see parsplice_decompose_impl).  Emits
// LOCAL arc ids; n_assembled_out gets the piece-assembled cycle count
// (the splitterless leftovers trail).  Used by the per-WCC distributed
// euler+break (ops/euler.py): merging slice cycles by (class,
// first-arc-gid) reproduces the global emission order exactly.
i64 euler_decompose_parsplice_gids(i64 n_nodes, i64 n_edges,
                                   const int32_t* dst,
                                   const int32_t* mirror_node,
                                   const i64* out_off,
                                   const int32_t* out_edges, i64 n_threads,
                                   const i64* gids, i64* cycles_out,
                                   i64* cycle_offsets,
                                   i64* n_assembled_out) {
  if (n_edges >= (i64)INT32_MAX - 1 || n_nodes >= (i64)INT32_MAX - 1)
    return -4;  // int32 interface ceiling
  return parsplice_decompose_impl(n_nodes, n_edges, dst, mirror_node, out_off,
                                  out_edges, n_threads < 1 ? 1 : n_threads,
                                  cycles_out, cycle_offsets, gids,
                                  n_assembled_out);
}

// Maximal edge-disjoint biwalk cover (pathtigs).  Walks are extended
// forward from their end and backward from their start; traversing an
// edge consumes its mirror.  Outputs like euler_decompose.  in-CSR:
// in_off int64 [N+1], in_edges int64 [E] sorted by dst.
i64 biwalk_cover(i64 n_nodes, i64 n_edges, const i64* src, const i64* dst,
                 const i64* out_off, const i64* out_edges, const i64* in_off,
                 const i64* in_edges, i64* walks_out, i64* walk_offsets) {
  std::vector<char> used(n_edges, 0);
  std::vector<i64> out_cursor(out_off, out_off + n_nodes);
  std::vector<i64> in_cursor(in_off, in_off + n_nodes);
  std::vector<i64> fwd, bwd;

  auto next_unused_out = [&](i64 v) -> i64 {
    i64 c = out_cursor[v];
    i64 end = out_off[v + 1];
    while (c < end && used[out_edges[c]]) ++c;
    out_cursor[v] = c;
    return c < end ? out_edges[c] : -1;
  };
  auto next_unused_in = [&](i64 v) -> i64 {
    i64 c = in_cursor[v];
    i64 end = in_off[v + 1];
    while (c < end && used[in_edges[c]]) ++c;
    in_cursor[v] = c;
    return c < end ? in_edges[c] : -1;
  };

  i64 pos = 0;
  i64 n_walks = 0;
  for (i64 e0 = 0; e0 < n_edges; ++e0) {
    if (used[e0]) continue;
    used[e0] = 1;
    used[e0 ^ 1] = 1;
    fwd.clear();
    bwd.clear();
    fwd.push_back(e0);
    i64 cur = dst[e0];
    for (;;) {
      i64 e = next_unused_out(cur);
      if (e < 0) break;
      used[e] = 1;
      used[e ^ 1] = 1;
      fwd.push_back(e);
      cur = dst[e];
    }
    cur = src[e0];
    for (;;) {
      i64 e = next_unused_in(cur);
      if (e < 0) break;
      used[e] = 1;
      used[e ^ 1] = 1;
      bwd.push_back(e);
      cur = src[e];
    }
    for (auto it = bwd.rbegin(); it != bwd.rend(); ++it) walks_out[pos++] = *it;
    for (i64 e : fwd) walks_out[pos++] = e;
    walk_offsets[n_walks++] = pos;
  }
  return n_walks;
}

// Deterministic breaking-edge balancer
// (make_graph_eulerian_with_breaking_edges,
// /root/reference/src/implementation/mod.rs:392-649).  Orders replicate
// the reference's BTreeMap iteration: self-mirror odd nodes paired in
// ascending scan order (odd leftover consumes the smallest in-node),
// then out-nodes in DESCENDING node order x in-nodes ASCENDING with the
// choose_in_node_from_iterator skip rules.  diff[]: per-node imbalance
// (self-mirror parity included); mirror[]: mirror node map.
// pairs_out: capacity >= n entries of (out_node, in_node); returns the
// number of pairs, or -1 on inconsistency.
i64 balance_breaking_edges(i64 n_nodes, const i64* diff, const i64* mirror,
                           i64* pairs_out, i64 pairs_capacity) {
  // The reference's BTreeMap orders (out-nodes descending x in-nodes
  // ascending) over mutable diffs.  The key sets never GROW after the
  // init scan (all adjustments move diffs toward zero or erase), so
  // sorted arrays + path-compressed alive-skip links reproduce the exact
  // iteration order in O(n + emissions) -- the std::map version cost 51s
  // at 10M unbalanced nodes.
  std::vector<i64> out_keys, in_keys, self_mirror_odd;
  std::vector<i64> val(n_nodes, 0);  // current diff per participating node
  for (i64 v = 0; v < n_nodes; ++v) {
    if (mirror[v] == v) {
      if (diff[v] != 0) self_mirror_odd.push_back(v);
    } else if (diff[v] < 0) {
      out_keys.push_back(v);
      val[v] = diff[v];
    } else if (diff[v] > 0) {
      in_keys.push_back(v);
      val[v] = diff[v];
    }
  }
  // Alive-skip links with path compression: in-list forward (ascending
  // order), out-list backward (descending order).  `val` holds the live
  // diff; 0 = dead entry.
  const i64 n_in = (i64)in_keys.size(), n_out = (i64)out_keys.size();
  std::vector<i64> in_next(n_in, 0), out_prev(n_out, 0);
  for (i64 j = 0; j < n_in; ++j) in_next[j] = j;
  for (i64 j = 0; j < n_out; ++j) out_prev[j] = j;
  // first alive in-index >= j (n_in if none)
  auto in_first = [&](i64 j) -> i64 {
    i64 r = j;
    while (r < n_in && val[in_keys[r]] == 0)
      r = std::max(r + 1, in_next[r]);
    while (j < n_in && j < r) {  // compress the skipped chain
      i64 nj = std::max(j + 1, in_next[j]);
      in_next[j] = r;
      j = nj;
    }
    return r;
  };
  // last alive out-index <= j (-1 if none)
  auto out_last = [&](i64 j) -> i64 {
    i64 r = j;
    while (r >= 0 && val[out_keys[r]] == 0)
      r = std::min(r - 1, out_prev[r]);
    while (j >= 0 && j > r) {
      i64 pj = std::min(j - 1, out_prev[j]);
      out_prev[j] = std::max(r, (i64)0);
      j = pj;
    }
    return r;
  };

  i64 n_pairs = 0;
  bool overflow = false;
  auto emit = [&](i64 out_node, i64 in_node) {
    if (n_pairs >= pairs_capacity) {  // total imbalance bounds pairs by
      overflow = true;                // edge count, not node count
      return;
    }
    pairs_out[2 * n_pairs] = out_node;
    pairs_out[2 * n_pairs + 1] = in_node;
    ++n_pairs;
  };

  i64 in_lo = 0;           // ascending cursor into in_keys
  i64 out_hi = n_out - 1;  // descending cursor into out_keys

  // Phase 1: pair unbalanced self-mirrors in scan order.
  size_t i = 0;
  for (; i + 1 < self_mirror_odd.size(); i += 2)
    emit(self_mirror_odd[i], self_mirror_odd[i + 1]);
  if (i < self_mirror_odd.size()) {
    in_lo = in_first(in_lo);
    if (in_lo >= n_in) return -1;
    i64 in_node = in_keys[in_lo];
    emit(self_mirror_odd[i], in_node);
    i64 mo = mirror[in_node];
    if (--val[in_node] == 0) {
      val[mo] = 0;  // the map version erased the mirror entry outright
    } else {
      if (val[mo] != 0) val[mo] += 1;
    }
  }

  // Phase 2: out-nodes descending x in-nodes ascending.
  for (;;) {
    out_hi = out_last(out_hi);
    if (out_hi < 0) break;
    i64 out_node = out_keys[out_hi];
    i64 d_out = val[out_node];
    in_lo = in_first(in_lo);
    if (in_lo >= n_in) return -1;
    i64 in_node = in_keys[in_lo];
    // choose_in_node_from_iterator skip rules
    if ((in_node == mirror[out_node] && d_out > -2) || in_node == out_node) {
      i64 second = in_first(in_lo + 1);
      if (second >= n_in) return -1;
      in_node = in_keys[second];
    }
    emit(out_node, in_node);

    val[out_node] += 1;
    val[in_node] -= 1;

    i64 mirror_out = mirror[in_node];
    i64 mirror_in = mirror[out_node];
    if (val[mirror_out] < 0) val[mirror_out] += 1;  // alive out entry
    if (val[mirror_in] > 0) val[mirror_in] -= 1;    // alive in entry
  }
  if (overflow) return -2;  // caller must grow pairs_out and retry
  if (in_first(in_lo) < n_in) return -1;
  return n_pairs;
}
}

// Rotate each bicycle so its longest dummy leads, then break at breaking
// dummies (weight >= k) and at the position-0 dummy; emit flat tig edge
// lists.  Faithful to the python break_cycles (ops/euler.py), which is
// the oracle (/root/reference/src/implementation/eulertigs/mod.rs:126-186
// semantics); the python loop's per-cycle gathers + rolls + ~1M slice
// objects cost ~2s at a 19M-edge bicycle.
// cycles: flat edge ids + per-cycle end offsets (the decomposition's
// output format).  Returns the tig count; tigs_out (capacity n_edges)
// and tig_offsets (capacity n_edges) receive flat tigs + end offsets.
static i64 break_cycles_flat_impl(i64 n_cycles, const i64* cycles,
                                  const i64* cycle_off, const i64* weights,
                                  const signed char* is_dummy, i64 k,
                                  i64* tigs_out, i64* tig_offsets,
                                  i64* tig_cycle_out, i64 n_threads = 1,
                                  i64 big_threshold = 0) {
  const i64 nt = std::max<i64>(1, std::min<i64>(n_threads, 16));
  // A cycle at least this long gets intra-cycle MT (argmax reduce +
  // break-position collection + per-segment copies); the 60M greedy
  // graph is ONE 20.7M-arc bicycle, so per-cycle parallelism alone
  // parallelizes nothing there.  Small cycles keep the sequential walk.
  // Parity tests pass a tiny threshold to force the MT path.
  const i64 BIG = big_threshold > 0 ? big_threshold : i64(1) << 21;
  i64 pos = 0;
  i64 n_tigs = 0;
  for (i64 c = 0; c < n_cycles; ++c) {
    const i64 lo = c == 0 ? 0 : cycle_off[c - 1];
    const i64 hi = cycle_off[c];
    const i64 len = hi - lo;
    if (len <= 0) continue;
    if (nt > 1 && len >= BIG) {
      // -- MT rotation argmax: first index attaining the max dummy weight
      std::vector<i64> t_best(nt, 0), t_rot(nt, -1);
      std::vector<std::thread> ts;
      const i64 chunk = (len + nt - 1) / nt;
      for (i64 t = 0; t < nt; ++t) {
        const i64 a = lo + t * chunk;
        if (a >= hi) break;
        ts.emplace_back([&, t, a] {
          const i64 b = std::min(hi, a + chunk);
          i64 best = 0, rot = -1;
          for (i64 i = a; i < b; ++i) {
            const i64 e = cycles[i];
            if (is_dummy[e] && weights[e] > best) {
              best = weights[e];
              rot = i - lo;
            }
          }
          t_best[t] = best;
          t_rot[t] = rot;
        });
      }
      for (auto& th : ts) th.join();
      ts.clear();
      i64 best = 0, rot = 0;
      for (i64 t = 0; t < nt; ++t)  // ascending: first chunk wins ties
        if (t_rot[t] >= 0 && t_best[t] > best) {
          best = t_best[t];
          rot = t_rot[t];
        }
      // rotated index j -> flat position without modulo
      const i64 split = len - rot;  // j < split: lo+rot+j, else lo+j-split
      auto arc_at = [&](i64 j) -> i64 {
        return cycles[j < split ? lo + rot + j : lo + j - split];
      };
      // -- MT break-position collection (rotated coordinates, ascending)
      std::vector<std::vector<i64>> bp_t(nt);
      for (i64 t = 0; t < nt; ++t) {
        const i64 a = t * chunk;
        if (a >= len) break;
        ts.emplace_back([&, t, a] {
          const i64 b = std::min(len, a + chunk);
          auto& out = bp_t[t];
          for (i64 j = a; j < b; ++j) {
            const i64 e = arc_at(j);
            if (is_dummy[e] && weights[e] >= k) out.push_back(j);
          }
        });
      }
      for (auto& th : ts) th.join();
      ts.clear();
      std::vector<i64> bpos;
      for (i64 t = 0; t < nt; ++t)
        bpos.insert(bpos.end(), bp_t[t].begin(), bp_t[t].end());
      // j == 0 breaks iff the rotation arc is a dummy (any weight)
      if (is_dummy[arc_at(0)] && (bpos.empty() || bpos[0] != 0))
        bpos.insert(bpos.begin(), 0);
      // segments between breaks + the oracle's trailing-dummy tail rule
      std::vector<i64> seg_st, seg_en;
      seg_st.reserve(bpos.size() + 1);
      seg_en.reserve(bpos.size() + 1);
      i64 st = 0;
      for (i64 b : bpos) {
        seg_st.push_back(st);
        seg_en.push_back(b);
        st = b + 1;
      }
      seg_st.push_back(st);
      seg_en.push_back(len);
      if (seg_st.back() < len && is_dummy[arc_at(len - 1)])
        seg_en.back() = len - 1;
      // keep non-empty segments; absolute output offsets by prefix sum
      std::vector<i64> k_st, k_en, k_dst;
      k_st.reserve(seg_st.size());
      k_en.reserve(seg_st.size());
      k_dst.reserve(seg_st.size());
      for (size_t i = 0; i < seg_st.size(); ++i)
        if (seg_st[i] < seg_en[i]) {
          k_st.push_back(seg_st[i]);
          k_en.push_back(seg_en[i]);
          k_dst.push_back(pos);
          pos += seg_en[i] - seg_st[i];
        }
      const i64 n_seg = (i64)k_st.size();
      for (i64 i = 0; i < n_seg; ++i) {
        if (tig_cycle_out) tig_cycle_out[n_tigs] = c;
        tig_offsets[n_tigs++] = k_dst[i] + (k_en[i] - k_st[i]);
      }
      // -- MT segment copies (two linear spans per segment)
      const i64 seg_chunk = (n_seg + nt - 1) / nt;
      for (i64 t = 0; t < nt; ++t) {
        const i64 a = t * seg_chunk;
        if (a >= n_seg) break;
        ts.emplace_back([&, a] {
          const i64 b = std::min(n_seg, a + seg_chunk);
          for (i64 i = a; i < b; ++i) {
            i64* out = tigs_out + k_dst[i];
            for (i64 j = k_st[i]; j < k_en[i]; ++j) *out++ = arc_at(j);
          }
        });
      }
      for (auto& th : ts) th.join();
      continue;
    }
    // rotation start: first index attaining the max dummy weight
    i64 rot = 0;
    i64 best = 0;
    for (i64 i = lo; i < hi; ++i) {
      const i64 e = cycles[i];
      if (is_dummy[e] && weights[e] > best) {
        best = weights[e];
        rot = i - lo;
      }
    }
    // walk the rotated cycle, emitting segments between breaks
    i64 start = -1;  // current tig start (rotated index), -1 = none
    for (i64 j = 0; j < len; ++j) {
      const i64 e = cycles[lo + (rot + j) % len];
      const bool dummy = is_dummy[e] != 0;
      const bool brk = dummy && (weights[e] >= k || j == 0);
      if (brk) {
        if (start >= 0) {
          if (tig_cycle_out) tig_cycle_out[n_tigs] = c;
          tig_offsets[n_tigs++] = pos;
          start = -1;
        }
        continue;
      }
      if (dummy && j == len - 1) continue;  // trailing non-breaking dummy
      if (start < 0) start = j;
      tigs_out[pos++] = e;
    }
    if (start >= 0) {
      if (tig_cycle_out) tig_cycle_out[n_tigs] = c;
      tig_offsets[n_tigs++] = pos;
    }
  }
  return n_tigs;
}

extern "C" i64 break_cycles_flat(i64 n_cycles, const i64* cycles,
                                 const i64* cycle_off, const i64* weights,
                                 const signed char* is_dummy, i64 k,
                                 i64* tigs_out, i64* tig_offsets) {
  return break_cycles_flat_impl(n_cycles, cycles, cycle_off, weights,
                                is_dummy, k, tigs_out, tig_offsets, nullptr);
}

// break_cycles_flat + per-tig source-cycle index (tig_cycle_out,
// capacity n_edges): the per-WCC distributed euler+break
// (ops/euler.py:decompose_break_wcc_part) keys each tig by its cycle's
// global merge key so slice outputs interleave into the exact
// single-host tig order.
extern "C" i64 break_cycles_flat_cyc(i64 n_cycles, const i64* cycles,
                                     const i64* cycle_off, const i64* weights,
                                     const signed char* is_dummy, i64 k,
                                     i64* tigs_out, i64* tig_offsets,
                                     i64* tig_cycle_out) {
  return break_cycles_flat_impl(n_cycles, cycles, cycle_off, weights,
                                is_dummy, k, tigs_out, tig_offsets,
                                tig_cycle_out);
}

// break_cycles_flat with intra-cycle MT for big cycles (the 60M greedy
// graph is one 20.7M-arc bicycle, so per-cycle parallelism alone cannot
// help): MT rotation argmax, MT break-position collection, MT
// per-segment copies.  tig_cycle_out may be NULL.
extern "C" i64 break_cycles_flat_mt(i64 n_cycles, const i64* cycles,
                                    const i64* cycle_off, const i64* weights,
                                    const signed char* is_dummy, i64 k,
                                    i64 n_threads, i64* tigs_out,
                                    i64* tig_offsets, i64* tig_cycle_out,
                                    i64 big_threshold) {
  return break_cycles_flat_impl(n_cycles, cycles, cycle_off, weights,
                                is_dummy, k, tigs_out, tig_offsets,
                                tig_cycle_out, n_threads, big_threshold);
}

// Union-find connected-component labels over an undirected edge list.
// Replaces scipy.sparse.csgraph.connected_components in the matching
// reduction (coo_matrix construction + BFS cost ~7s over 19M edges at
// the 60M-base scale; this is ~0.5s).  Labels are 0..n_comps-1 in order
// of first appearance by node id (same contract as scipy's labels up to
// a permutation; callers only use label equality).  Returns n_comps.
extern "C" i64 wcc_labels(i64 n_nodes, i64 n_edges, const int32_t* src,
                          const int32_t* dst, int32_t* labels_out) {
  std::vector<int32_t> parent(n_nodes);
  for (i64 v = 0; v < n_nodes; ++v) parent[v] = (int32_t)v;
  auto find = [&](int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];  // path halving
      x = parent[x];
    }
    return x;
  };
  for (i64 e = 0; e < n_edges; ++e) {
    int32_t a = find(src[e]), b = find(dst[e]);
    if (a != b) parent[a < b ? b : a] = a < b ? a : b;
  }
  i64 n_comps = 0;
  for (i64 v = 0; v < n_nodes; ++v) {
    if (parent[v] == (int32_t)v)
      labels_out[v] = (int32_t)n_comps++;
    else
      labels_out[v] = labels_out[find((int32_t)v)];
  }
  return n_comps;
}

// MT padded-adjacency fill for the device graph (ops/device_graph.py):
// nbr[v*deg_pad + j] = j-th successor of v in EDGE-ID ORDER (matching the
// stable-sort semantics of the python path), nw likewise; empty slots get
// (sentinel = n_nodes, weight_cap).  Threads own disjoint NODE ranges and
// each scans the full edge list, so slot order is deterministic and no
// atomics are needed; the scans are sequential reads (~8B/edge/thread)
// and the fills are range-local writes.  Replaces a bincount +
// stable-sort + np.repeat + two random-row scatters (~1.7s at 15.7M
// edges / 10.2M nodes -> ~0.2s).
extern "C" i64 fill_padded_adj(i64 n_nodes, i64 n_edges, const int32_t* src,
                               const int32_t* dst, const i64* weight,
                               i64 deg_pad, i64 weight_cap, i64 n_threads,
                               int32_t* nbr_out, int32_t* nw_out) {
  const int32_t sent_node = (int32_t)n_nodes;
  const int32_t sent_w = (int32_t)weight_cap;
  const i64 nt = std::max<i64>(1, std::min<i64>(n_threads, 16));
  std::atomic<i64> overflow{0};
  auto fill = [&](i64 lo, i64 hi) {  // node range [lo, hi)
    std::vector<int32_t> cursor((size_t)(hi - lo), 0);
    for (i64 e = 0; e < n_edges; ++e) {
      const i64 v = src[e];
      if (v < lo || v >= hi) continue;
      int32_t& c = cursor[(size_t)(v - lo)];
      if (c >= deg_pad) {
        overflow.fetch_add(1, std::memory_order_relaxed);
        continue;
      }
      const i64 slot = v * deg_pad + c;
      nbr_out[slot] = dst[e];
      const i64 w = weight[e];
      nw_out[slot] = (int32_t)(w < weight_cap ? w : weight_cap);
      ++c;
    }
    for (i64 v = lo; v < hi; ++v)
      for (i64 j = cursor[(size_t)(v - lo)]; j < deg_pad; ++j) {
        nbr_out[v * deg_pad + j] = sent_node;
        nw_out[v * deg_pad + j] = sent_w;
      }
  };
  if (nt > 1 && n_nodes > (i64)1 << 14) {
    std::vector<std::thread> ts;
    const i64 chunk = (n_nodes + nt - 1) / nt;
    for (i64 t = 0; t < nt; ++t) {
      const i64 lo = t * chunk;
      if (lo >= n_nodes) break;
      ts.emplace_back(fill, lo, std::min(n_nodes, lo + chunk));
    }
    for (auto& th : ts) th.join();
  } else {
    fill(0, n_nodes);
  }
  // sentinel row n_nodes
  for (i64 j = 0; j < deg_pad; ++j) {
    nbr_out[n_nodes * deg_pad + j] = sent_node;
    nw_out[n_nodes * deg_pad + j] = sent_w;
  }
  return overflow.load();  // callers treat > 0 as "deg_pad too small"
}
