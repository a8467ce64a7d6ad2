"""Optimal matchtigs: minimum plain-text representation with repetition.

Capability-equivalent of ``MatchtigAlgorithm``
(/root/reference/src/implementation/matchtigs/mod.rs:131-940):

1. imbalance scan; unbalanced self-mirrors get multiplicity 1 on both
   sides (mod.rs:176-191);
2. all-pairs k-bounded shortest paths between unbalanced nodes via the
   batched device kernel (replacing the threaded Dijkstra fan-out,
   mod.rs:321-541);
3. binodes expand into |imbalance| matching ids shared with their mirror
   (``GraphMatchingNodeMap``,
   /root/reference/src/implementation/mod.rs:188-250); candidate paths
   collapse to deduplicated id-pair edges (mod.rs:273-305);
4. the min-cost perfect matching on the doubled graph + 4 extra nodes per
   WCC (mod.rs:600-719) is solved equivalently but decomposed: matching
   constraints only bind within *candidate-graph* components (tiny even
   when the input graph is one giant component), and the per-input-WCC
   two free tig ends (what the 4 extras encode) are allocated across them
   exactly — zero-cost absorbers first, else a 2-unit knapsack over
   forced-deletion deltas (``_allocate_and_match``).  Components are
   solved exactly at any size with the in-process native sparse blossom
   (:mod:`matchtigs_tpu.ops.perfect_matching`) instead of the external
   blossom5 subprocess (mod.rs:724-746);
5. matched pairs become cheap dummy biedges; balancing, Eulerian
   decomposition and cycle breaking finish as usual (mod.rs:828-928).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..graph.bigraph import Bigraph
from ..ops import euler
from ..ops.matching import unbalanced_nodes
from .greedytigs import GreedytigConfig, SearchStats, collect_candidates

logger = logging.getLogger(__name__)


@dataclass
class MatchtigConfig:
    k: int
    # Same defaults as GreedytigConfig (not yet measured on the H100);
    # overflowed sources recompute exactly on the host tail, so the
    # candidate set is identical for any capacity.
    initial_capacity: int = 4
    max_capacity: int = 1 << 16
    batch_size: int = 4096
    # If set, the collapsed matching instance and its solution are written
    # to <prefix>.matching / <prefix>.matching.solution — the durable
    # intermediate analog of the reference's blossom5 files
    # (<prefix>.minimalperfectmatching[.solution], matchtigs/mod.rs:600-603).
    matching_file_prefix: str | None = None
    # If set, candidate components up to this size are routed through the
    # independent dense O(n^3) blossom instead of the default sparse exact
    # solver (a perf/cross-check knob; both are exact).
    dense_limit: int | None = None
    # Threads for the native host Dijkstra (None = all cores), forwarded
    # to the internal GreedytigConfig (the reference's --threads reaches
    # both matchtig variants, src/bin.rs:147-149).
    host_threads: int | None = None
    # Opt-in per-source search counters; see GreedytigConfig.
    performance_counters: bool = False
    # Host search strategy ("dial" | "heap"); see GreedytigConfig.
    host_strategy: str = "dial"
    # Search engine ("auto" | "device" | "host"); see GreedytigConfig.
    engine: str = "auto"


def _matching_node_ids(g: Bigraph, diff: np.ndarray):
    """Assign |imbalance| consecutive matching ids per unbalanced binode
    class (shared between a node and its mirror), vectorized.

    Returns (ids_start [N], ids_count [N], total, reps, offsets): for node
    v its matching ids are ids_start[v] .. ids_start[v]+ids_count[v]-1.
    """
    mirror = g.mirror_node
    nodes = np.arange(g.n_nodes, dtype=np.int64)
    canon = np.minimum(nodes, mirror.astype(np.int64))
    counts = np.abs(diff).astype(np.int64)
    # both members of a class carry the same |diff|; scatter to the rep
    class_counts = np.zeros(g.n_nodes, dtype=np.int64)
    class_counts[canon] = counts  # either member writes the same value
    reps = np.flatnonzero(class_counts)
    offsets = np.zeros(len(reps) + 1, dtype=np.int64)
    np.cumsum(class_counts[reps], out=offsets[1:])
    rep_start = np.full(g.n_nodes, -1, dtype=np.int64)
    rep_start[reps] = offsets[:-1]
    ids_start = rep_start[canon]
    ids_count = class_counts[canon]
    return ids_start, ids_count, int(offsets[-1]), reps, offsets



def _expand_candidate_ids(u, v, w, ids_start, ids_count, extras=()):
    """Flat product expansion of candidates into id-pair rows: row r of
    candidate c covers (i-th id of u[c], j-th id of v[c]).  Returns
    (a, b, wrow, *extras_expanded): per-row endpoint ids, weight, and
    any per-candidate payload columns expanded the same way (the packed
    collapse passes narrow bool orientation columns instead of full
    int64 node ids — ~1 GB less fresh allocation at 51M candidates, and
    first-touch faults are the cold-run cost).  Shared by both collapse
    paths (packed and argsort); int32 count math for the same reason.
    """
    counts32 = ids_count.astype(np.int32, copy=False)
    cu = counts32[u]
    cv = counts32[v]
    pc = cu * cv
    multi = pc > 1
    if not multi.any():
        return (ids_start[u], ids_start[v], w, *extras)
    single = ~multi
    pcm = pc[multi].astype(np.int64)
    mtot = int(pcm.sum())
    base = np.cumsum(pcm) - pcm
    midx = np.repeat(np.arange(len(pcm), dtype=np.int64), pcm)
    off = np.arange(mtot, dtype=np.int64) - base[midx]
    cvm = cv[multi][midx]
    i = off // cvm
    j = off - i * cvm
    um = u[multi][midx]
    vm = v[multi][midx]
    a = np.concatenate([ids_start[u[single]], ids_start[um] + i])
    b = np.concatenate([ids_start[v[single]], ids_start[vm] + j])
    wrow = np.concatenate([w[single], w[multi][midx]])
    out = [a, b, wrow]
    for col in extras:
        out.append(np.concatenate([col[single], col[multi][midx]]))
    return tuple(out)


def _collapse_candidates(
    g: Bigraph,
    candidates,  # Candidates columns
    ids_start: np.ndarray,
    ids_count: np.ndarray,
    n_ids: int,
):
    """Expand candidate (u, v, w) triples into deduplicated matching-id
    pair edges, vectorized (the GraphMatchingNodeMap product expansion,
    /root/reference/src/implementation/matchtigs/mod.rs:273-305).

    Returns (keys_a, keys_b, w, u, v) arrays, one row per unique id pair,
    sorted ascending by the pair key ``keys_a * n_ids + keys_b`` (the
    apply step relies on this to skip a re-sort).
    """
    if len(candidates) == 0:
        e = np.empty(0, dtype=np.int64)
        return e, e, e, e, e
    u = candidates.u
    v = candidates.v
    w = candidates.d
    assert np.all(w >= 1), "zero-weight candidate path"
    if n_ids < (1 << 23) and int(w.max(initial=0)) < 128:
        return _collapse_candidates_packed(
            g, u, v, w, ids_start, ids_count, n_ids
        )
    a, b, wrow, uu, vv = _expand_candidate_ids(
        u, v, w, ids_start, ids_count, extras=(u, v)
    )
    keep = a != b  # same-id self-loops only from mirror biedges
    lo = np.minimum(a, b)[keep]
    hi = np.maximum(a, b)[keep]
    wr = wrow[keep]
    ur = uu[keep]
    vr = vv[keep]
    key = lo * n_ids + hi
    # The same id pair can arise with different weights (unbalanced
    # self-mirror endpoints where d(u->v) != d(v->u)); keep the minimum
    # weight per pair so the matching never uses the longer path.
    wmax = int(wr.max(initial=0))
    if wmax < 128 and n_ids < (1 << 28):
        # single packed key (one argsort) instead of a two-key lexsort
        order = np.argsort(key * 128 + wr, kind="stable")
    else:
        order = np.lexsort((wr, key))
    key_s = key[order]
    first = np.ones(len(key_s), dtype=bool)
    first[1:] = key_s[1:] != key_s[:-1]
    sel = order[first]
    return lo[sel], hi[sel], wr[sel], ur[sel], vr[sel]


_IDB = 23  # id bits in the packed collapse row (n_ids < 2^23)
_ID_MASK = (1 << _IDB) - 1


def _value_sort(arr: np.ndarray) -> None:
    """In-place ascending value sort of non-negative int64 keys: native
    MT radix at scale, np.sort otherwise (identical order)."""
    if len(arr) >= (1 << 20):
        try:
            from .. import native

            lib = native.load()
        except ImportError:
            lib = None
        if lib is not None:
            import os

            if lib.radix_sort_i64(
                len(arr), native.as_ll_ptr(arr),
                min(os.cpu_count() or 1, 16),
            ) == 0:
                return
    arr.sort()


def _expand_pack_native(g, u, v, w, ids_start, ids_count, is_canon):
    """Fused MT expansion + row packing + MT radix sort
    (extract.cpp:collapse_expand_pack + radix.cpp:radix_sort_i64):
    returns the SORTED packed rows, or None when the native library is
    unavailable (callers fall back to the numpy expansion).  Avoids ~3GB
    of expansion temporaries at 60M bases — the collapse's cold cost is
    first-touch fault exposure, not arithmetic."""
    import os

    try:
        from .. import native

        lib = native.load()
    except ImportError:
        return None
    p = native.as_ll_ptr
    u64 = np.ascontiguousarray(u, dtype=np.int64)
    v64 = np.ascontiguousarray(v, dtype=np.int64)
    w64 = np.ascontiguousarray(w, dtype=np.int64)
    starts = np.ascontiguousarray(ids_start, dtype=np.int64)
    counts = np.ascontiguousarray(ids_count, dtype=np.int64)
    canon8 = np.ascontiguousarray(is_canon, dtype=np.int8)
    nt = min(os.cpu_count() or 1, 16)
    n = int(
        lib.collapse_expand_count(len(u64), p(u64), p(v64), p(counts), nt)
    )
    packed = np.empty(n, dtype=np.int64)
    if n:
        wrote = int(
            lib.collapse_expand_pack(
                len(u64), p(u64), p(v64), p(w64), p(starts), p(counts),
                native.as_i8_ptr(canon8), _IDB, nt, p(packed),
            )
        )
        assert wrote == n
        if lib.radix_sort_i64(n, p(packed), nt) != 0:
            raise MemoryError("radix_sort_i64 allocation failed")
    return packed


def _dedup_resolve_native(packed, node_of_id, mirror):
    """Fused dedup + unpack + id->node resolution of the SORTED packed
    collapse rows (extract.cpp:collapse_dedup_resolve): emits
    (lo, hi, w, ur, vr) directly, skipping the ~2.8GB numpy
    gather/where epilogue.  None when native is unavailable or below
    the thread-spawn payoff."""
    import os

    try:
        from .. import native

        lib = native.load()
    except ImportError:
        return None
    if len(packed) < (1 << 18):
        return None
    p = native.as_ll_ptr
    nt = min(os.cpu_count() or 1, 16)
    node_of_id = np.ascontiguousarray(node_of_id, dtype=np.int64)
    mirror = np.ascontiguousarray(mirror, dtype=np.int64)
    n_keep = int(
        lib.collapse_dedup_resolve(
            len(packed), p(packed), _IDB, p(node_of_id), p(mirror), nt,
            None, None, None, None, None,
        )
    )
    lo = np.empty(n_keep, dtype=np.int64)
    hi = np.empty(n_keep, dtype=np.int64)
    wk = np.empty(n_keep, dtype=np.int64)
    ur = np.empty(n_keep, dtype=np.int64)
    vr = np.empty(n_keep, dtype=np.int64)
    wrote = int(
        lib.collapse_dedup_resolve(
            len(packed), p(packed), _IDB, p(node_of_id), p(mirror), nt,
            p(lo), p(hi), p(wk), p(ur), p(vr),
        )
    )
    assert wrote == n_keep
    return lo, hi, wk, ur, vr


def _dedup_unpack_native(packed: np.ndarray):
    """First-per-key dedup + self-pair drop + column unpack of the SORTED
    packed collapse rows in one MT pass (extract.cpp:collapse_dedup_unpack)
    — replaces ~6 numpy passes and their full-length temporaries.  None
    when the native library is unavailable."""
    import os

    try:
        from .. import native

        lib = native.load()
    except ImportError:
        return None
    if len(packed) < (1 << 18):
        return None  # below the thread-spawn payoff; numpy path
    p = native.as_ll_ptr
    nt = min(os.cpu_count() or 1, 16)
    n_keep = int(
        lib.collapse_dedup_unpack(
            len(packed), p(packed), _IDB, nt, None, None, None, None, None,
            None,
        )
    )
    lo = np.empty(n_keep, dtype=np.int64)
    hi = np.empty(n_keep, dtype=np.int64)
    wk = np.empty(n_keep, dtype=np.int64)
    o = np.empty(n_keep, dtype=np.int8)
    su = np.empty(n_keep, dtype=np.int8)
    sv = np.empty(n_keep, dtype=np.int8)
    i8 = native.as_i8_ptr
    wrote = int(
        lib.collapse_dedup_unpack(
            len(packed), p(packed), _IDB, nt,
            p(lo), p(hi), p(wk), i8(o), i8(su), i8(sv),
        )
    )
    assert wrote == n_keep
    return lo, hi, wk, o, su, sv


def _collapse_candidates_packed(g, u, v, w, ids_start, ids_count, n_ids):
    """Value-sort collapse: each expanded row packs into ONE int64
    ``lo<<33 | hi<<10 | w<<3 | o<<2 | su<<1 | sv`` (56 bits), sorted by
    VALUE — no index permutation, no post-sort gathers, and roughly half
    the full-length temporaries of the argsort path (the cold 60M-base
    collapse was fault-bound at 110s / 26.5s warm).

    The three orientation bits recover the concrete edge after dedup —
    matching ids are shared by a binode and its mirror, so (lo, hi)
    alone is ambiguous up to mirrors: ``o`` says the lo id belongs to
    the out-node side, ``su``/``sv`` say whether the out/in node is the
    canonical class member.  Dedup keeps the minimum (w, o, su, sv) per
    id pair: the minimum weight, with a deterministic tie-break among
    equal-weight candidate rows (any of which is a real shortest path).
    """
    import os as _osc
    import time as _tc

    _trc = _osc.environ.get("MATCHTIGS_NATIVE_TRACE")
    _lc = [_tc.monotonic()]

    def _clap(tag):
        if _trc:
            now = _tc.monotonic()
            print(f"[collapse] {tag}: {now - _lc[0]:.2f}s", flush=True)
            _lc[0] = now

    mirror = g.mirror_node.astype(np.int64)
    is_canon = np.arange(g.n_nodes, dtype=np.int64) <= mirror

    packed = _expand_pack_native(
        g, u, v, w, ids_start, ids_count, is_canon
    )
    _clap("expand+pack+sort (native)")
    if packed is None:
        # numpy fallback/oracle path
        a, b, wrow, su, sv = _expand_candidate_ids(
            u, v, w, ids_start, ids_count, extras=(is_canon[u], is_canon[v])
        )
        o = a <= b
        packed = np.empty(len(a), dtype=np.int64)
        np.left_shift(np.where(o, a, b), _IDB + 10, out=packed)
        packed |= np.where(o, b, a) << 10
        packed |= wrow << 3
        packed |= o.astype(np.int64) << 2
        packed |= su.astype(np.int64) << 1
        packed |= sv.astype(np.int64)
        packed.sort()
    _clap("fallback branch")
    # canonical node per id: canonical class reps ascending own the
    # consecutive id ranges (ids_start is a cumsum over them).  Computed
    # before dedup so the fused native pass can resolve (ur, vr) during
    # emission — the numpy epilogue below (node_of_id/mirror gathers +
    # wheres over every survivor, ~2.8GB of temporaries = ~13.6s at
    # 35.4M rows) then never runs; it stays as the fallback oracle.
    canon_nodes = np.flatnonzero((ids_count > 0) & is_canon)
    node_of_id = np.repeat(canon_nodes, ids_count[canon_nodes])
    res5 = _dedup_resolve_native(packed, node_of_id, mirror)
    if res5 is not None:
        _clap("dedup+resolve (fused native)")
        return res5
    res = _dedup_unpack_native(packed)
    if res is not None:
        lo, hi, wk, o, su, sv = res
    else:  # numpy fallback/oracle
        key = packed >> 10
        first = np.empty(len(key), dtype=bool)
        if len(first):
            first[0] = True
            np.not_equal(key[1:], key[:-1], out=first[1:])
        vals = packed[first]
        lo = vals >> (_IDB + 10)
        hi = (vals >> 10) & _ID_MASK
        keep = lo != hi  # same-id self-loops only from mirror biedges
        vals, lo, hi = vals[keep], lo[keep], hi[keep]
        wk = (vals >> 3) & 127
        o = (vals >> 2) & 1
        su = (vals >> 1) & 1
        sv = vals & 1

    _clap("dedup+unpack")
    a_node = node_of_id[lo]
    b_node = node_of_id[hi]
    u_can = np.where(o == 1, a_node, b_node)
    v_can = np.where(o == 1, b_node, a_node)
    ur = np.where(su == 1, u_can, mirror[u_can])
    vr = np.where(sv == 1, v_can, mirror[v_can])
    _clap("epilogue gathers")
    return lo, hi, wk, ur, vr


def compute_matchtigs(
    g: Bigraph, config: MatchtigConfig, stats: SearchStats | None = None
) -> "Walks":
    """Mutates `g` (adds dummy biedges) and returns edge walks.

    ``stats``, when given, is filled in place with the search-phase
    counters, as in :func:`compute_greedytigs`."""
    import time

    t0 = time.monotonic()

    def lap(label):
        nonlocal t0
        t1 = time.monotonic()
        logger.info("%s: %.2fs", label, t1 - t0)
        t0 = t1

    k = config.k
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    diff = g.imbalances()
    logger.info(
        "Found %d nodes with missing outgoing and %d with missing incoming edges",
        len(out_nodes),
        int(in_mask.sum()),
    )

    # All-pairs bounded shortest paths (targets = every in-node).
    gt_config = GreedytigConfig(
        k=k,
        initial_capacity=config.initial_capacity,
        max_capacity=config.max_capacity,
        batch_size=config.batch_size,
        host_threads=config.host_threads,
        performance_counters=config.performance_counters,
        host_strategy=config.host_strategy,
        engine=config.engine,
    )
    stats = stats if stats is not None else SearchStats()
    candidates = collect_candidates(g, out_nodes, in_mask, k, gt_config, stats)
    logger.info("Found %d candidate shortest paths", len(candidates))
    lap("Candidate phase")
    if config.performance_counters and len(candidates):
        stats.log_ball_sizes(candidates, g.n_nodes, out_nodes)

    # Expand binodes into matching ids and collapse candidates to id pairs.
    ids_start, ids_count, n_ids, reps, offsets = _matching_node_ids(g, diff)
    logger.info("Matching instance has %d expanded nodes", n_ids)

    ka, kb, kw, ku, kv = _collapse_candidates(
        g, candidates, ids_start, ids_count, n_ids
    )
    logger.info("Collapsed to %d matching edges", len(ka))
    lap("Candidate collapse")

    # Components of the bidirected graph (doubled edges + mirror pairing);
    # each component's Eulerian tour needs >= 1 break, granted free by the
    # per-component gadget (the reference's 4-extra-nodes-per-WCC).
    comp = _bidirected_components(g)
    rep_counts = (offsets[1:] - offsets[:-1]).astype(np.int64)
    id_comp = np.repeat(comp[reps].astype(np.int64), rep_counts)
    lap("WCC decomposition")

    matched_pairs = _allocate_and_match(
        ka, kb, kw, n_ids, id_comp, k, dense_limit=config.dense_limit
    )
    logger.info("Matched %d id pairs", len(matched_pairs))
    lap("Matching")

    if config.matching_file_prefix is not None:
        inst = f"{config.matching_file_prefix}.matching"
        with open(inst, "w") as f:
            f.write(f"{n_ids} {len(ka)}\n")
            for a, b, w in np.stack([ka, kb, kw], axis=1).tolist():
                f.write(f"{a} {b} {w}\n")
        with open(inst + ".solution", "w") as f:
            f.write(f"{n_ids} {len(matched_pairs)}\n")
            for a, b in matched_pairs:
                f.write(f"{a} {b}\n")
        logger.info("Wrote matching instance and solution to %s[.solution]", inst)

    # Apply matching: insert cheap dummy biedges (lookup matched id pairs
    # back to their (u, v, w) via the sorted pair keys), vectorized — the
    # per-pair python loop cost a searchsorted call per pair (252k calls
    # at bench scale).
    mp = np.asarray(matched_pairs, dtype=np.int64).reshape(-1, 2)
    dummy_edge_id = len(mp)
    if len(mp):
        # _collapse_candidates emits rows ascending in lo*n_ids+hi (it
        # dedups via a sorted first-of-run), so no re-sort is needed
        # (the argsort here cost ~10s at 35M edges / 60M bases).
        pair_keys = ka * n_ids + kb
        keys = np.minimum(mp[:, 0], mp[:, 1]) * n_ids + np.maximum(
            mp[:, 0], mp[:, 1]
        )
        idx = np.searchsorted(pair_keys, keys)
        assert np.all(pair_keys[idx] == keys), "matched pair has no edge"
        g.add_biedge_pairs(
            src=ku[idx],
            dst=kv[idx],
            weight=kw[idx],
            handle=np.full(len(mp), -1, dtype=np.int64),
            forward=np.ones(len(mp), dtype=bool),
            dummy_id=np.arange(1, len(mp) + 1, dtype=np.int64),
        )

    from ..utils.debug import debug_checks

    if debug_checks():  # debug_assert! analogs, off in production
        assert g.verify_node_pairing()
        assert g.verify_edge_mirror_property()
    lap("Apply matching")

    logger.info("Making graph Eulerian by completing unmatched nodes")
    euler.make_eulerian_with_breaking_edges(g, k, dummy_edge_id)
    if not euler.decomposes_into_eulerian_bicycles(g):
        raise AssertionError("Failed to make the graph Eulerian")
    if debug_checks():
        euler.assert_no_consecutive_dummy_edges(g, k)
    lap("Balance")

    cycles = euler.eulerian_bicycle_decomposition(g)
    logger.info("Found %d Eulerian bicycles", len(cycles))
    tigs = euler.break_cycles(g, cycles, k)
    logger.info("Found %d matchtigs", len(tigs))
    lap("Euler + break")
    return tigs


def _allocate_and_match(
    ka: np.ndarray,
    kb: np.ndarray,
    kw: np.ndarray,
    n_ids: int,
    id_comp: np.ndarray,  # input-graph component per matching id
    k: int,
    dense_limit: int | None = None,
) -> np.ndarray:
    """Exact optimal matching, decomposed by *candidate-graph* components.

    The matching constraints only bind within connected components of the
    candidate (id-pair) graph, which stay small even when the input graph
    is one giant component.  The only coupling is the reference's
    4-extra-nodes-per-WCC construction: each input component donates
    exactly two zero-cost unmatched slots (its mandatory cycle's two tig
    ends).  Those slots go to zero-cost absorbers first (ids with no
    candidate edges, or odd-size components, where one member is unmatched
    anyway); only when an input component lacks two such absorbers are the
    forced-deletion variants solved and allocated exactly (a 2-unit
    knapsack over per-component deltas, which are always <= 0).
    """
    from ..ops.perfect_matching import component_matching_variants

    if n_ids == 0:
        return np.empty((0, 2), dtype=np.int64)
    import os as _os
    import time as _time0

    _tr = _os.environ.get("MATCHTIGS_NATIVE_TRACE")
    _lp = [_time0.monotonic()]

    def _slap(tag):
        if _tr:
            now = _time0.monotonic()
            print(f"[match-setup] {tag}: {now - _lp[0]:.2f}s", flush=True)
            _lp[0] = now

    if len(ka):
        cc = _connected_component_labels(n_ids, ka, kb)
    else:
        cc = np.arange(n_ids)
    _slap("cc labels")
    has_edge = np.zeros(n_ids, dtype=bool)
    has_edge[ka] = True
    has_edge[kb] = True

    # Bucket edges by candidate component: native MT counting-sort order
    # (labels are dense ints < n_ids) + first-of-run boundaries — the
    # numpy argsort + np.unique chain re-sorted 35M rows three times
    # (~38s of the matching lap under ambient faults at 60M bases).
    from ..utils.sorting import stable_order

    def _runs(sorted_labels):
        if not len(sorted_labels):
            return np.empty(0, np.int64), np.empty(0, np.int64)
        starts = np.concatenate(
            [[0], np.flatnonzero(sorted_labels[1:] != sorted_labels[:-1]) + 1]
        )
        return sorted_labels[starts], starts

    _slap("has_edge")
    edge_cc = cc[ka]
    order = stable_order(edge_cc.astype(np.int32, copy=False), n_ids)
    # Permute (ka, kb, kw) and edge_cc by `order` in one native MT pass
    # (gather_edges_cc_i64): np.stack(...)[order] plus the second
    # fancy-index gather built ~1.7GB of fresh single-threaded
    # temporaries (~7s at 35.4M edges under this host's ballooning).
    edges_sorted = None
    cc_sorted = np.empty(0, dtype=np.int64)
    if len(ka):
        try:
            from .. import native as _natg

            _libg = _natg.load()
        except ImportError:
            _libg = None
        if _libg is not None:
            import os as _osg

            n_e = len(ka)
            edges_sorted = np.empty((n_e, 3), dtype=np.int64)
            cc_sorted = np.empty(n_e, dtype=np.int64)
            _libg.gather_edges_cc_i64(
                n_e, _natg.as_ll_ptr(order),
                _natg.as_ll_ptr(np.ascontiguousarray(ka, dtype=np.int64)),
                _natg.as_ll_ptr(np.ascontiguousarray(kb, dtype=np.int64)),
                _natg.as_ll_ptr(np.ascontiguousarray(kw, dtype=np.int64)),
                _natg.as_ll_ptr(
                    np.ascontiguousarray(edge_cc, dtype=np.int64)
                ),
                _natg.as_ll_ptr(edges_sorted),
                _natg.as_ll_ptr(cc_sorted),
                min(_osg.cpu_count() or 1, 16),
            )
        else:  # python fallback / oracle
            edges_sorted = np.stack([ka, kb, kw], axis=1)[order]
            cc_sorted = edge_cc[order]
    cc_labels, cc_starts = _runs(cc_sorted)
    cc_to_slot = {int(c): i for i, c in enumerate(cc_labels)}
    cc_ends = np.append(cc_starts[1:], len(cc_sorted))

    _slap("edge bucket")
    # members per candidate component
    ids = np.arange(n_ids)
    cc_he = cc[has_edge]
    member_order = stable_order(cc_he.astype(np.int32, copy=False), n_ids)
    members_sorted = ids[has_edge][member_order]
    mcc_sorted = cc_he[member_order]
    m_labels, m_starts = _runs(mcc_sorted)
    m_ends = np.append(m_starts[1:], len(mcc_sorted))
    m_slot = {int(c): i for i, c in enumerate(m_labels)}

    _slap("member bucket")
    def comp_members(c: int) -> np.ndarray:
        i = m_slot[int(c)]
        return members_sorted[m_starts[i] : m_ends[i]]

    def comp_edges(c: int) -> np.ndarray:
        i = cc_to_slot[int(c)]
        return edges_sorted[cc_starts[i] : cc_ends[i]]

    _slap("comp slices")
    matched_pairs: list[tuple[int, int]] = []
    # Bucket matching ids by input component once (sorted slices) instead
    # of a full boolean scan per component.
    wcc_order = stable_order(
        id_comp.astype(np.int32, copy=False), int(id_comp.max(initial=0)) + 1
    )
    w_labels, w_starts = _runs(id_comp[wcc_order])
    w_ends = np.append(w_starts[1:], n_ids)
    _slap("wcc bucket")
    # Periodic progress (the reference prints % / dots during its long
    # phases, greedytigs/mod.rs:514-522, matchtigs/mod.rs:224-232).
    import time as _time

    import threading as _threading

    t_start = _time.monotonic()
    last_log = [t_start]
    ids_done = [0]
    progress_lock = _threading.Lock()

    def note_progress(n_done_ids: int) -> None:
        with progress_lock:
            ids_done[0] += n_done_ids
            now = _time.monotonic()
            if now - last_log[0] < 5.0:
                return
            last_log[0] = now
            done, total = ids_done[0], n_ids
        logger.info(
            "Matching: %d / %d ids solved (%.0f%%, %.0fs)",
            done,
            total,
            100.0 * done / max(1, total),
            _time.monotonic() - t_start,
        )

    def solve_uncached(c, deletions):
        t0 = _time.monotonic()
        res = component_matching_variants(
            comp_members(c), comp_edges(c), k, deletions, dense_limit
        )
        el = _time.monotonic() - t0
        if el >= 1.0:
            logger.info(
                "Solved matching component: %d ids, %d edges, "
                "deletion variants %s, %.1fs",
                len(comp_members(c)),
                len(comp_edges(c)),
                list(deletions),
                el,
            )
        note_progress(len(comp_members(c)))
        return res

    # The deletion variants a component needs depend only on its WCC's
    # zero-absorber count, known without solving.  All per-WCC accounting
    # is vectorized: per-comp/per-wcc python loops over the ~170k WCCs /
    # ~160k components cost tens of seconds at bench scale (412k tiny
    # searchsorted calls alone were 19s).
    n_w = len(w_labels)
    m_counts = (m_ends - m_starts).astype(np.int64)
    comp_wcc_slot = (
        np.searchsorted(w_labels, id_comp[members_sorted[m_starts]])
        if len(m_labels)
        else np.empty(0, dtype=np.int64)
    )
    odd_per_wcc = np.bincount(
        comp_wcc_slot, weights=(m_counts % 2), minlength=n_w
    ).astype(np.int64)
    single_ids = np.flatnonzero(~has_edge)
    singles_per_wcc = (
        np.bincount(
            np.searchsorted(w_labels, id_comp[single_ids]), minlength=n_w
        ).astype(np.int64)
        if len(single_ids)
        else np.zeros(n_w, dtype=np.int64)
    )
    need_per_wcc = np.maximum(0, 2 - (odd_per_wcc + singles_per_wcc))
    comp_need = (
        need_per_wcc[comp_wcc_slot]
        if len(m_labels)
        else np.empty(0, dtype=np.int64)
    )
    note_progress(int(len(single_ids)))

    comp_deletions: dict[int, tuple[int, ...]] = {}
    for si in np.flatnonzero(comp_need > 0):
        nd = int(comp_need[si])
        comp_deletions[int(m_labels[si])] = (0, 1) if nd == 1 else (0, 1, 2)

    solved: dict[int, dict] = {}
    # Pairs of components solved by the native batch call, sorted by
    # component label.
    batch_pair_cc = np.empty(0, dtype=np.int64)
    batch_pair_a = np.empty(0, dtype=np.int64)
    batch_pair_b = np.empty(0, dtype=np.int64)
    try:
        from .. import native

        native.load()
        have_native = True
    except ImportError:
        have_native = False
    if not have_native:
        # python fallback (no C++ toolchain): every component solves on
        # the per-component path below
        for si in range(len(m_labels)):
            comp_deletions.setdefault(int(m_labels[si]), (0,))
    if len(m_labels):
        import os
        from concurrent.futures import ThreadPoolExecutor

        # Components needing deletion variants stay on the python
        # per-component path (rare: only WCCs short of two zero-cost
        # absorbers).
        solo = sorted(
            comp_deletions, key=lambda c: len(comp_members(c)), reverse=True
        )

        def run_batch() -> None:
            # All need-0 components solve in ONE native batch call
            # (independent per-component blossoms over an internal
            # big-first thread pool, mwm_sparse_batch): dispatching each
            # component from python cost ~1.3ms in glue + GIL
            # serialization (76k components of 4-16 ids = 100s cumulative
            # at bench scale vs 12s for the actual giant tangles).
            nonlocal batch_pair_cc, batch_pair_a, batch_pair_b
            from ..ops.perfect_matching import (
                COUNT_SCALE,
                max_weight_matching_sparse_batch,
            )

            t0 = _time.monotonic()
            _lap_prev = [t0]

            def _lap(tag):
                import os as _os
                if _os.environ.get("MATCHTIGS_NATIVE_TRACE"):
                    now = _time.monotonic()
                    print(f"[batch-glue] {tag}: {now - _lap_prev[0]:.2f}s",
                          flush=True)
                    _lap_prev[0] = now

            slot_dels0 = comp_need == 0
            slot_sel = np.nonzero(slot_dels0)[0]
            if not len(slot_sel):
                return
            # label -> slot as a direct array gather (a searchsorted
            # binary probe per edge cost seconds over 35M rows)
            slot_of_label = np.zeros(n_ids, dtype=np.int64)
            slot_of_label[m_labels] = np.arange(len(m_labels))
            # node slices: members_sorted masked to selected slots
            sel_m = slot_dels0[slot_of_label[mcc_sorted]]
            all_m = bool(sel_m.all())
            batch_members = members_sorted if all_m else members_sorted[sel_m]
            NB = len(batch_members)
            counts = (m_ends - m_starts)[slot_sel]
            node_off = np.zeros(len(slot_sel) + 1, dtype=np.int64)
            np.cumsum(counts, out=node_off[1:])
            # global id -> batch position
            pos_of_id = np.empty(n_ids, dtype=np.int64)
            pos_of_id[members_sorted] = np.arange(len(members_sorted))
            new_pos = np.full(len(members_sorted), -1, dtype=np.int64)
            if all_m:
                new_pos = np.arange(NB)
            else:
                new_pos[np.nonzero(sel_m)[0]] = np.arange(NB)
            # edge slices + profit transform + per-pair max-profit dedup
            # (same stable tie-break as component_matching_variants)
            _lap("slot maps + node slices")
            sel_e = slot_dels0[slot_of_label[cc_sorted]]
            # the common case is EVERY component in the batch (no
            # deletion variants anywhere): skip the 850MB boolean copy
            es = edges_sorted if bool(sel_e.all()) else edges_sorted[sel_e]
            if all_m:  # new_pos is the identity: skip one 35M gather each
                ubp = pos_of_id[es[:, 0]]
                vbp = pos_of_id[es[:, 1]]
            else:
                ubp = new_pos[pos_of_id[es[:, 0]]]
                vbp = new_pos[pos_of_id[es[:, 1]]]
            _lap("edge select + gathers")
            lo = np.minimum(ubp, vbp)
            hi = np.maximum(ubp, vbp)
            dist = es[:, 2]
            if NB < (1 << 28) and int(dist.max(initial=0)) < 128:
                # Per-pair max-profit dedup: (lo*NB + hi) << 7 | dist
                # ascending == (pair key asc, profit DESC), exactly the
                # lexsort((-profit, key)) below.  The native pass
                # (pair_dedup_min_dist) does MT pack + MT 64-bit LSD
                # radix + MT boundary dedup + survivor unpack in one
                # call with zero numpy temporaries — the numpy version
                # below (kept as the fallback and parity oracle) paid
                # ~6 fresh 283MB temporaries whose first-touch faults
                # cost ~8s at 35.4M edges on this ballooning host.
                native_trip = None
                if have_native:
                    import ctypes as _ct

                    from .. import native as _nat
                    from ..ops.sssp import _wrap_native_triples

                    lib2 = _nat.load()
                    buf_ptr = _ct.POINTER(_ct.c_longlong)()
                    d_ptr = _ct.cast(
                        es.ctypes.data + 2 * es.strides[1],
                        _ct.POINTER(_ct.c_longlong),
                    )
                    cnt = int(
                        lib2.pair_dedup_min_dist(
                            len(lo), _nat.as_ll_ptr(lo),
                            _nat.as_ll_ptr(hi), d_ptr,
                            es.strides[0] // 8, NB,
                            min(os.cpu_count() or 1, 16),
                            _ct.byref(buf_ptr),
                        )
                    )
                    if cnt >= 0:
                        native_trip = _wrap_native_triples(
                            lib2, buf_ptr, cnt
                        )
                if native_trip is not None:
                    lo, hi = native_trip.u, native_trip.v
                    vals2 = lo  # row count for the log line
                    profit = (
                        np.int64(k - 1) - native_trip.d
                    ) * np.int64(COUNT_SCALE) + 1
                else:
                    packed2 = ((lo * np.int64(NB) + hi) << 7) | dist
                    _value_sort(packed2)
                    key2 = packed2 >> 7
                    keep2 = np.empty(len(key2), dtype=bool)
                    if len(keep2):
                        keep2[0] = True
                        np.not_equal(key2[1:], key2[:-1], out=keep2[1:])
                    vals2 = packed2[keep2]
                    key2 = vals2 >> 7
                    lo = key2 // np.int64(NB)
                    hi = key2 - lo * np.int64(NB)
                    profit = (np.int64(k - 1) - (vals2 & 127)) * np.int64(
                        COUNT_SCALE
                    ) + 1
            else:  # k > 127 or giant batches: index-permutation path
                profit = (np.int64(k - 1) - dist) * np.int64(COUNT_SCALE) + 1
                key = lo * np.int64(NB) + hi
                order2 = np.lexsort((-profit, key))
                keep2 = np.ones(len(order2), dtype=bool)
                keep2[1:] = key[order2][1:] != key[order2][:-1]
                sel2 = order2[keep2]
                vals2 = sel2  # row count for the log line
                lo, hi, profit = lo[sel2], hi[sel2], profit[sel2]
            _lap("pack-sort-dedup")
            assert np.all(profit >= 1)
            # component slot per surviving edge = slot of its lo position
            slot_per_pos = np.repeat(
                np.arange(len(slot_sel), dtype=np.int64), counts
            )
            rank2 = slot_per_pos[lo]
            edge_off = np.searchsorted(
                rank2, np.arange(len(slot_sel) + 1)
            ).astype(np.int64)
            _lap("edge_off + slots")
            mate, _ = max_weight_matching_sparse_batch(
                node_off,
                edge_off,
                lo - node_off[rank2],
                hi - node_off[rank2],
                profit,
            )
            _lap("native batch solve")
            # vectorized pair extraction (ascending batch position =
            # ascending member id per component, matching the solo path)
            node_base = np.repeat(node_off[:-1], counts)
            pos = np.arange(NB)
            partner = node_base + np.maximum(mate, 0)
            valid = (mate >= 0) & (pos < partner)
            batch_pair_a = batch_members[pos[valid]]
            batch_pair_b = batch_members[partner[valid]]
            batch_pair_cc = m_labels[slot_sel[slot_per_pos[valid]]]
            _lap("pair extraction")
            logger.info(
                "Batch-solved %d matching components (%d ids, %d edges, "
                "%d pairs) in %.1fs",
                len(slot_sel), NB, len(vals2), len(batch_pair_a),
                _time.monotonic() - t0,
            )
            note_progress(NB)

        n_workers = min(os.cpu_count() or 1, max(1, len(solo) + 1))
        with ThreadPoolExecutor(max_workers=n_workers) as ex:
            solo_futs = {
                c: ex.submit(solve_uncached, c, comp_deletions[c])
                for c in solo
            }
            if have_native:
                # the native call releases the GIL; solo variant solves
                # overlap on the pool threads
                run_batch()
            for c, fut in solo_futs.items():
                solved[c] = fut.result()

    def solve(c, deletions):
        return solved[int(c)]

    def knapsack_wcc(wslot: int) -> list[tuple[int, int]]:
        """Allocate this WCC's forced deletions exactly (2-unit knapsack
        over per-component deltas, always <= 0) and return its pairs in
        component order."""
        need = int(need_per_wcc[wslot])
        comp_ids = m_labels[np.flatnonzero(comp_wcc_slot == wslot)]
        out: list[tuple[int, int]] = []
        if not len(comp_ids):
            return out
        # forced deletions must land on even components: solve variants
        deletions = (0, 1) if need == 1 else (0, 1, 2)
        variants = {int(c): solve(c, deletions) for c in comp_ids}
        deltas = {
            c: v[1][0] - v[0][0] for c, v in variants.items() if 1 in v
        }
        chosen: dict[int, int] = {c: 0 for c in variants}
        if need == 1:
            best = max(deltas, key=deltas.get, default=None)
            if best is not None:
                chosen[best] = 1
        else:
            # best single comp taking both vs best two comps taking one each
            single = {
                c: v[2][0] - v[0][0] for c, v in variants.items() if 2 in v
            }
            best_single = max(single, key=single.get, default=None)
            top2 = sorted(deltas, key=deltas.get, reverse=True)[:2]
            two_val = (
                sum(deltas[c] for c in top2) if len(top2) == 2 else None
            )
            if best_single is not None and (
                two_val is None or single[best_single] >= two_val
            ):
                chosen[best_single] = 2
            elif two_val is not None:
                for c in top2:
                    chosen[c] = 1
        for c, j in chosen.items():
            out.extend(variants[c][j][1])
        return out

    # Emission order (matches the historical per-WCC loop byte for byte):
    # WCCs ascending; within a WCC components ascending; within a
    # component ascending member id.  Batch pairs are (component,
    # position)-sorted already, so one stable sort by WCC slot orders
    # them; the rare knapsack WCCs' python pairs splice in between.
    if len(batch_pair_cc):
        pair_w = comp_wcc_slot[np.searchsorted(m_labels, batch_pair_cc)]
        emit = np.argsort(pair_w, kind="stable")
        ea, eb, ew_sorted = (
            batch_pair_a[emit], batch_pair_b[emit], pair_w[emit]
        )
    else:
        ea = eb = np.empty(0, dtype=np.int64)
        ew_sorted = np.empty(0, dtype=np.int64)
    needy = np.flatnonzero(need_per_wcc > 0)
    if have_native:
        needy_with_comps = needy[
            np.isin(needy, comp_wcc_slot, assume_unique=False)
        ]
        segments: list[np.ndarray] = []
        prev = 0
        for wslot in needy_with_comps.tolist():
            cut = int(np.searchsorted(ew_sorted, wslot))
            segments.append(np.stack([ea[prev:cut], eb[prev:cut]], axis=1))
            kn = knapsack_wcc(wslot)
            segments.append(
                np.asarray(kn, dtype=np.int64).reshape(-1, 2)
            )
            prev = cut
        segments.append(np.stack([ea[prev:], eb[prev:]], axis=1))
        return (
            np.concatenate(segments)
            if len(segments) > 1
            else segments[0]
        )

    # python fallback (no native toolchain): per-WCC loop over `solved`
    for wi in range(n_w):
        if need_per_wcc[wi] > 0:
            matched_pairs.extend(knapsack_wcc(wi))
            continue
        comp_ids = m_labels[np.flatnonzero(comp_wcc_slot == wi)]
        for c in comp_ids:
            matched_pairs.extend(solve(c, (0,))[0][1])
    return np.asarray(matched_pairs, dtype=np.int64).reshape(-1, 2)



def _connected_component_labels(n: int, rows, cols) -> np.ndarray:
    """Undirected connected-component labels (0..n_comps-1, ascending by
    the component's minimum node id — scipy's labeling).  Native
    union-find (graphwalk.cpp:wcc_labels; ~0.5s vs scipy's ~7s over 19M
    edges at 60M-base scale), scipy fallback."""
    try:
        from .. import native

        lib = native.load()
    except ImportError:
        from scipy.sparse import coo_matrix
        from scipy.sparse.csgraph import connected_components

        adj = coo_matrix(
            (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n)
        )
        _, labels = connected_components(adj, directed=False)
        return labels
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    labels = np.empty(n, dtype=np.int32)
    lib.wcc_labels(
        n,
        len(rows),
        native.as_i32_ptr(rows),
        native.as_i32_ptr(cols),
        native.as_i32_ptr(labels),
    )
    return labels


def _bidirected_components(g: Bigraph) -> np.ndarray:
    """Connected components over edges + mirror-node pairing (undirected)."""
    n = g.n_nodes
    rows = np.concatenate([g.srcs(), np.arange(n, dtype=np.int32)])
    cols = np.concatenate([g.dsts(), g.mirror_node])
    return _connected_component_labels(n, rows, cols)
