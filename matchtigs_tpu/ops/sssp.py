"""Batched k-bounded multi-source shortest paths (the hot kernel).

Accelerator replacement for the reference's per-source binary-heap Dijkstra
(``traitgraph-algo``; call sites
/root/reference/src/implementation/greedytigs/mod.rs:324-341) and its whole
thread runtime (P1-P6 in SURVEY.md §2.3): a *batch* of S sources is relaxed
simultaneously with bounded Bellman-Ford rounds over a fixed-capacity
working set per source.

Why this maps to the hardware:
- distances are bounded by k-1 (<= 62), and edge weights are >= 1, so at
  most k-1 relaxation rounds reach a fixpoint — no priority queue needed;
- each source's reachable ball is tiny, so a per-source working set of C
  (node, dist) slots replaces the O(V) weight array / hashmap
  (``EpochNodeWeightArray`` / ``HashbrownHashMap``);
- a round is: one gather (padded [N+1, 4] adjacency) and two single-key
  int32 row sorts over (node, dist) packed into one word — per-node
  min-dedup and distance-compaction, regular statically-shaped work;
- the fixpoint test is a (count, sum-of-dists) witness, monotone under
  relaxation, so no canonical re-sort is needed;
- capacity overflow is *reported, not fatal*: sources whose candidate set
  ever exceeded C are flagged incomplete and retried with a larger C —
  the batched analog of the reference's staged parallelism / resource limits
  (greedytigs/mod.rs:537-644, DijkstraExhaustiveness).

Distances are packed into the low ``DIST_BITS`` of the sort key, node ids
above them; graphs with more than 2^(31-DIST_BITS) nodes fall back to
two-key lexicographic sorts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .candidates import Candidates
from .device_graph import ADJ_W_BITS, ADJ_W_MASK, DeviceGraph

INF = np.int32(1 << 20)  # > any bounded distance, safe against int32 overflow
DIST_BITS = 7  # distances < 128 (k <= 128); nodes < 2^24 for packed sorts


def _make_sort2(packed: bool, dist_cap):
    """Sorter for (node, dist) pairs along axis 1 by (node, dist) or
    (dist, node); single packed int32 key when ids fit."""

    def sort2(a_nodes, a_dist, by_node_first: bool):
        if packed:
            if by_node_first:
                key = (a_nodes << DIST_BITS) | a_dist
                key = jax.lax.sort(key, dimension=1)
                return key >> DIST_BITS, key & dist_cap
            key = (a_dist << (31 - DIST_BITS - 1)) | a_nodes
            # dist in high bits: requires nodes < 2^(31-DIST_BITS-1)
            key = jax.lax.sort(key, dimension=1)
            return key & ((1 << (31 - DIST_BITS - 1)) - 1), key >> (
                31 - DIST_BITS - 1
            )
        if by_node_first:
            n, d = jax.lax.sort((a_nodes, a_dist), num_keys=2, dimension=1)
            return n, d
        d, n = jax.lax.sort((a_dist, a_nodes), num_keys=2, dimension=1)
        return n, d

    return sort2


def _relax_round(
    nbr, nw, nodes, dist, overflow, max_weight, dist_cap, sort2, deg_pad,
    adj_packed: bool = False,
):
    """One bounded relaxation round on an [S, C] working set: expansion
    gather, per-node min-dedup, distance compaction back to C slots.
    Returns (nodes, dist, overflow, witness) — witness is the (count,
    sum-of-dists) pair, monotone under relaxation, so witness equality
    across one round certifies the per-source fixpoint (absent overflow,
    which is flagged separately and handled by the retry ladder).

    With ``adj_packed`` the adjacency arrives as ONE int32 per slot
    (``nbr`` holds ``(neighbor << ADJ_W_BITS) | weight``, ``nw`` unused):
    one expansion gather instead of two — half the HBM random traffic of
    the round's dominant op.  Requires max_weight < ADJ_W_MASK (clamped
    weights then exceed the bound and filter exactly like the original).
    """
    S, C = nodes.shape
    live = dist <= max_weight
    if adj_packed:
        sentinel = jnp.int32((nbr.shape[0] - 1))
        a = nbr[nodes]
        nn = jnp.where(live[:, :, None], a >> ADJ_W_BITS, sentinel)
        nd = dist[:, :, None] + (a & ADJ_W_MASK)
    else:
        sentinel = jnp.int32(nbr.shape[0] - 1)
        nn = jnp.where(live[:, :, None], nbr[nodes], sentinel)
        nd = dist[:, :, None] + nw[nodes]
    ok = (nn != sentinel) & (nd <= max_weight)
    cand_nodes = jnp.where(ok, nn, sentinel).reshape(S, C * deg_pad)
    cand_dist = jnp.where(ok, nd, dist_cap).reshape(S, C * deg_pad)

    all_nodes = jnp.concatenate([nodes, cand_nodes], axis=1)
    all_dist = jnp.concatenate([dist, cand_dist], axis=1)

    # Per-node min via (node, dist) sort + first-of-run.
    sn, sd = sort2(all_nodes, all_dist, by_node_first=True)
    first = jnp.concatenate(
        [jnp.ones((S, 1), dtype=bool), sn[:, 1:] != sn[:, :-1]], axis=1
    )
    keep = first & (sd < dist_cap) & (sn != sentinel)
    sd = jnp.where(keep, sd, dist_cap)
    sn = jnp.where(keep, sn, sentinel)

    # Compact to the C closest entries; a valid entry beyond C means
    # the resource limit was exceeded for this source.
    dn, dd = sort2(sn, sd, by_node_first=False)
    new_nodes = dn[:, :C]
    new_dist = dd[:, :C]
    overflow = overflow | (dd[:, C] < dist_cap)

    valid = new_dist < dist_cap
    count = valid.sum(axis=1, dtype=jnp.int32)
    dsum = jnp.where(valid, new_dist, 0).sum(axis=1, dtype=jnp.int32)
    witness = jnp.stack([count, dsum], axis=1)
    return new_nodes, new_dist, overflow, witness


@functools.partial(
    jax.jit,
    static_argnames=("capacity", "max_rounds", "deg_pad", "packed", "adj_packed"),
)
def _sssp_kernel(
    nbr: jax.Array,  # int32 [N+1, deg_pad]; packed slots when adj_packed
    nw: jax.Array,  # int32 [N+1, deg_pad]; unused when adj_packed
    sources: jax.Array,  # int32 [S]
    max_weight: jax.Array,  # int32 scalar
    capacity: int,
    max_rounds: int,
    deg_pad: int,
    packed: bool = True,
    adj_packed: bool = False,
):
    S = sources.shape[0]
    C = capacity
    sentinel = jnp.int32(nbr.shape[0] - 1)
    # Empty-slot sentinel distance; must exceed max_weight.  In packed mode
    # _can_pack guarantees max_weight < 2^DIST_BITS - 1; in the unpacked
    # fallback (k >= 128 or huge graphs) it is derived from max_rounds,
    # which callers always set to int(max_weight).
    dist_cap = jnp.int32((1 << DIST_BITS) - 1 if packed else max_rounds + 1)
    sort2 = _make_sort2(packed, dist_cap)

    # Init carry derived from `sources` so that under shard_map the whole
    # carry is uniformly axis-varying.
    nodes0 = jnp.full((S, C), sentinel, dtype=jnp.int32).at[:, 0].set(sources)
    dist0 = (
        jnp.full((S, C), dist_cap, dtype=jnp.int32).at[:, 0].set(sources * 0)
    )
    overflow0 = sources < 0  # all False; varying like `sources`
    witness0 = jnp.stack(
        [jnp.ones((S,), jnp.int32), jnp.zeros((S,), jnp.int32)], axis=1
    ) + (sources * 0)[:, None]

    def round_body(state):
        nodes, dist, overflow, witness, changed, r = state
        new_nodes, new_dist, overflow, new_witness = _relax_round(
            nbr, nw, nodes, dist, overflow, max_weight, dist_cap, sort2,
            deg_pad, adj_packed,
        )
        changed = jnp.any(new_witness != witness)
        return new_nodes, new_dist, overflow, new_witness, changed, r + 1

    def cond(state):
        *_, changed, r = state
        return changed & (r < max_rounds)

    changed0 = jnp.any(sources >= 0)  # True; varying like `sources`
    nodes, dist, overflow, _, _, rounds = jax.lax.while_loop(
        cond,
        round_body,
        (nodes0, dist0, overflow0, witness0, changed0, jnp.int32(0)),
    )
    dist = jnp.where(dist >= dist_cap, INF, dist)
    return nodes, dist, overflow, rounds


def _can_pack(dg: DeviceGraph, max_weight: int) -> bool:
    return (
        max_weight < (1 << DIST_BITS) - 1
        and dg.n_nodes + 1 < (1 << (31 - DIST_BITS - 1))
    )


def _can_pack_out(dg: DeviceGraph, max_weight: int) -> bool:
    """Result packing (one int32 per slot) only needs node < 2^24, a
    weaker bound than the sort packing's 2^23 — graphs in between (e.g.
    the 10.2M-node 60M-base config) use two-key sorts but still halve
    the result download and keep the native extraction path."""
    return (
        max_weight < (1 << DIST_BITS) - 1
        and dg.n_nodes + 1 < (1 << (31 - DIST_BITS))
    )


def _can_pack_adj(dg: DeviceGraph, max_weight: int) -> bool:
    """Adjacency packing (one int32 per slot: neighbor id + clamped
    weight): needs node ids < 2^24 and a search bound under the weight
    clamp, so clamped weights (== ADJ_W_MASK) filter exactly like their
    originals.  Independent of the sort packing — the 10.2M-node config
    runs two-key sorts over a packed adjacency."""
    return max_weight < ADJ_W_MASK and dg.can_pack_adj


def _dummy_nw():
    """Placeholder nw operand for adj_packed kernels (the traced arg must
    exist; the static branch never reads it)."""
    return jnp.zeros((1, 1), dtype=jnp.int32)


def _run_batches_impl(
    nbr,
    nw,
    sources_all,  # int32 [S_pad] resident on device
    max_weight,
    capacity: int,
    max_rounds: int,
    deg_pad: int,
    packed: bool,
    batch: int,
    n_batches: int,
    pack_out: bool,
    adj_packed: bool = False,
):
    """Shared body of the one-dispatch batched stage: a ``fori_loop``
    over batch indices accumulating results in device buffers.  Jitted
    directly for the single-device path (:func:`_sssp_run_batches`) and
    called per-shard inside ``shard_map`` by the mesh path
    (:func:`matchtigs_tpu.parallel.mesh.sharded_bounded_sssp`), so both
    run the identical kernel pipeline."""
    S_pad = sources_all.shape[0]
    C = capacity
    # Init buffers derived from `sources_all` so that under shard_map the
    # whole fori_loop carry is uniformly axis-varying (same trick as the
    # kernel's carry init).
    zero_col = (sources_all * 0)[:, None]
    nodes_buf0 = jnp.zeros((S_pad, C), dtype=jnp.int32) + zero_col
    dist_buf0 = (
        jnp.zeros((S_pad, C), jnp.int32) + zero_col
        if not pack_out
        else jnp.zeros((1, 1), jnp.int32) + sources_all[0] * 0
    )
    over_buf0 = sources_all < jnp.int32(-(1 << 30))  # all False; varying

    def body(i, bufs):
        nodes_buf, dist_buf, over_buf = bufs
        start = i * batch
        chunk = jax.lax.dynamic_slice_in_dim(sources_all, start, batch)
        nodes, dist, overflow, _ = _sssp_kernel(
            nbr,
            nw,
            chunk,
            max_weight,
            capacity=capacity,
            max_rounds=max_rounds,
            deg_pad=deg_pad,
            packed=packed,
            adj_packed=adj_packed,
        )
        if pack_out:
            # empty slots carry dist_cap (== max_rounds + 1 in two-key
            # mode, which is < 127): normalize every empty to 127 so the
            # extraction filter sees one sentinel in both modes
            dist_small = jnp.where(
                dist > max_weight,
                jnp.int32((1 << DIST_BITS) - 1),
                dist,
            )
            nodes_buf = jax.lax.dynamic_update_slice_in_dim(
                nodes_buf, (nodes << DIST_BITS) | dist_small, start, 0
            )
        else:
            nodes_buf = jax.lax.dynamic_update_slice_in_dim(
                nodes_buf, nodes, start, 0
            )
            dist_buf = jax.lax.dynamic_update_slice_in_dim(
                dist_buf, dist, start, 0
            )
        over_buf = jax.lax.dynamic_update_slice_in_dim(
            over_buf, overflow, start, 0
        )
        return nodes_buf, dist_buf, over_buf

    return jax.lax.fori_loop(
        0, n_batches, body, (nodes_buf0, dist_buf0, over_buf0)
    )


def _pool_impl(
    nbr,
    nw,
    sources_all,  # int32 [S_pad] resident on device
    max_weight,
    capacity: int,
    max_rounds: int,
    deg_pad: int,
    packed: bool,
    pool: int,
    pack_out: bool,
    adj_packed: bool = False,
):
    """Persistent compacted source pool: the whole search as ONE device
    while_loop at ~full slot occupancy.

    The batched scheduler (:func:`_run_batches_impl`) runs each batch of
    S sources until its *slowest* source converges — low slot occupancy,
    because ball sizes and convergence rounds are heavily skewed (the
    batched analog of the reference's work-stealing queue sitting idle,
    greedytigs/mod.rs:276-341).  Here a fixed pool of P lanes each hold
    one in-flight source; every iteration runs one relaxation round on
    all P lanes, then *retires* lanes that converged (witness stable) or
    overflowed (the retry ladder / host tail recomputes those anyway, so
    burning more rounds on them is pure waste) by scattering their rows
    into the result buffers and refilling the lane with the next source
    from the stream.  Work ≈ sum of per-source rounds instead of
    sum of per-batch max rounds.

    Retired rows land at their source's position in ``sources_all`` order
    (row i of the result belongs to sources_all[i]); exhausted lanes park
    on a trash row at index S_pad.  Returns (nodes_buf, dist_buf,
    over_buf) of S_pad+1 rows — callers slice off the trash row.
    """
    S_pad = sources_all.shape[0]
    C = capacity
    P = pool
    sentinel = jnp.int32(nbr.shape[0] - 1)
    dist_cap = jnp.int32((1 << DIST_BITS) - 1 if packed else max_rounds + 1)
    out_cap = jnp.int32((1 << DIST_BITS) - 1)
    sort2 = _make_sort2(packed, dist_cap)
    col0 = jnp.arange(C, dtype=jnp.int32)[None, :] == 0  # [1, C]

    def lane_init(src):  # src: int32 [P] device node ids (sentinel = idle)
        # every output is derived from `src` so that under shard_map the
        # whole while_loop carry is uniformly axis-varying
        zero = src * 0
        nodes = jnp.where(col0, src[:, None], sentinel)
        dist = jnp.where(col0, zero[:, None], dist_cap)
        wit = jnp.stack([zero + 1, zero], axis=1)
        return nodes, dist, wit

    def fetch(idx):  # idx: int32 [P] indices into sources_all
        live = idx < S_pad
        src = sources_all[jnp.clip(idx, 0, S_pad - 1)]
        return jnp.where(live, src, sentinel)

    # Result buffers have one extra trash row (index S_pad) that absorbs
    # writes from idle lanes and from lanes still in flight.
    zero_rows = jnp.zeros((S_pad + 1, C), jnp.int32) + (sources_all[0] * 0)
    nodes_buf0 = zero_rows
    dist_buf0 = zero_rows if not pack_out else jnp.zeros((1, 1), jnp.int32)
    over_buf0 = jnp.zeros((S_pad + 1,), bool) | (sources_all[0] < -(1 << 30))

    lane0 = sources_all[0] * 0  # axis-varying zero (see lane_init)
    idx0 = jnp.arange(P, dtype=jnp.int32) + lane0
    nodes0, dist0, wit0 = lane_init(fetch(idx0))
    over0 = jnp.zeros((P,), bool) | (lane0 < -1)
    r0 = jnp.zeros((P,), jnp.int32) + lane0

    def cond(state):
        idx = state[0]
        return jnp.any(idx < S_pad)

    def body(state):
        (idx, cursor, nodes, dist, over, wit, r_lane,
         nodes_buf, dist_buf, over_buf) = state
        nodes, dist, over, wit_new = _relax_round(
            nbr, nw, nodes, dist, over, max_weight, dist_cap, sort2, deg_pad,
            adj_packed,
        )
        r_lane = r_lane + 1
        # Retire on fixpoint, on overflow (downstream recomputes those
        # sources at higher capacity / on host), or on the defensive
        # round cap (bounded dists guarantee convergence in
        # max_rounds + 1; the cap turns any violation into an overflow
        # retry instead of a hang).
        capped = r_lane > jnp.int32(max_rounds + 1)
        over = over | capped
        retire = jnp.all(wit_new == wit, axis=1) | over

        # Scatter retiring lanes' results; everyone else writes trash.
        w_idx = jnp.where(retire & (idx < S_pad), idx, S_pad)
        if pack_out:
            dist_small = jnp.where(dist > max_weight, out_cap, dist)
            nodes_buf = nodes_buf.at[w_idx].set(
                (nodes << DIST_BITS) | dist_small
            )
        else:
            nodes_buf = nodes_buf.at[w_idx].set(nodes)
            dist_buf = dist_buf.at[w_idx].set(dist)
        over_buf = over_buf.at[w_idx].set(over)

        # Refill retired lanes from the stream (exhausted -> idle lane).
        rank = jnp.cumsum(retire.astype(jnp.int32)) - retire
        idx = jnp.where(retire, cursor + rank, idx)
        cursor = cursor + retire.sum(dtype=jnp.int32)
        f_nodes, f_dist, f_wit = lane_init(fetch(idx))
        keep = ~retire
        nodes = jnp.where(keep[:, None], nodes, f_nodes)
        dist = jnp.where(keep[:, None], dist, f_dist)
        wit = jnp.where(keep[:, None], wit_new, f_wit)
        over = over & keep
        r_lane = jnp.where(keep, r_lane, 0)
        return (idx, cursor, nodes, dist, over, wit, r_lane,
                nodes_buf, dist_buf, over_buf)

    state = (idx0, jnp.int32(P) + lane0, nodes0, dist0, over0, wit0, r0,
             nodes_buf0, dist_buf0, over_buf0)
    state = jax.lax.while_loop(cond, body, state)
    return state[7], state[8], state[9]


@functools.partial(
    jax.jit,
    static_argnames=(
        "capacity", "max_rounds", "deg_pad", "packed", "pool", "pack_out",
        "adj_packed",
    ),
)
def _sssp_run_pool(
    nbr, nw, sources_all, max_weight,
    capacity: int, max_rounds: int, deg_pad: int, packed: bool,
    pool: int, pack_out: bool, adj_packed: bool = False,
):
    return _pool_impl(
        nbr, nw, sources_all, max_weight,
        capacity=capacity, max_rounds=max_rounds, deg_pad=deg_pad,
        packed=packed, pool=pool, pack_out=pack_out, adj_packed=adj_packed,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "capacity", "max_rounds", "deg_pad", "packed", "pool", "budget",
        "adj_packed",
    ),
)
def _sssp_run_pool_compact(
    nbr, nw, sources_all, max_weight,
    capacity: int, max_rounds: int, deg_pad: int, packed: bool,
    pool: int, budget: int, adj_packed: bool = False,
):
    """Pool stage + device-side valid-slot compaction.

    Most packed result slots are invalid at small C, yet the full
    [S, C] buffer is downloaded to the host.  This variant filters the
    slots the host extraction would drop anyway
    (sentinel node, dist outside [1, max_weight], overflowed row) ON
    DEVICE, compacts the survivors in row-major order via one two-key
    sort (x64-free: int32 flat-position key with an invalid bit at
    2^30, so (S_pad + 1) * C must stay below 2^30), and returns a fixed
    ``budget``-sized value buffer plus int8 per-row counts — a smaller
    download.  The full buffer stays
    resident on device as the fallback when the valid count exceeds the
    budget (``DispatchedStage.fetch_candidates`` re-downloads it whole
    and runs the native extraction instead)."""
    nodes_buf, _, over_buf = _pool_impl(
        nbr, nw, sources_all, max_weight,
        capacity=capacity, max_rounds=max_rounds, deg_pad=deg_pad,
        packed=packed, pool=pool, pack_out=True, adj_packed=adj_packed,
    )
    R, C = nodes_buf.shape  # S_pad + 1 rows; the trash row is last
    sentinel = jnp.int32(nbr.shape[0] - 1)
    dist = nodes_buf & jnp.int32((1 << DIST_BITS) - 1)
    node = nodes_buf >> DIST_BITS
    valid = (node != sentinel) & (dist >= 1) & (dist <= max_weight)
    valid = valid & (~over_buf)[:, None]
    valid = valid.at[R - 1].set(False)
    counts = valid.sum(axis=1, dtype=jnp.int32)
    total = counts.sum(dtype=jnp.int32)
    if C <= 127:  # counts <= C fit int8: quarters the counts download
        counts = counts.astype(jnp.int8)
    flatpos = jnp.arange(R * C, dtype=jnp.int32)
    key = jnp.where(valid.reshape(-1), flatpos, flatpos + jnp.int32(1 << 30))
    _, compact = jax.lax.sort((key, nodes_buf.reshape(-1)), num_keys=1)
    return compact[:budget], counts, total, over_buf, nodes_buf


# NOTE: no donate_argnums.  Donation through the inner while_loop once
# inflated compile time many times over on another backend; its effect
# on the GPU's compile time and step time is not yet measured.
@functools.partial(
    jax.jit,
    static_argnames=(
        "capacity", "max_rounds", "deg_pad", "packed", "batch",
        "n_batches", "pack_out", "adj_packed",
    ),
)
def _sssp_run_batches(
    nbr,
    nw,
    sources_all,
    max_weight,
    capacity: int,
    max_rounds: int,
    deg_pad: int,
    packed: bool,
    batch: int,
    n_batches: int,
    pack_out: bool,
    adj_packed: bool = False,
):
    """Run every batch of the search inside ONE device program.

    A ``fori_loop`` over the batch index keeps the whole stage on
    device with a single dispatch and a single result download, instead
    of one host round trip per batch.  With pack_out (packed mode),
    (node, dist) pairs come down as ONE int32 per slot — distances
    occupy the low DIST_BITS — halving the result download.
    """
    return _run_batches_impl(
        nbr,
        nw,
        sources_all,
        max_weight,
        capacity=capacity,
        max_rounds=max_rounds,
        deg_pad=deg_pad,
        packed=packed,
        batch=batch,
        n_batches=n_batches,
        pack_out=pack_out,
        adj_packed=adj_packed,
    )


class DispatchedStage:
    """Handle for an in-flight pool-scheduled device stage
    (:func:`batched_bounded_sssp_dispatch`): the program is queued on the
    device; ``fetch()`` blocks for its results.  Dispatching a second
    stage before fetching the first overlaps the first stage's result
    download and host-side processing (extraction, overflow tail) with
    the second stage's device compute — the device executes queued
    programs in order."""

    def __init__(self, nodes_buf, over_buf, n_sources: int,
                 compact=None, counts=None, total=None, budget: int = 0):
        self._nodes_buf = nodes_buf
        self._over_buf = over_buf
        self._n = n_sources
        self._compact = compact
        self._counts = counts
        self._total = total
        self._budget = budget

    def fetch(self):
        """(packed_nodes [S, C] int32, overflow [S] bool), blocking."""
        key = np.asarray(self._nodes_buf)[: self._n]
        over = np.asarray(self._over_buf)[: self._n]
        return key, over

    def fetch_candidates(self, dg, sources, in_mask):
        """(Candidates, overflow [S] bool), blocking.

        Takes the compact download (budgeted value buffer + int8 per-row
        counts) when the stage was dispatched
        with compaction and the valid count fit the budget; falls back
        to the full-buffer download + native extraction otherwise.  The
        triple ORDER is row-major (source position, then slot), the same
        order the native extraction emits."""
        over = np.asarray(self._over_buf)[: self._n]
        if self._compact is not None:
            total = int(self._total)
            if total <= self._budget:
                vals = np.asarray(self._compact)[:total]
                counts = np.asarray(self._counts)[: self._n]
                rows = np.repeat(
                    np.arange(self._n, dtype=np.int64), counts
                )
                node = (vals >> DIST_BITS).astype(np.int32)
                dist = (vals & ((1 << DIST_BITS) - 1)).astype(np.int64)
                keep = np.asarray(in_mask, dtype=bool)[node]
                u = dg.unmap_nodes(
                    np.asarray(sources, dtype=np.int32)[rows[keep]]
                ).astype(np.int64)
                v = dg.unmap_nodes(node[keep]).astype(np.int64)
                return Candidates(u, v, dist[keep]), over
        key = np.asarray(self._nodes_buf)[: self._n]
        return (
            extract_packed_candidates(dg, key, sources, ~over, in_mask),
            over,
        )


def batched_bounded_sssp_dispatch(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int,
    batch_size: int,
    compact: bool = False,
    budget: int | None = None,
) -> DispatchedStage:
    """Queue one pool-scheduled packed-output stage without waiting
    (single-device path; requires a pack_out-eligible graph, which every
    k <= 127 configuration is).  With ``compact`` the valid slots are
    compacted on device and ``fetch_candidates`` downloads only those;
    ``budget`` overrides the compact buffer size (default: a quarter of
    the slots — overruns fall back to the full download).  Compaction
    keys carry an invalid bit at 2^30, so ``compact`` needs
    (S_pad + 1) * capacity < 2^30.

    ``compact`` defaults OFF: the two-chunk pipelining already hides
    chunk A's download behind chunk B's compute, and whether the
    on-device compaction sort pays for itself on the H100 is not yet
    measured.  Parity-tested either way."""
    sources = np.asarray(sources, dtype=np.int32)
    S = len(sources)
    assert S > 0 and _can_pack_out(dg, max_weight)
    batch_size = max(1, min(batch_size, S))
    adj_packed = _can_pack_adj(dg, max_weight)
    nbr, nw = dg.device_buffers(adj_packed=adj_packed)
    if nw is None:
        nw = _dummy_nw()
    S_pad = -(-S // batch_size) * batch_size
    padded = np.full(S_pad, dg.n_nodes, dtype=np.int32)
    padded[:S] = sources
    common = dict(
        capacity=capacity,
        max_rounds=int(max_weight),
        deg_pad=dg.deg_pad,
        packed=_can_pack(dg, max_weight),
        pool=batch_size,
        adj_packed=adj_packed,
    )
    if compact:
        if (S_pad + 1) * capacity >= 1 << 30:
            raise ValueError(
                f"compact stage needs (S_pad + 1) * capacity < 2^30, got "
                f"({S_pad} + 1) * {capacity}"
            )
        if budget is None:
            budget = max(1024, (S_pad * capacity) // 4)
        budget = min(budget, (S_pad + 1) * capacity)
        cvals, counts, total, over_buf, nodes_buf = _sssp_run_pool_compact(
            nbr, nw, jnp.asarray(padded), jnp.int32(max_weight),
            budget=budget, **common,
        )
        return DispatchedStage(
            nodes_buf, over_buf, S, cvals, counts, total, budget
        )
    nodes_buf, _, over_buf = _sssp_run_pool(
        nbr, nw, jnp.asarray(padded), jnp.int32(max_weight),
        pack_out=True, **common,
    )
    return DispatchedStage(nodes_buf, over_buf, S)


def batched_bounded_sssp(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int = 128,
    batch_size: int | None = None,
    return_packed: bool = False,
    schedule: str = "batch",
):
    """All-targets bounded shortest paths from each source.

    Returns (nodes [S, C], dist [S, C], overflow [S]): per source the set
    of reachable nodes with distance <= max_weight (sentinel-padded, dist
    INF), and whether the search hit the capacity limit (incomplete).

    The whole search runs device-resident in one dispatch: sources go up
    once and the result arrays come down once.  ``schedule`` picks the
    device scheduler: "batch" runs fixed source batches to their slowest
    member's convergence (:func:`_sssp_run_batches`); "pool" keeps a
    persistent pool of ``batch_size`` lanes, retiring each source the
    round it converges or overflows and refilling immediately
    (:func:`_pool_impl`) — near-full slot occupancy under skewed
    convergence.
    """
    sources = np.asarray(sources, dtype=np.int32)
    S = len(sources)
    if S == 0:
        return (
            np.empty((0, capacity), np.int32),
            np.empty((0, capacity), np.int32),
            np.empty((0,), bool),
        )
    if batch_size is None:
        batch_size = S
    batch_size = max(1, min(batch_size, S))
    adj_packed = _can_pack_adj(dg, max_weight)
    nbr, nw = dg.device_buffers(adj_packed=adj_packed)
    if nw is None:
        nw = _dummy_nw()
    packed = _can_pack(dg, max_weight)
    pack_out = _can_pack_out(dg, max_weight)

    if schedule == "pool":
        # The pool handles ragged S natively (sentinel sources converge
        # in two rounds; idle lanes park on the trash row), but padding
        # to a pool multiple keeps the set of compiled program shapes
        # small — every distinct S_pad is a recompile.  Result rows stay
        # in source order.
        S_pad = -(-S // batch_size) * batch_size
        padded = np.full(S_pad, dg.n_nodes, dtype=np.int32)
        padded[:S] = sources
        sources_d = jnp.asarray(padded)
        nodes_buf, dist_buf, over_buf = _sssp_run_pool(
            nbr,
            nw,
            sources_d,
            jnp.int32(max_weight),
            capacity=capacity,
            max_rounds=int(max_weight),
            deg_pad=dg.deg_pad,
            packed=packed,
            pool=batch_size,
            pack_out=pack_out,
            adj_packed=adj_packed,
        )
    elif schedule == "batch":
        n_batches = -(-S // batch_size)
        S_pad = n_batches * batch_size
        padded = np.full(S_pad, dg.n_nodes, dtype=np.int32)
        padded[:S] = sources
        sources_d = jnp.asarray(padded)

        nodes_buf, dist_buf, over_buf = _sssp_run_batches(
            nbr,
            nw,
            sources_d,
            jnp.int32(max_weight),
            capacity=capacity,
            max_rounds=int(max_weight),
            deg_pad=dg.deg_pad,
            packed=packed,
            batch=batch_size,
            n_batches=n_batches,
            pack_out=pack_out,
            adj_packed=adj_packed,
        )
    else:
        raise ValueError(f"unknown schedule: {schedule!r}")
    if pack_out:
        key = np.asarray(nodes_buf)[:S]
        over = np.asarray(over_buf)[:S]
        if return_packed:
            # raw (node << DIST_BITS | dist) matrix for the native
            # extraction pass; dist slot of the return is None
            return key, None, over
        dist_cap = np.int32((1 << DIST_BITS) - 1)
        dist = key & dist_cap
        nodes = key >> DIST_BITS
        np.putmask(dist, dist == dist_cap, INF)
        return nodes, dist, over
    return (
        np.asarray(nodes_buf)[:S],
        np.asarray(dist_buf)[:S],
        np.asarray(over_buf)[:S],
    )


def extract_packed_candidates(
    dg: DeviceGraph,
    packed_key: np.ndarray,  # int32 [S, C] (node << DIST_BITS) | dist
    sources: np.ndarray,  # int32 [S] device-numbered
    done: np.ndarray,  # bool [S]: rows to extract (non-overflowed)
    in_mask: np.ndarray,  # bool/int8 [n_nodes] device-numbered
) -> Candidates:
    """Native parallel (src, dst, dist) extraction from the packed kernel
    result (native/extract.cpp): filter (1 <= dist < cap, in_mask) and
    translate ids back to original numbering in one sweep, replacing the
    numpy unpack/nonzero/gather chain."""
    import ctypes
    import os

    from .. import native

    lib = native.load()
    S, C = packed_key.shape
    packed_key = np.ascontiguousarray(packed_key, dtype=np.int32)
    sources = np.ascontiguousarray(sources, dtype=np.int32)
    done8 = np.ascontiguousarray(done, dtype=np.int8)
    mask8 = np.ascontiguousarray(in_mask, dtype=np.int8)
    to_orig = (
        np.ascontiguousarray(dg.to_orig, dtype=np.int32)
        if dg.to_orig is not None
        else None
    )
    buf_ptr = ctypes.POINTER(ctypes.c_longlong)()
    n = int(
        lib.extract_packed_triples(
            S,
            C,
            native.as_i32_ptr(packed_key),
            native.as_i32_ptr(sources),
            native.as_i8_ptr(done8),
            native.as_i8_ptr(mask8),
            native.as_i32_ptr(to_orig) if to_orig is not None else None,
            DIST_BITS,
            min(os.cpu_count() or 1, 16),
            ctypes.byref(buf_ptr),
        )
    )
    if n < 0:
        raise MemoryError("extract_packed_triples allocation failed")
    return _wrap_native_triples(lib, buf_ptr, n)


def _wrap_native_triples(lib, buf_ptr, n) -> Candidates:
    """Zero-copy Candidates over a native ``[src..., dst..., dist...]``
    triple buffer: the columns are views and ownership rides a weakref
    finalizer on the base array, so ``free_i64_buffer`` fires only after
    the last column view dies (verified: slices keep the base array as
    their ``.base``).  Replaces per-column ``np.array`` copies — 1.2GB
    of fresh first-touch allocations per search at 60M bases."""
    import weakref

    if n <= 0:
        lib.free_i64_buffer(buf_ptr)
        z = np.empty(0, dtype=np.int64)
        return Candidates(z, z.copy(), z.copy())
    flat = np.ctypeslib.as_array(buf_ptr, shape=(3 * n + 1,))
    weakref.finalize(flat, lib.free_i64_buffer, buf_ptr)
    return Candidates(flat[0:n], flat[n : 2 * n], flat[2 * n : 3 * n])


def host_dijkstra_candidates(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    in_mask: np.ndarray,
    n_threads: int | None = None,
) -> Candidates:
    """Native C++ bounded Dijkstra fan-out: (src, dst, dist) columns.

    The host half of the hybrid search: the device kernel handles the bulk
    of sources; the heavy tail (capacity overflows) and small jobs run
    here.  Also the reference-design baseline (heap + sparse map, one
    chunk per thread) used by the benchmark.
    """
    return _native_dijkstra_candidates(
        dg, sources, max_weight, in_mask, n_threads,
        fn_name="bounded_dijkstra_candidates_auto",
    )


def _native_dijkstra_candidates(
    dg, sources, max_weight, in_mask, n_threads, fn_name: str
) -> Candidates:
    """Shared driver for the growable-buffer native Dijkstra variants:
    triples are collected in thread-local C++ vectors (exact memory, no
    preallocation or overflow retry) and returned as candidate columns."""
    import ctypes
    import os

    from .. import native

    lib = native.load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, max(1, len(sources) // 256))
    n_threads = max(1, n_threads)
    sources = np.ascontiguousarray(sources, dtype=np.int64)
    mask = np.zeros(dg.n_nodes + 1, dtype=np.int8)
    mask[: len(in_mask)] = in_mask
    nbr = np.ascontiguousarray(dg.nbr, dtype=np.int32)
    nw = np.ascontiguousarray(dg.nw, dtype=np.int32)
    buf_ptr = ctypes.POINTER(ctypes.c_longlong)()
    n = int(
        getattr(lib, fn_name)(
            dg.n_nodes,
            dg.deg_pad,
            native.as_i32_ptr(nbr),
            native.as_i32_ptr(nw),
            len(sources),
            native.as_ll_ptr(sources),
            max_weight,
            native.as_i8_ptr(mask),
            n_threads,
            ctypes.byref(buf_ptr),
        )
    )
    if n < 0:
        raise MemoryError(f"{fn_name} allocation failed")
    return _wrap_native_triples(lib, buf_ptr, n)


def reference_dijkstra_candidates(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    in_mask: np.ndarray,
    n_threads: int | None = None,
) -> Candidates:
    """Independent reference-design baseline: per-source binary heap +
    hashmap distance map (the reference's default StdBinaryHeap +
    HashbrownHashMap pair, /root/reference/src/implementation/mod.rs:62-103).

    ONLY for benchmarking — the framework's own paths never call this.
    """
    return _native_dijkstra_candidates(
        dg, sources, max_weight, in_mask, n_threads,
        fn_name="reference_dijkstra_candidates",
    )


def sssp_reference_host(
    dg: DeviceGraph, source: int, max_weight: int
) -> dict[int, int]:
    """Host Dijkstra oracle (heapq) for testing the device kernel."""
    import heapq

    dist = {source: 0}
    heap = [(0, source)]
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist.get(u, INF):
            continue
        for j in range(dg.deg_pad):
            v = int(dg.nbr[u, j])
            if v == dg.n_nodes:
                continue
            nd = d + int(dg.nw[u, j])
            if nd <= max_weight and nd < dist.get(v, INF):
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist
