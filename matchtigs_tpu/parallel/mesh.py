"""Multi-chip scaling: source-batch data parallelism over a device mesh.

The reference's only parallelism is a shared-memory thread pool with a
mutex work queue (SURVEY.md §2.3 P1-P6).  The device analog per
BASELINE.json: the graph's padded adjacency is replicated to every device
(HBM-resident, read-only), the *source batch* of the bounded shortest-path
phase is sharded across a 1-D mesh axis, and results come back sharded
(allgathered on host read).  Matching and Euler stitching run replicated
and deterministic on host.

Pipeline parity with the single-device path (ops/sssp.py): the sharded
program runs the SAME one-dispatch scheduler per shard — the
persistent-pool retire/refill loop (``_pool_impl``, default) or the
``fori_loop`` batch accumulation (``_run_batches_impl``) — downloads
packed one-int32-per-slot results, and feeds the same native extraction
(:func:`matchtigs_tpu.ops.sssp.extract_packed_candidates`) — one device
dispatch per stage regardless of batch count, half the download of
unpacked results.

Load balance: sources arrive difficulty-ordered (hardest first, see
greedytigs source prep); they are striped round-robin across devices so
every device sees the same difficulty profile and local batches converge
uniformly.  Results carry their source ids, so no inverse permutation is
ever needed downstream.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.device_graph import DeviceGraph
from ..ops.sssp import (
    _can_pack,
    _can_pack_adj,
    _can_pack_out,
    _pool_impl,
    _run_batches_impl,
)

SOURCE_AXIS = "sources"


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host setup: call once per host before any jax use.

    Thin wrapper over ``jax.distributed.initialize``; afterwards
    ``make_mesh()`` spans every process's devices and
    :func:`sharded_bounded_sssp` runs SPMD across hosts (every host feeds
    the same deterministic global source array; candidate results are
    allgathered back to every host so matching and Euler stitching stay
    replicated-deterministic).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_mesh(devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (SOURCE_AXIS,))


def _make_global(mesh: Mesh, spec: P, host_value: np.ndarray):
    """Build a (possibly multi-host) global array from the host-replicated
    numpy value: every process holds the same full array and contributes
    its addressable shards."""
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(host_value, sharding)
    return jax.make_array_from_callback(
        host_value.shape, sharding, lambda idx: host_value[idx]
    )


def _to_host_global(x) -> np.ndarray:
    """Fetch a global array to host numpy on every process."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


@functools.partial(
    jax.jit,
    static_argnames=(
        "capacity", "max_rounds", "deg_pad", "packed", "batch",
        "n_batches", "pack_out", "mesh", "adj_packed",
    ),
)
def _sharded_run_batches(
    nbr,
    nw,
    sources_all,  # int32 [S_pad] sharded over the mesh axis
    max_weight,
    capacity: int,
    max_rounds: int,
    deg_pad: int,
    packed: bool,
    batch: int,
    n_batches: int,  # per-device batch count
    pack_out: bool,
    mesh: Mesh,
    adj_packed: bool = False,
):
    """The whole sharded stage as ONE device program: every device runs
    the single-device ``fori_loop`` batch accumulation over its local
    source shard; graph arrays replicated, sources/results sharded."""

    def local(nbr, nw, sources_local, max_weight):
        return _run_batches_impl(
            nbr,
            nw,
            sources_local,
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

    sharded = P(SOURCE_AXIS)
    repl = P()
    # dist_buf is a (1,1) placeholder in pack_out mode; sharding it over
    # the axis is harmless (global (n_dev, 1), never read).
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(repl, repl, sharded, repl),
        out_specs=(sharded, sharded, sharded),
    )(nbr, nw, sources_all, max_weight)


@functools.partial(
    jax.jit,
    static_argnames=(
        "capacity", "max_rounds", "deg_pad", "packed", "pool", "pack_out",
        "mesh", "adj_packed",
    ),
)
def _sharded_run_pool(
    nbr,
    nw,
    sources_all,  # int32 [S_pad] sharded over the mesh axis
    max_weight,
    capacity: int,
    max_rounds: int,
    deg_pad: int,
    packed: bool,
    pool: int,
    pack_out: bool,
    mesh: Mesh,
    adj_packed: bool = False,
):
    """Sharded persistent-pool stage: every device runs the single-device
    pool scheduler (:func:`matchtigs_tpu.ops.sssp._pool_impl`) over its
    local source shard — per-device while_loops terminate independently
    (no collectives inside), so a device that drains its shard early
    simply finishes its program early.  The per-shard trash row is
    sliced off inside the shard, keeping global rows aligned with the
    re-striped source order."""

    def local(nbr, nw, sources_local, max_weight):
        nodes_buf, dist_buf, over_buf = _pool_impl(
            nbr,
            nw,
            sources_local,
            max_weight,
            capacity=capacity,
            max_rounds=max_rounds,
            deg_pad=deg_pad,
            packed=packed,
            pool=pool,
            pack_out=pack_out,
            adj_packed=adj_packed,
        )
        if not pack_out:
            dist_buf = dist_buf[:-1]
        return nodes_buf[:-1], dist_buf, over_buf[:-1]

    sharded = P(SOURCE_AXIS)
    repl = P()
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(repl, repl, sharded, repl),
        out_specs=(sharded, sharded, sharded),
    )(nbr, nw, sources_all, max_weight)


def sharded_bounded_sssp(
    dg: DeviceGraph,
    sources: np.ndarray,
    max_weight: int,
    capacity: int = 128,
    mesh: Mesh | None = None,
    batch_size: int | None = None,
    return_packed: bool = True,
    schedule: str = "pool",
):
    """Data-parallel batched SSSP over all mesh devices, one dispatch.

    Returns ``(result, dist, overflow, srcs)`` where rows of ``result``
    correspond to ``srcs`` (the internally re-striped source order —
    results carry source ids, downstream never needs the original
    order); rows with ``srcs == dg.n_nodes`` are padding.  With
    ``return_packed`` (and a packable graph) ``result`` is the raw
    ``(node << DIST_BITS) | dist`` int32 matrix for
    :func:`~matchtigs_tpu.ops.sssp.extract_packed_candidates` and
    ``dist`` is None — identical contract to
    ``batched_bounded_sssp(..., return_packed=True)``.

    ``batch_size`` is the per-device batch; each device loops over its
    local batches inside the compiled program (one program shape, one
    dispatch per stage).
    """
    if mesh is None:
        mesh = make_mesh()
    n_dev = mesh.devices.size
    sources = np.asarray(sources, dtype=np.int32)
    S = len(sources)
    if batch_size is None:
        batch_size = max(1, -(-S // n_dev))
    batch_size = max(1, min(batch_size, max(1, -(-S // n_dev))))
    n_batches = max(1, -(-S // (batch_size * n_dev)))
    local_len = n_batches * batch_size
    S_pad = local_len * n_dev

    # Stripe sources round-robin over devices: global difficulty order
    # becomes per-device difficulty order, so each device's batch i holds
    # the same difficulty band (uniform while-loop convergence) and the
    # load is balanced.  srcs[d * local_len + j] = padded[j * n_dev + d].
    padded = np.full(S_pad, dg.n_nodes, dtype=np.int32)
    padded[:S] = sources
    srcs = np.ascontiguousarray(
        padded.reshape(local_len, n_dev).T.reshape(-1)
    )

    adj_packed = _can_pack_adj(dg, max_weight)
    nbr_d, nw_d = dg.device_buffers(adj_packed=adj_packed)
    if nw_d is None:  # placeholder operand; the static branch never reads it
        nw_d = np.zeros((1, 1), dtype=np.int32)
    nbr = _make_global(mesh, P(), nbr_d)
    nw = _make_global(mesh, P(), nw_d)
    sources_d = _make_global(mesh, P(SOURCE_AXIS), srcs)

    packed = _can_pack(dg, max_weight)
    pack_out = _can_pack_out(dg, max_weight)
    if schedule == "pool":
        nodes_buf, dist_buf, over_buf = _sharded_run_pool(
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
            mesh=mesh,
            adj_packed=adj_packed,
        )
    elif schedule == "batch":
        nodes_buf, dist_buf, over_buf = _sharded_run_batches(
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
            mesh=mesh,
            adj_packed=adj_packed,
        )
    else:
        raise ValueError(f"unknown schedule: {schedule!r}")
    overflow = _to_host_global(over_buf)
    result = _to_host_global(nodes_buf)
    if not pack_out:
        return result, _to_host_global(dist_buf), overflow, srcs
    if return_packed:
        return result, None, overflow, srcs
    from ..ops.sssp import DIST_BITS, INF

    dist_cap = np.int32((1 << DIST_BITS) - 1)
    dist = result & dist_cap
    result = result >> DIST_BITS
    np.putmask(dist, dist == dist_cap, INF)
    return result, dist, overflow, srcs


def process_source_slice(sources: np.ndarray) -> np.ndarray:
    """This process's strided slice of a host-side source set: under a
    multi-host mesh the host-routed and overflow-tail Dijkstra work
    shards across hosts by source (each host computes only its slice;
    :func:`allgather_candidates` restores the replicated candidate set).
    Identity in single-process runs."""
    n = jax.process_count()
    if n == 1:
        return sources
    return sources[jax.process_index()::n]


def allgather_candidates(c) -> "Candidates":
    """Gather per-process candidate slices into the identical replicated
    candidate set on every process, in process order (two-phase: counts,
    then max-padded triple blocks via ``process_allgather`` — per-process
    slice sizes differ, and the collective needs equal shapes).  The
    downstream accept re-sorts globally, so process order only needs to
    be deterministic, which it is."""
    from ..ops.candidates import Candidates

    n = jax.process_count()
    if n == 1:
        return c
    from jax.experimental import multihost_utils

    counts = multihost_utils.process_allgather(
        np.array([len(c)], dtype=np.int64), tiled=True
    )
    cap = int(counts.max())
    local = np.zeros((3, cap), dtype=np.int64)
    if len(c):
        local[0, : len(c)] = c.u
        local[1, : len(c)] = c.v
        local[2, : len(c)] = c.d
    blocks = multihost_utils.process_allgather(local[None], tiled=True)
    cols = [
        np.concatenate([blocks[p, i, : int(counts[p])] for p in range(n)])
        for i in range(3)
    ]
    return Candidates(cols[0], cols[1], cols[2])


def distributed_euler_break(g, k: int):
    """Per-WCC distributed Eulerian decomposition + cycle break across
    mesh PROCESSES (the downstream passes are host-side; chips don't
    help them — hosts do).  Each process runs
    :func:`matchtigs_tpu.ops.euler.decompose_break_wcc_part` on its
    share of the balanced graph's mirror-connected components, then the
    tig slices are allgathered (two-phase, like
    :func:`allgather_candidates`) and merged by their global keys into
    the byte-identical single-host tig stream
    (:func:`matchtigs_tpu.ops.euler.merge_tig_parts`).  Returns ``None``
    in single-process runs (callers fall through to the plain path).

    Reference analog: the per-WCC work split at
    /root/reference/src/implementation/matchtigs/mod.rs:555-576 — here
    distributed over hosts instead of threads, removing the largest
    fixed (replicated) cost of the multi-chip path.
    """
    n = jax.process_count()
    if n == 1:
        return None
    from ..ops.euler import decompose_break_wcc_part, merge_tig_parts
    from ..ops.walks import Walks

    walks, keys = decompose_break_wcc_part(g, k, n, jax.process_index())
    lengths = np.diff(np.asarray(walks.offsets), prepend=np.int64(0))
    from jax.experimental import multihost_utils

    counts = multihost_utils.process_allgather(
        np.array([len(keys), len(walks.flat)], dtype=np.int64), tiled=False
    )
    counts = np.asarray(counts).reshape(n, 2)
    cap_t = max(1, int(counts[:, 0].max()))
    cap_f = max(1, int(counts[:, 1].max()))
    meta_local = np.zeros((2, cap_t), dtype=np.int64)
    meta_local[0, : len(keys)] = keys
    meta_local[1, : len(keys)] = lengths
    flat_local = np.zeros(cap_f, dtype=np.int64)
    flat_local[: len(walks.flat)] = walks.flat
    meta = np.asarray(
        multihost_utils.process_allgather(meta_local[None], tiled=True)
    )
    flats = np.asarray(
        multihost_utils.process_allgather(flat_local[None], tiled=True)
    )
    parts = []
    for p in range(n):
        n_t, n_f = int(counts[p, 0]), int(counts[p, 1])
        parts.append(
            (
                Walks(flats[p, :n_f], np.cumsum(meta[p, 1, :n_t])),
                meta[p, 0, :n_t],
            )
        )
    return merge_tig_parts(parts)


@functools.partial(jax.jit, static_argnames=("n_dev", "mesh"))
def _sharded_sort_impl(hi, lo, n_dev: int, mesh: Mesh):
    """Global sort of a mesh-sharded 64-bit key vector carried as
    (hi: int32, lo: uint32) two-key pairs (jax's default x64-disable
    would silently truncate an int64 operand): per-shard two-key
    ``lax.sort`` followed by ``n_dev`` odd-even transposition rounds of
    pairwise merge-split between neighbor shards (full-shard ``ppermute``
    exchange, two-key ``lax.sort`` over the 2L concat, keep-low/keep-high
    by side).  Exact and fixed-shape — no sampling, no splitter skew, no
    overflow path (the block odd-even transposition theorem: with sorted
    blocks and compare-exchange replaced by merge-split, N rounds sort
    any input).  O(N) rounds is the proof-of-concept tradeoff; the
    O(log^2 N) bitonic schedule rides the same ppermute/merge-split
    primitives when a large device count makes it matter."""

    def local(h, lw):
        h, lw = jax.lax.sort((h, lw), num_keys=2)
        L = h.shape[0]
        idx = jax.lax.axis_index(SOURCE_AXIS)
        for r in range(n_dev):
            parity = r % 2
            pairs = [(p, p + 1) for p in range(parity, n_dev - 1, 2)]
            if not pairs:
                continue
            perm = pairs + [(b, a) for (a, b) in pairs]
            oh = jax.lax.ppermute(h, SOURCE_AXIS, perm)
            ol = jax.lax.ppermute(lw, SOURCE_AXIS, perm)
            q = idx - parity
            is_left = (q % 2 == 0) & (q >= 0) & (idx + 1 < n_dev)
            is_right = (q % 2 == 1) & (idx >= 1)
            in_pair = is_left | is_right
            mh, ml = jax.lax.sort(
                (jnp.concatenate([h, oh]), jnp.concatenate([lw, ol])),
                num_keys=2,
            )
            h = jnp.where(in_pair, jnp.where(is_left, mh[:L], mh[L:]), h)
            lw = jnp.where(in_pair, jnp.where(is_left, ml[:L], ml[L:]), lw)
        return h, lw

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(SOURCE_AXIS), P(SOURCE_AXIS)),
        out_specs=(P(SOURCE_AXIS), P(SOURCE_AXIS)),
    )(hi, lo)


def sharded_accept_key_sort(
    keys: np.ndarray, mesh: Mesh | None = None
) -> np.ndarray:
    """Mesh-sharded global sort of packed acceptance keys (``d << 56 |
    u << 28 | v``, int64, non-negative).

    The acceptance SORT is the parallel half of the greedy matching
    downstream (the reference's analog is the lock-ordered online accept,
    greedytigs/mod.rs:350-502); sharding it over the mesh removes the
    largest replicated-host pass from the multi-chip candidate->accept
    path — the sequential multiplicity SCAN that follows
    (ops/matching.py:greedy_accept_sorted_keys) stays host-side and is
    O(accepts), not O(candidates).  Pad sentinels (int64 max) sort to the
    tail and are sliced off after the gather."""
    if mesh is None:
        mesh = make_mesh()
    n_dev = int(mesh.devices.size)
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    M = len(keys)
    if n_dev == 1 or M < 2 * n_dev:
        return np.sort(keys)
    L = -(-M // n_dev)
    padded = np.full(n_dev * L, np.iinfo(np.int64).max, dtype=np.int64)
    padded[:M] = keys
    hi = (padded >> 32).astype(np.int32)
    lo = (padded & np.int64(0xFFFFFFFF)).astype(np.uint32)
    hi_g = _make_global(mesh, P(SOURCE_AXIS), hi)
    lo_g = _make_global(mesh, P(SOURCE_AXIS), lo)
    oh, ol = _sharded_sort_impl(hi_g, lo_g, n_dev=n_dev, mesh=mesh)
    out = (
        _to_host_global(oh).astype(np.int64) << 32
    ) | _to_host_global(ol).astype(np.int64)
    return out[:M]
