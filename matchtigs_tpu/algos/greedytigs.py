"""Greedy matchtigs: near-optimal tigs with bounded k-mer repetition.

Capability-equivalent of ``GreedytigAlgorithm``
(/root/reference/src/implementation/greedytigs/mod.rs:200-801), restructured
for an accelerator (SURVEY.md §7):

1. imbalance scan (vectorized) -> out-nodes / in-node target mask;
2. batched k-bounded shortest paths on device
   (:func:`matchtigs_tpu.ops.sssp.batched_bounded_sssp`) instead of
   per-source heap Dijkstras under a thread pool; with more than one
   device, source batches are sharded data-parallel over the mesh
   (:mod:`matchtigs_tpu.parallel.mesh`); sources whose search hit the
   capacity limit are retried with a larger working set (the staged
   parallelism analog of greedytigs/mod.rs:537-644);
3. deterministic global greedy matching over the candidate triples
   (:func:`matchtigs_tpu.ops.matching.greedy_accept`) replaces the
   lock-based online matching;
4. accepted paths become cheap dummy biedges (weight = distance < k); the
   deterministic breaking balancer + Eulerian decomposition + cycle break
   finish exactly as in eulertigs.

Search statistics (executed searches, rounds, retries, candidates) are
collected per run — the analog of the reference's opt-in Dijkstra
performance counters (greedytigs/mod.rs:646-673).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..graph.bigraph import Bigraph
from ..ops import euler
from ..ops.candidates import Candidates
from ..ops.device_graph import build_device_graph
from ..ops.matching import greedy_accept, unbalanced_nodes
from ..ops.sssp import INF, batched_bounded_sssp

logger = logging.getLogger(__name__)


@dataclass
class GreedytigConfig:
    k: int
    # Result-slot capacity C of the first device stage (the per-source
    # working set of the batched search).  Balls are tiny for most
    # sources (the k-1 distance bound caps the radius), so a small C
    # keeps the kernel's sort width minimal; sources that overflow it
    # finish on the host tail (overflow_mode="host") or re-run through
    # the 4x capacity ladder.  Deep-ball regimes (k >= 63) should raise
    # this.  Not yet measured on the H100.
    initial_capacity: int = 4
    max_capacity: int = 1 << 16
    # Device lane count (pool size, or batch size of the batch
    # schedule).  Not yet measured on the H100.
    batch_size: int = 4096
    # "auto": shard source batches over the mesh when >1 device is
    # available; True/False force it.
    use_mesh: bool | str = "auto"
    # Overflow handling: "host" finishes capacity-overflow sources with
    # the native C++ Dijkstra (single device program shape; the tail is a
    # tiny fraction of sources); "ladder" retries on device with 4x
    # capacity per stage (one compiled shape per stage).
    overflow_mode: str = "host"
    # Device scheduler: "pool" keeps a persistent pool of batch_size
    # lanes, retiring each source the round it converges or overflows
    # and refilling from the stream (near-full slot occupancy under
    # skewed convergence); "batch" runs fixed batches to their slowest
    # member's convergence (ops/sssp.py).
    device_schedule: str = "pool"
    # Sources whose minimum incident edge weight is <= this threshold are
    # routed straight to the native host Dijkstra, running concurrently
    # with the device batches (they sit in dense tangles with deep
    # multi-hop balls, exactly the ones that overflow the device working
    # set and gate batch convergence).  -1 disables the split.
    # Not yet measured on the H100.
    host_route_threshold: int = 1
    # Reverse-Cuthill-McKee node renumbering for device-memory gather
    # locality; its serial scipy BFS costs host time, so it is off by
    # default.  Not yet measured on the H100.
    renumber: bool = False
    # Threads for the native host Dijkstra (None = all cores).
    host_threads: int | None = None
    # Search engine: "auto" uses the device kernel when an accelerator is
    # present and the native host Dijkstra otherwise (running the batched
    # kernel on the XLA CPU backend is strictly slower than the native
    # engine); "device"/"host" force one side.
    engine: str = "auto"
    # Opt-in per-source search counters (ball-size histogram, max/avg) —
    # the analog of the reference's --dijkstra-performance-data-type
    # Complete heap/distance-array statistics (greedytigs/mod.rs:646-673).
    performance_counters: bool = False
    # Host search strategy — the analog of the reference's monomorphized
    # Dijkstra strategy selection (--dijkstra-node-weight-array-type,
    # /root/reference/src/implementation/mod.rs:62-83, dispatch
    # greedytigs/mod.rs:92-198): "dial" = Dial-bucket queue + dense epoch
    # distance arrays (the framework default, analog of
    # EpochNodeWeightArray); "heap" = per-source binary heap + hashmap
    # distance map (the reference's default HashbrownHashMap semantics).
    host_strategy: str = "dial"


@dataclass
class SearchStats:
    """Counters for the shortest-path phase (reference analog:
    DijkstraPerformanceCounter, greedytigs/mod.rs:646-673)."""

    sources: int = 0
    candidates: int = 0
    retries: int = 0
    capacity_final: int = 0
    stage_sources: list[int] = field(default_factory=list)
    # Depth analogs of the reference's heap/distance-array counters
    # (greedytigs/mod.rs:646-673): per device stage, the fraction of
    # working-set slots holding a live entry (occupancy; 1-occupancy is
    # the wasted sort width) and the overflow fraction that forced a
    # retry/host tail.
    host_routed: int = 0
    stage_times: list[float] = field(default_factory=list)
    stage_occupancy: list[float] = field(default_factory=list)
    stage_overflow_frac: list[float] = field(default_factory=list)

    def log_ball_sizes(self, candidates: "Candidates", n_nodes: int,
                       out_nodes: np.ndarray) -> None:
        """Per-source candidate-ball statistics (opt-in; the analog of the
        reference's max/average heap and distance-array size counters,
        greedytigs/mod.rs:646-673).  A source's "ball" here is its number
        of reported in-node candidates within the distance bound."""
        counts = np.bincount(
            candidates.u, minlength=n_nodes
        )[np.asarray(out_nodes, dtype=np.int64)]
        if not len(counts):
            return
        logger.info(
            "Ball sizes: max %d, mean %.1f, median %d "
            "(%d sources with zero candidates)",
            int(counts.max()),
            float(counts.mean()),
            int(np.median(counts)),
            int((counts == 0).sum()),
        )
        hist = np.bincount(
            np.where(counts > 0, np.log2(np.maximum(counts, 1)).astype(int) + 1, 0)
        )
        for b, n in enumerate(hist):
            if n:
                lo = 0 if b == 0 else 1 << (b - 1)
                hi = 0 if b == 0 else (1 << b) - 1
                logger.info("  ball size %s: %d sources",
                            "0" if b == 0 else f"[{lo}, {hi}]", int(n))

    def log(self) -> None:
        logger.info(
            "Search stats: %d sources (%d host-routed), %d candidates, "
            "%d capacity retries (stage sizes %s, final capacity %d)",
            self.sources,
            self.host_routed,
            self.candidates,
            self.retries,
            self.stage_sources,
            self.capacity_final,
        )
        for i, (t, occ, ovf) in enumerate(
            zip(self.stage_times, self.stage_occupancy, self.stage_overflow_frac)
        ):
            logger.info(
                "  device stage %d: %.2fs, slot occupancy %.1f%% "
                "(wasted %.1f%%), overflow %.2f%%",
                i,
                t,
                100 * occ,
                100 * (1 - occ),
                100 * ovf,
            )


def _want_mesh(config: GreedytigConfig) -> bool:
    if config.use_mesh == "auto":
        if config.engine == "host":
            return False  # the host engine never starts a device backend
        import jax

        return len(jax.devices()) > 1
    return bool(config.use_mesh)


def _host_search_fn(config: GreedytigConfig):
    """Resolve the host search engine from the strategy selection."""
    from ..ops import sssp

    if config.host_strategy == "heap":
        return sssp.reference_dijkstra_candidates
    if config.host_strategy != "dial":
        raise ValueError(f"unknown host_strategy: {config.host_strategy!r}")
    return sssp.host_dijkstra_candidates


def _use_host_engine(config: GreedytigConfig) -> bool:
    """True when the search should skip the device kernel entirely.

    ``engine="host"``/``"device"`` are obeyed as given.  ``"auto"`` runs
    the native host Dijkstra only when JAX has a single CPU device (the
    batched kernel on XLA's CPU backend loses to the native engine) and
    the device kernel otherwise: on a GPU, and on a multi-device CPU
    mesh, which the tests use to exercise the sharded path.  The choice
    is logged at WARNING.  A backend that fails to initialise raises."""
    if config.engine == "host":
        return True
    if config.engine == "device":
        return False
    if config.engine != "auto":
        raise ValueError(f"unknown engine: {config.engine!r}")
    try:
        from .. import native

        native.load()
    except ImportError as e:
        logger.warning("engine=auto: device kernel (native host engine "
                       "unavailable: %s)", e)
        return False
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform == "cpu" and len(devices) == 1:
        logger.warning("engine=auto: native host Dijkstra (JAX has one CPU "
                       "device and no accelerator)")
        return True
    logger.warning("engine=auto: device kernel on %d %s device(s)",
                   len(devices), platform)
    return False


def collect_candidates(
    g: Bigraph,
    out_nodes: np.ndarray,
    in_mask: np.ndarray,
    k: int,
    config: GreedytigConfig,
    stats: SearchStats | None = None,
    return_chunks: bool = False,
) -> Candidates:
    """Run the batched bounded SSSP and extract (out, in, dist) columns.

    ``return_chunks`` skips the final column concatenation and returns
    the per-producer chunk list instead (device extraction, host-routed,
    overflow tail): greedy acceptance packs chunks straight into its
    sort key, so the 1.2GB three-column concat at 60M bases — the
    device-led path's largest page-fault surface — never materializes.
    """
    import time

    if _use_host_engine(config):
        host_dijkstra = _host_search_fn(config)

        dg = build_device_graph(g, renumber=False)
        stats = stats if stats is not None else SearchStats()
        stats.sources = len(out_nodes)
        stats.host_routed = len(out_nodes)
        t0 = time.monotonic()
        res = host_dijkstra(
            dg,
            np.asarray(out_nodes, dtype=np.int64),
            k - 1,
            in_mask,
            n_threads=config.host_threads,
        )
        logger.info(
            "Native host Dijkstra (engine=%s): %d sources, "
            "%d candidates in %.2fs",
            config.engine,
            len(out_nodes),
            len(res),
            time.monotonic() - t0,
        )
        stats.candidates = len(res)
        return [res] if return_chunks else res

    t_phase = time.monotonic()
    dg = build_device_graph(g, renumber=config.renumber)
    logger.info("Device graph build (renumber=%s): %.2fs", config.renumber,
                time.monotonic() - t_phase)
    t_phase = time.monotonic()
    sentinel = dg.sentinel
    if dg.to_orig is not None:
        in_mask = np.asarray(in_mask)[dg.to_orig]
    stats = stats if stats is not None else SearchStats()
    stats.sources = len(out_nodes)
    use_mesh = _want_mesh(config)
    if use_mesh:
        from ..parallel.mesh import make_mesh, sharded_bounded_sssp

        mesh = make_mesh()
    else:
        # Start the adjacency upload now (dispatch is async): the
        # transfer runs while source prep and the concurrent host
        # Dijkstra launch below do host work.  Same packed/unpacked
        # choice as the kernel dispatch (ops/sssp.py) so the upload is
        # the one the stage reuses.
        from ..ops.sssp import _can_pack_adj

        dg.device_buffers(adj_packed=_can_pack_adj(dg, k - 1))
    chunks: list[Candidates] = []

    pending = dg.map_sources(np.asarray(out_nodes, dtype=np.int32))
    # Order sources by a difficulty proxy (their minimum incident edge
    # weight: small weights mean deep multi-hop balls) so each batch's
    # while-loop converges uniformly instead of every batch paying for its
    # single hardest source.  Results carry source ids, so no inverse
    # permutation is needed, and downstream acceptance re-sorts globally.
    difficulty = dg.nw.min(axis=1)[pending]
    host_thread = None
    host_result: list[Candidates] = []
    host_error: list[BaseException] = []
    host_available = True
    if config.host_route_threshold >= 0 or config.overflow_mode == "host":
        try:
            from .. import native

            native.load()
        except ImportError:
            host_available = False
            logger.warning(
                "native host Dijkstra unavailable; disabling host routing "
                "and using the on-device capacity ladder"
            )
    hard_sources = None
    if config.host_route_threshold >= 0 and host_available:
        hard = difficulty <= config.host_route_threshold
        if hard.any() and not hard.all():
            hard_sources = pending[hard]
            stats.host_routed = len(hard_sources)
            pending = pending[~hard]
            difficulty = difficulty[~hard]
            logger.info(
                "Routing %d dense-tangle sources to the host Dijkstra",
                len(hard_sources),
            )
    # primary: difficulty descending; secondary: device node id ascending
    # (gather locality).  One packed value sort (numpy's SIMD int64 sort)
    # instead of a two-key lexsort.
    if len(pending):
        maxd = np.int64(int(difficulty.max()))
        key = ((maxd - difficulty.astype(np.int64)) << 32) | pending.astype(
            np.int64
        )
        key.sort()
        pending = (key & np.int64(0xFFFFFFFF)).astype(pending.dtype)
    if time.monotonic() - t_phase > 0.5:
        logger.info("Source prep (difficulty order + host routing split): "
                    "%.2fs", time.monotonic() - t_phase)
    capacity = config.initial_capacity
    batch_size = config.batch_size

    # Two-chunk overlapped stage (single device, pool schedule, host
    # tail): the sources split into two equal-difficulty stripes whose
    # programs queue back to back on the device, so chunk A's result
    # download, native extraction, and overflow host tail all run while
    # chunk B computes, hiding serial post-stage host work.  Identical
    # candidate set (chunk-vs-one-shot
    # equality is tested); same ONE compiled program shape when the
    # stripes pad to the same length.
    from ..ops.sssp import _can_pack_out

    use_chunked = (
        not use_mesh
        and config.device_schedule == "pool"
        and config.overflow_mode == "host"
        and host_available
        and len(pending) >= 8 * batch_size
        and _can_pack_out(dg, k - 1)
    )
    if hard_sources is not None and not use_chunked:
        # Mesh / non-chunked paths keep the concurrent-thread shape (the
        # chunked path above runs it inline between dispatch and fetch).
        import threading

        host_dijkstra_candidates = _host_search_fn(config)

        def run_host():
            try:
                # Under a multi-host mesh each host computes only its
                # source slice; the collective that restores the
                # replicated set runs at the MAIN-thread join (issuing
                # it here would race the stage's own collectives —
                # cross-process collective order must be uniform).
                srcs_h = hard_sources
                if use_mesh:
                    from ..parallel.mesh import process_source_slice

                    srcs_h = process_source_slice(hard_sources)
                res = host_dijkstra_candidates(
                    dg, srcs_h, k - 1, in_mask,
                    n_threads=config.host_threads,
                )
                if len(res):
                    res.u = dg.unmap_nodes(res.u)
                    res.v = dg.unmap_nodes(res.v)
                host_result.append(res)
            except BaseException as e:  # re-raised on the main thread
                host_error.append(e)

        host_thread = threading.Thread(target=run_host)
        host_thread.start()
    if use_chunked:
        from ..ops.sssp import batched_bounded_sssp_dispatch

        host_dijkstra_tail = _host_search_fn(config)
        halves = [pending[0::2], pending[1::2]]
        stats.stage_sources.append(len(pending))
        stats.capacity_final = capacity
        t_dev = time.monotonic()
        handles = [
            batched_bounded_sssp_dispatch(dg, h, k - 1, capacity, batch_size)
            for h in halves
        ]
        # Host-routed dense tangles run HERE, on the main thread, while
        # the dispatched chunks compute on the device: the device makes
        # full progress without host CPU, and the result downloads start
        # only after the host cores are free again.  The mesh and
        # non-chunked paths run the same work in a concurrent thread
        # instead; which ordering wins on the H100 is not yet measured.
        host_routed_s = 0.0
        if hard_sources is not None:
            t_h = time.monotonic()
            res = _host_search_fn(config)(
                dg, hard_sources, k - 1, in_mask,
                n_threads=config.host_threads,
            )
            if len(res):
                res.u = dg.unmap_nodes(res.u)
                res.v = dg.unmap_nodes(res.v)
                chunks.append(res)
            host_routed_s = time.monotonic() - t_h
            logger.info(
                "Host-routed Dijkstra (%d sources) under device compute: "
                "%.2fs", len(hard_sources), host_routed_s,
            )
        # Overflow-tail policy: a SMALL tail overlaps chunk B's
        # compute/download in a thread; a big one runs inline after the
        # fetch loop, so it does not compete with the downloads for host
        # cores.  The size cut is not yet measured on the H100.
        tail_overlap_max = 1 << 18
        pend_tail: list[np.ndarray] = []
        tail_threads: list = []
        tail_results: list[Candidates] = []
        tail_errors: list[BaseException] = []
        n_overflow = 0
        n_kept = 0
        n_done_slots = 0
        for ci, (srcs_h, handle) in enumerate(zip(halves, handles)):
            t_ext = time.monotonic()
            tri, over = handle.fetch_candidates(dg, srcs_h, in_mask)
            done = ~over
            logger.info(
                "Fetched %d triples from %dx%d slots in %.2fs",
                len(tri), len(srcs_h), capacity,
                time.monotonic() - t_ext,
            )
            if len(tri):
                chunks.append(tri)
            n_overflow += int(over.sum())
            n_kept += len(tri)
            n_done_slots += int(done.sum()) * capacity
            pend_h = srcs_h[over]
            if not len(pend_h):
                continue
            if ci + 1 < len(halves) and len(pend_h) <= tail_overlap_max:
                import threading as _threading

                def run_tail(p=pend_h):
                    try:
                        t = host_dijkstra_tail(
                            dg, p, k - 1, in_mask,
                            n_threads=config.host_threads,
                        )
                        if len(t):
                            t.u = dg.unmap_nodes(t.u)
                            t.v = dg.unmap_nodes(t.v)
                        tail_results.append(t)
                    except BaseException as e:
                        tail_errors.append(e)

                th = _threading.Thread(target=run_tail)
                th.start()
                tail_threads.append(th)
            else:
                pend_tail.append(pend_h)
        stage_t = time.monotonic() - t_dev
        logger.info(
            "Device stage (2 overlapped chunks): %d sources in %.2fs"
            " (%.2fs of host-routed Dijkstra overlapped under compute)",
            len(pending), stage_t, host_routed_s,
        )
        stats.stage_times.append(stage_t)
        stats.stage_overflow_frac.append(n_overflow / max(1, len(pending)))
        stats.stage_occupancy.append(n_kept / max(1, n_done_slots))
        if n_overflow:
            stats.retries += 1
            stats.stage_sources.append(n_overflow)
        if pend_tail:
            t_tail = time.monotonic()
            t = host_dijkstra_tail(
                dg, np.concatenate(pend_tail), k - 1, in_mask,
                n_threads=config.host_threads,
            )
            if len(t):
                t.u = dg.unmap_nodes(t.u)
                t.v = dg.unmap_nodes(t.v)
                chunks.append(t)
            logger.info(
                "Finished %d overflowed sources on host in %.2fs",
                sum(len(p) for p in pend_tail), time.monotonic() - t_tail,
            )
        if tail_threads:
            t_join = time.monotonic()
            for th in tail_threads:
                th.join()
            if tail_errors:
                raise tail_errors[0]
            chunks.extend(t for t in tail_results if len(t))
            logger.info(
                "Small overflow tail overlapped with chunk B (join wait "
                "%.2fs)", time.monotonic() - t_join,
            )
        pending = pending[:0]

    while len(pending) > 0:
        stats.stage_sources.append(len(pending))
        stats.capacity_final = capacity
        t_dev = time.monotonic()
        if use_mesh:
            # Same pipeline as the single-device path: one dispatch for
            # the whole stage (per-shard fori_loop batching), packed
            # downloads, shared native extraction below.  Result rows
            # follow the re-striped source order (row_sources); padding
            # rows carry the sentinel source id.
            nodes, dist, overflow, row_sources = sharded_bounded_sssp(
                dg,
                pending,
                max_weight=k - 1,
                capacity=capacity,
                mesh=mesh,
                batch_size=batch_size,
                return_packed=host_available,
                schedule=config.device_schedule,
            )
            real = row_sources != np.int32(dg.n_nodes)
        else:
            nodes, dist, overflow = batched_bounded_sssp(
                dg,
                pending,
                max_weight=k - 1,
                capacity=capacity,
                batch_size=batch_size,
                return_packed=host_available,
                schedule=config.device_schedule,
            )
            row_sources = pending
            real = None
        stage_t = time.monotonic() - t_dev
        logger.info("Device stage: %d sources in %.2fs", len(pending), stage_t)
        stats.stage_times.append(stage_t)
        stats.stage_overflow_frac.append(
            float(overflow.sum()) / max(1, len(pending))
        )
        done = ~overflow if real is None else (~overflow & real)
        if dist is None:
            # Packed result: native parallel filter + id translation
            # (replaces the numpy unpack/nonzero/gather chain below).
            from ..ops.sssp import extract_packed_candidates

            t_ext = time.monotonic()
            tri = extract_packed_candidates(
                dg, nodes, row_sources, done, in_mask
            )
            logger.info(
                "Extracted %d triples from %dx%d packed slots in %.2fs",
                len(tri), nodes.shape[0], nodes.shape[1],
                time.monotonic() - t_ext,
            )
            if len(tri):
                chunks.append(tri)
            # post-filter occupancy (kept-candidate slots / done slots);
            # the pre-mask number needs the unpacked dist matrix, which
            # this path exists to avoid materializing
            stats.stage_occupancy.append(
                float(len(tri)) / max(1, int(done.sum()) * nodes.shape[1])
            )
        else:
            live = (dist >= 1) & (dist < INF)
            stats.stage_occupancy.append(
                float(live.sum()) / max(1, dist.size)
            )
            if np.any(done):
                dn = nodes[done]
                dd = dist[done]
                srcs = row_sources[done]
                valid = (dn != sentinel) & (dd >= 1) & (dd < INF)
                valid &= in_mask[np.minimum(dn, len(in_mask) - 1)]
                s_idx, c_idx = np.nonzero(valid)
                if len(s_idx):
                    chunks.append(
                        Candidates(
                            dg.unmap_nodes(srcs[s_idx]).astype(np.int64),
                            dg.unmap_nodes(dn[s_idx, c_idx]).astype(np.int64),
                            dd[s_idx, c_idx].astype(np.int64),
                        )
                    )
        pending = (
            pending[overflow] if real is None else row_sources[overflow & real]
        )
        if len(pending) > 0:
            if config.overflow_mode == "host" and host_available:
                # Finish the heavy tail with the native host Dijkstra
                # (keeps a single compiled device program shape).  Under a
                # multi-host mesh each host computes only its source slice
                # and the set is allgathered back (main thread: collective
                # order stays uniform across processes).
                host_dijkstra_candidates = _host_search_fn(config)

                stats.retries += 1
                stats.stage_sources.append(len(pending))
                t_tail = time.monotonic()
                tail_srcs = pending
                if use_mesh:
                    from ..parallel.mesh import (
                        allgather_candidates,
                        process_source_slice,
                    )

                    tail_srcs = process_source_slice(pending)
                tail = host_dijkstra_candidates(
                    dg, tail_srcs, k - 1, in_mask,
                    n_threads=config.host_threads,
                )
                logger.info(
                    "Finished %d overflowed sources on host in %.2fs",
                    len(pending),
                    time.monotonic() - t_tail,
                )
                if len(tail):
                    tail.u = dg.unmap_nodes(tail.u)
                    tail.v = dg.unmap_nodes(tail.v)
                if use_mesh:
                    tail = allgather_candidates(tail)
                if len(tail):
                    chunks.append(tail)
                break
            if capacity >= config.max_capacity:
                raise RuntimeError(
                    f"SSSP capacity {capacity} exhausted for {len(pending)} sources"
                )
            capacity *= 4
            batch_size = max(8, batch_size // 4)
            stats.retries += 1
            logger.info(
                "Retrying %d overflowed sources with capacity %d",
                len(pending),
                capacity,
            )

    if host_thread is not None:
        t_phase = time.monotonic()
        host_thread.join()
        logger.info("Waited %.2fs for the concurrent host Dijkstra",
                    time.monotonic() - t_phase)
        if host_error:
            raise host_error[0]
        if host_result:
            res = host_result[0]
            if use_mesh:
                from ..parallel.mesh import allgather_candidates

                res = allgather_candidates(res)
            if len(res):
                chunks.append(res)

    if return_chunks:
        stats.candidates = sum(len(c) for c in chunks)
        return chunks
    t_cat = time.monotonic()
    result = Candidates.concat(chunks)
    if time.monotonic() - t_cat > 0.5:
        logger.info("Candidate concat (%d rows) took %.2fs", len(result),
                    time.monotonic() - t_cat)
    stats.candidates = len(result)
    return result


def compute_greedytigs(
    g: Bigraph, config: GreedytigConfig, stats: SearchStats | None = None
) -> "Walks":
    """Mutates `g` (adds dummy biedges) and returns edge walks.

    ``stats``, when given, is filled in place with the search-phase
    counters (device stage times/occupancy, host-routed counts) so
    callers — bench.py reports the per-chip device sources/s from it —
    can read them without re-running the search.
    """
    import time

    t_start = time.monotonic()
    k = config.k
    out_nodes, in_mask, mult = unbalanced_nodes(g)
    logger.info(
        "Found %d nodes with missing outgoing and %d with missing incoming edges",
        len(out_nodes),
        int(in_mask.sum()),
    )

    t0 = time.monotonic()
    stats = stats if stats is not None else SearchStats()
    candidates = collect_candidates(
        g, out_nodes, in_mask, k, config, stats, return_chunks=True
    )
    stats.log()
    if config.performance_counters and stats.candidates:
        # the opt-in ball counters need the concatenated columns
        candidates = Candidates.concat(candidates)
        stats.log_ball_sizes(candidates, g.n_nodes, out_nodes)
    logger.info(
        "Found %d candidate shortest paths in %.2fs (scan %.2fs)",
        stats.candidates,
        time.monotonic() - t0,
        t0 - t_start,
    )

    t0 = time.monotonic()
    accepted = None
    if _want_mesh(config) and isinstance(candidates, list):
        # Mesh pipeline: the acceptance SORT runs sharded over the mesh
        # (parallel/mesh.py:sharded_accept_key_sort); only the O(accepts)
        # multiplicity scan stays host-side.  Falls through to the host
        # accept when the ids/dists exceed the packed-key ranges.
        from ..ops.matching import greedy_accept_sorted_keys, pack_accept_keys

        keys = pack_accept_keys(candidates)
        if keys is not None:
            from ..parallel.mesh import sharded_accept_key_sort

            sorted_keys = sharded_accept_key_sort(keys)
            accepted = greedy_accept_sorted_keys(g, sorted_keys, mult)
            logger.info("Acceptance sort ran sharded over the mesh")
    if accepted is None:
        accepted = greedy_accept(g, candidates, mult)
    logger.info(
        "Accepted %d paths as cheap dummy edges in %.2fs",
        len(accepted),
        time.monotonic() - t0,
    )

    dummy_edge_id = 0
    if len(accepted):
        n = len(accepted)
        dummy_ids = np.arange(1, n + 1, dtype=np.int64)
        g.add_biedge_pairs(
            src=accepted[:, 0].astype(np.int32),
            dst=accepted[:, 1].astype(np.int32),
            weight=accepted[:, 2],
            handle=np.full(n, -1, dtype=np.int64),
            forward=np.ones(n, dtype=bool),
            dummy_id=dummy_ids,
        )
        dummy_edge_id = n

    # Full-graph invariant scans: debug_assert! analogs, off in production
    # (utils/debug.py) — they cost ~0.9s + an in-CSR build at 60M bases.
    from ..utils.debug import debug_checks

    if debug_checks():
        assert g.verify_node_pairing()
        assert g.verify_edge_mirror_property()

    t0 = time.monotonic()
    logger.info("Making graph Eulerian by adding breaking dummy edges")
    euler.make_eulerian_with_breaking_edges(g, k, dummy_edge_id)
    if not euler.decomposes_into_eulerian_bicycles(g):
        raise AssertionError("Failed to make the graph Eulerian")
    if debug_checks():
        euler.assert_no_consecutive_dummy_edges(g, k)
    logger.info("Balancing took %.2fs", time.monotonic() - t0)

    t0 = time.monotonic()
    tigs = None
    if _want_mesh(config):
        # Multi-host: euler+break distribute per-WCC over processes
        # (byte-identical merge; parallel/mesh.py:distributed_euler_break).
        try:
            from .. import native

            native.load()
            import jax

            if jax.process_count() > 1:
                from ..parallel.mesh import distributed_euler_break

                tigs = distributed_euler_break(g, k)
                if tigs is not None:
                    logger.info(
                        "Euler+break ran per-WCC distributed over %d "
                        "processes", jax.process_count(),
                    )
        except ImportError:
            pass
    if tigs is None:
        cycles = euler.eulerian_bicycle_decomposition(g)
        logger.info("Found %d Eulerian bicycles", len(cycles))
        tigs = euler.break_cycles(g, cycles, k)
    logger.info(
        "Found %d greedytigs (euler+break %.2fs, total %.2fs)",
        len(tigs),
        time.monotonic() - t0,
        time.monotonic() - t_start,
    )
    return tigs
