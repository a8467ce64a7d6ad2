"""Benchmark: greedy matchtigs throughput on the available device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "unitigs/s", "vs_baseline": N}

Dataset: synthetic pangenome unitigs (10M-base genome, 7 strains, 1%
mutations, repeat families + satellite arrays, k=31 -- the BASELINE.json
config-5 analog; no external datasets are reachable from this
environment).  Deterministic; cached on disk after the first generation.

value: unitigs processed per second by the full greedy-matchtigs compute
(batched bounded SSSP on device + native matching + Euler stitching),
measured after warmup (compile excluded, as steady-state throughput).

vs_baseline: ratio against an INDEPENDENT reference-design baseline,
measured in-run (the reference publishes no numbers): a
multithreaded C++ pipeline whose candidate phase is a per-source binary
heap + hashmap-distance Dijkstra — the reference's default strategy pair
(StdBinaryHeap + HashbrownHashMap,
/root/reference/src/implementation/mod.rs:62-103) — code the framework's
own execution paths never call (native/tigs.cpp:reference_dijkstra_*).
The downstream matching/Euler passes are shared, so the ratio isolates
the search-engine design difference on identical outputs.

The device phase runs in this process when JAX's platform is ``gpu``
(device keys are null without one); a failure in it exits non-zero.
Only one process may drive the card, so nothing here starts another.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

logging.basicConfig(level=logging.WARNING)

GENOME_LENGTH = 10_000_000
K = 31
N_STRAINS = 7
MUTATION_RATE = 0.01
SEED = 0
CAPACITY = 4  # GreedytigConfig default; not yet measured on the H100
BATCH_SIZE = 4096  # GreedytigConfig default; not yet measured on the H100
DATA_CACHE = str(Path(__file__).parent / ".bench_data")

# North-star-scale certification (BASELINE.json config 4/5 analog): the
# 60M-base / 10.2M-node / 7.84M-unitig pangenome, the scale where the
# device path leads and the multi-chip projection is anchored.  Runs
# after the flagship phases; skippable for quick local iterations with
# MATCHTIGS_BENCH_60M=0.  Dataset cached in .bench_data (generation is
# ~50 min cold).
SCALE60M_GENOME = 60_000_000


def _load_dataset(genome_length: int = GENOME_LENGTH):
    from matchtigs_tpu.utils.malloc_tuning import tune_malloc

    tune_malloc()
    from matchtigs_tpu import testing
    from matchtigs_tpu.graph.build import build_bigraph_from_unitigs

    store, kmers, k = testing.make_pangenome_store(
        genome_length=genome_length,
        k=K,
        n_strains=N_STRAINS,
        mutation_rate=MUTATION_RATE,
        seed=SEED,
        cache_dir=DATA_CACHE,
        with_repeats=True,
    )
    g = build_bigraph_from_unitigs(store, k)
    return store, kmers, k, g


def on_gpu() -> bool:
    import jax

    return jax.devices()[0].platform == "gpu"


def device_run(store, kmers, k, g) -> dict:
    """Timed device greedytigs on the loaded dataset (min of 3 reps)."""
    import jax

    from matchtigs_tpu.algos.greedytigs import (
        GreedytigConfig,
        SearchStats,
        compute_greedytigs,
    )
    from matchtigs_tpu.ops.device_graph import build_device_graph
    from matchtigs_tpu.ops.matching import unbalanced_nodes

    out_nodes, _, _ = unbalanced_nodes(g)
    print(
        f"device phase: {len(store)} unitigs, {len(kmers)} kmers, "
        f"{len(out_nodes)} sources on {jax.devices()[0]}",
        file=sys.stderr,
    )

    # Warm up with the SAME packing the pipeline uses (renumber=False is
    # the GreedytigConfig default): the memoized device graph and its
    # uploaded device buffers are then reused inside the timed run —
    # symmetric with the host pipeline, whose timer also starts after
    # build_device_graph.  A full pipeline pass (not just one kernel
    # batch) also primes the production program shapes, so compiles stay
    # out of the steady-state number.
    dg = build_device_graph(g, renumber=False)
    dg.device_buffers()  # upload once, before the timer
    cfg = GreedytigConfig(
        k=k, initial_capacity=CAPACITY, batch_size=BATCH_SIZE,
        engine="device",
    )
    t0 = time.monotonic()
    compute_greedytigs(g.copy(), cfg)
    print(f"warmup(compile+pass): {time.monotonic() - t0:.1f}s", file=sys.stderr)

    # min of three timed passes: host page faults can inflate a single
    # pass and hit random phases.  The stage metrics
    # travel with the best rep (stage_times holds one entry per device
    # stage; stage_sources pairs with it positionally — the host-tail
    # append, if any, trails and is dropped by zip).  Note the stage
    # wall now INCLUDES the host-routed Dijkstra overlapped under the
    # device compute (dispatch->host->fetch ordering).
    best = None
    for rep in range(3):
        g_rep = g.copy()  # outside the timer, like the host path's caller
        t0 = time.monotonic()
        stats = SearchStats()
        tigs = compute_greedytigs(g_rep, cfg, stats=stats)
        el = time.monotonic() - t0
        dev_sources = sum(
            s for s, _ in zip(stats.stage_sources, stats.stage_times)
        )
        dev_stage_s = sum(stats.stage_times)
        print(
            f"  device rep {rep}: {el:.2f}s (stage {dev_stage_s:.2f}s)",
            file=sys.stderr,
        )
        if best is None or el < best["elapsed"]:
            best = {
                "elapsed": el,
                "tigs": len(tigs),
                "device_stage_s": dev_stage_s,
                "device_stage_sources": dev_sources,
            }
    elapsed = best["elapsed"]
    print(
        f"device greedytigs: {elapsed:.2f}s -> {len(store)/elapsed:.0f} "
        f"unitigs/s, {best['tigs']} tigs; device stage "
        f"{best['device_stage_sources']} sources in "
        f"{best['device_stage_s']:.2f}s",
        file=sys.stderr,
    )
    return best


def host_greedytigs_time(store, k, g, reference_design: bool = False) -> float:
    """Host greedy-matchtigs pipeline timing.

    reference_design=False: the framework's host execution path (native
    Dial-bucket epoch-array Dijkstra + matching + Euler).
    reference_design=True: the independent baseline — same pipeline but
    the candidate phase is the binary-heap + hashmap Dijkstra the
    framework never uses (reference default semantics).
    """
    from matchtigs_tpu.ops import euler as euler_ops
    from matchtigs_tpu.ops.device_graph import build_device_graph
    from matchtigs_tpu.ops.matching import greedy_accept, unbalanced_nodes
    from matchtigs_tpu.ops.sssp import (
        host_dijkstra_candidates,
        reference_dijkstra_candidates,
    )

    search = (
        reference_dijkstra_candidates
        if reference_design
        else host_dijkstra_candidates
    )
    out_nodes, in_mask, mult = unbalanced_nodes(g)
    dg = build_device_graph(g)
    t0 = time.monotonic()
    cands = search(dg, out_nodes, k - 1, in_mask)
    search_time = time.monotonic() - t0
    acc = greedy_accept(g, cands, mult)
    n = len(acc)
    if n:
        g.add_biedge_pairs(
            acc[:, 0].astype(np.int32),
            acc[:, 1].astype(np.int32),
            acc[:, 2],
            np.full(n, -1, dtype=np.int64),
            np.ones(n, dtype=bool),
            np.arange(1, n + 1, dtype=np.int64),
        )
    euler_ops.make_eulerian_with_breaking_edges(g, k, n)
    cycles = euler_ops.eulerian_bicycle_decomposition(g)
    euler_ops.break_cycles(g, cycles, k)
    return time.monotonic() - t0, search_time


def scale60m_phase(try_device: bool) -> dict:
    """North-star-scale record: device-led (when on a GPU), host path,
    and reference-design baseline at 60M bases / 10.2M nodes.
    Returns scale60m_* keys for the JSON line ({} when skipped)."""
    if os.environ.get("MATCHTIGS_BENCH_60M", "1") == "0":
        return {}
    if not Path(
        Path(DATA_CACHE) / f"pan_{SCALE60M_GENOME}_{K}_{N_STRAINS}_0.01_{SEED}_rep.npz"
    ).exists():
        # Never spend the ~50min generation inside the driver bench; the
        # dataset is built once by the development flow and cached.
        print("60M dataset not cached; skipping the scale phase",
              file=sys.stderr)
        return {}

    store, kmers, k, g = _load_dataset(SCALE60M_GENOME)
    n_unitigs = len(store)
    device_result = device_run(store, kmers, k, g) if try_device else {}
    from matchtigs_tpu.utils.malloc_tuning import prewarm_heap

    prewarm_heap(6 << 30)  # bulk-populate the arena the reps will reuse
    # Alternating order, min of 3: the 60M reps cost ~20-120s each (host
    # page faults inflate cold numbers; min is steady state).
    host_times, base_times = [], []
    for _ in range(3):
        base_times.append(
            host_greedytigs_time(store, k, g.copy(), reference_design=True)
        )
        host_times.append(host_greedytigs_time(store, k, g.copy()))
    host_time, host_search = min(host_times)
    baseline_time, baseline_search = min(base_times)
    matchtigs_keys = scale60m_matchtigs_phase(store, k, g)
    out = {
        **matchtigs_keys,
        "scale60m_unitigs": n_unitigs,
        "scale60m_kmers": len(kmers),
        "scale60m_host_s": round(host_time, 2),
        "scale60m_host_search_s": round(host_search, 2),
        "scale60m_baseline_s": round(baseline_time, 2),
        "scale60m_baseline_search_s": round(baseline_search, 2),
    }
    device_elapsed = device_result.get("elapsed")
    best = host_time
    if device_elapsed is not None:
        best = min(best, device_elapsed)
        out["scale60m_device_s"] = round(device_elapsed, 2)
        out["scale60m_device_stage_s"] = round(
            device_result["device_stage_s"], 2
        )
        stage_s = device_result["device_stage_s"]
        out["scale60m_device_stage_sources_per_s"] = (
            round(device_result["device_stage_sources"] / stage_s, 1)
            if stage_s
            else None
        )
        out["scale60m_tigs"] = device_result["tigs"]
    out["scale60m_unitigs_per_s"] = round(n_unitigs / best, 1)
    out["scale60m_vs_baseline"] = round(baseline_time / best, 3)
    # The baseline SHARES the framework's downstream passes (by design:
    # the ratio isolates the search engine), so framework downstream
    # optimizations speed the baseline up too and compress vs_baseline
    # toward 1; the search-only ratio carries the engine comparison.
    out["scale60m_search_vs_baseline"] = (
        round(baseline_search / host_search, 3) if host_search > 0 else None
    )
    for line in (
        f"60M host: {host_time:.2f}s (search {host_search:.2f}s); baseline "
        f"{baseline_time:.2f}s (search {baseline_search:.2f}s); device "
        f"{device_elapsed if device_elapsed else 'n/a'}; vs_baseline "
        f"{out['scale60m_vs_baseline']}",
    ):
        print(line, file=sys.stderr)
    return out


def scale60m_matchtigs_phase(store, k, g) -> dict:
    """Driver-certified 60M OPTIMAL matchtigs: the framework's flagship
    differentiator (exact min-cumulative-length tigs at a scale where the
    reference's blossom5 path is O(|V|^2) memory and 'often not feasible',
    /root/reference/src/implementation/matchtigs/mod.rs:131-940 +
    README.md:53).  Min of two from-scratch end-to-end runs (no solver
    caches persist between them; the second is page-warm only — the
    storm-robustness tradeoff is documented at the loop) plus one
    greedytigs run
    for the cumulative-length comparison; exactness is certified in-run
    by the sparse blossom's dual-feasibility audit (with cold-solve
    fallback), so a returned solution is exact by construction.
    Returns scale60m_matchtigs_* keys ({} when skipped)."""
    if os.environ.get("MATCHTIGS_BENCH_MATCHTIGS", "1") == "0":
        return {}
    from matchtigs_tpu.algos.greedytigs import GreedytigConfig, compute_greedytigs
    from matchtigs_tpu.algos.matchtigs import MatchtigConfig, compute_matchtigs

    def cumulative_len(g, tigs) -> int:
        # (k-1) per tig + the traversed edge weights (original + cheap
        # dummies), the walk-spelling char count without spelling.
        return int((k - 1) * len(tigs) + g.weights()[tigs.flat].sum())

    # engine="host": this phase records the host engine (the device path
    # of optimal matchtigs is not benchmarked yet).  Min of two
    # from-scratch runs (the second is page-warm only): host noise can
    # inflate a single run, and the greedy phases already report min-of-3
    # for the same reason.
    best = None
    for _ in range(2):
        g_i = g.copy()
        t0 = time.monotonic()
        tigs_i = compute_matchtigs(g_i, MatchtigConfig(k=k, engine="host"))
        el = time.monotonic() - t0
        if best is None or el < best[0]:
            best = (el, g_i, tigs_i)
    opt_s, g_opt, tigs_opt = best
    g_greedy = g.copy()
    tigs_greedy = compute_greedytigs(
        g_greedy, GreedytigConfig(k=k, engine="host")
    )
    cum_opt = cumulative_len(g_opt, tigs_opt)
    cum_greedy = cumulative_len(g_greedy, tigs_greedy)
    out = {
        "scale60m_matchtigs_s": round(opt_s, 2),
        "scale60m_matchtigs_tigs": len(tigs_opt),
        "scale60m_matchtigs_cumlen": cum_opt,
        "scale60m_greedytigs_tigs": len(tigs_greedy),
        "scale60m_greedytigs_cumlen": cum_greedy,
        # exact <= greedy always; the saving is the optimality dividend
        "scale60m_matchtigs_cumlen_saving": cum_greedy - cum_opt,
    }
    print(
        f"60M optimal matchtigs: {opt_s:.1f}s, {len(tigs_opt)} tigs, "
        f"cumlen {cum_opt} (greedy {len(tigs_greedy)} tigs, {cum_greedy}; "
        f"saving {cum_greedy - cum_opt})",
        file=sys.stderr,
    )
    return out


def main() -> None:
    import jax

    from matchtigs_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    store, kmers, k, g = _load_dataset()
    n_unitigs = len(store)

    device_elapsed = None
    device_result = {}
    if on_gpu():
        device_result = device_run(store, kmers, k, g)
        device_elapsed = device_result["elapsed"]
    else:
        print(
            f"no GPU (JAX platform {jax.devices()[0].platform!r}): device "
            "phase skipped, device keys are null",
            file=sys.stderr,
        )

    # Two repetitions each, alternating order (first-run page-cache and
    # allocator warmup would otherwise bias whichever pipeline runs first);
    # report the min.
    host_times, base_times = [], []
    for _ in range(3):
        base_times.append(
            host_greedytigs_time(store, k, g.copy(), reference_design=True)
        )
        host_times.append(host_greedytigs_time(store, k, g.copy()))
    host_time, host_search = min(host_times)
    baseline_time, baseline_search = min(base_times)
    host_ups = n_unitigs / host_time
    baseline_ups = n_unitigs / baseline_time
    ncpu = os.cpu_count() or 1
    print(
        f"framework host path (Dial-bucket MT dijkstra + matching + euler): "
        f"{host_time:.2f}s (search {host_search:.2f}s) "
        f"-> {host_ups:.0f} unitigs/s",
        file=sys.stderr,
    )
    print(
        f"reference-design baseline (binary heap + hashmap dijkstra, "
        f"{ncpu} threads; the reference's north-star config runs 16): "
        f"{baseline_time:.2f}s (search {baseline_search:.2f}s) "
        f"-> {baseline_ups:.0f} unitigs/s",
        file=sys.stderr,
    )

    # Report the framework's best configuration: the hybrid device path
    # when it completed and beat the host-only path, else the host path.
    value = host_ups
    best_time = host_time
    if device_elapsed is not None:
        device_ups = n_unitigs / device_elapsed
        print(
            f"device hybrid path: {device_ups:.0f} unitigs/s", file=sys.stderr
        )
        if device_ups > value:
            value, best_time = device_ups, device_elapsed
    vs = value / baseline_ups

    # Per-chip scaling unit from the device phase (sources/s of the
    # device stage alone; BASELINE.json names k-mers/s per chip as the
    # north-star metric — this bench runs on exactly one chip).
    n_kmers = len(kmers)
    dev_stage_s = device_result.get("device_stage_s")
    dev_sources_per_s = (
        round(device_result["device_stage_sources"] / dev_stage_s, 1)
        if dev_stage_s
        else None
    )

    # North-star scale phase (keys merged into the single JSON line).
    # The 10M arrays are dropped first — the 60M pipeline peaks at
    # several GB of its own.
    del store, g
    import gc

    gc.collect()
    scale60m = scale60m_phase(try_device=device_elapsed is not None)

    # Extra keys beyond the required four: the downstream passes are
    # shared between the framework and the baseline, so the overall ratio
    # compresses toward 1 at small scale — search_vs_baseline isolates
    # the search-engine design difference; the raw
    # seconds make the ratio auditable.
    print(
        json.dumps(
            {
                "metric": "greedy_matchtigs_unitigs_per_s",
                "value": round(value, 1),
                "unit": "unitigs/s",
                "vs_baseline": round(vs, 3),
                "search_vs_baseline": round(baseline_search / host_search, 3)
                if host_search > 0
                else None,
                "host_s": round(host_time, 2),
                "host_search_s": round(host_search, 2),
                "baseline_s": round(baseline_time, 2),
                "baseline_search_s": round(baseline_search, 2),
                "device_s": round(device_elapsed, 2)
                if device_elapsed is not None
                else None,
                # Per-chip number ONLY from the device-led path (no chip
                # produced the host path's time); the best-path throughput
                # is reported separately under an honest name.
                "kmers_per_s_per_chip": round(n_kmers / device_elapsed, 1)
                if device_elapsed is not None
                else None,
                "kmers_per_s_best_path": round(n_kmers / best_time, 1),
                "device_stage_sources_per_s": dev_sources_per_s,
                "n_chips": 1,
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
                **scale60m,
            }
        )
    )


if __name__ == "__main__":
    main()
