"""Command line interface.

Mirrors the reference CLI's flag surface (/root/reference/src/bin.rs:56-218)
with the same orchestration: load -> per-algorithm compute (on a fresh
graph copy for graph-mutating algorithms) -> write, with timing and memory
logging (/root/reference/src/bin.rs:850-1218).

Run as ``python -m matchtigs_tpu.cli`` or the ``matchtigs-tpu`` entry point.
"""

from __future__ import annotations

import argparse
import logging
import resource
import sys
import time

from .algos.eulertigs import EulertigConfig, compute_eulertigs
from .algos.greedytigs import GreedytigConfig, compute_greedytigs
from .algos.matchtigs import MatchtigConfig, compute_matchtigs
from .algos.pathtigs import compute_pathtigs
from .graph.build import build_bigraph_from_links, build_bigraph_from_unitigs
from .io.readers import load_unitigs
from .io.writers import (
    write_duplication_bitvector,
    write_walks_fasta,
    write_walks_gfa,
)

logger = logging.getLogger("matchtigs_tpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="matchtigs-tpu",
        description="Matchtigs (accelerator engine): minimum plain text representation of kmer sets.",
    )
    p.add_argument("--gfa-in", help="GFA file containing the input unitigs (.gz ok)")
    p.add_argument("--fa-in", help="Fasta file containing the input unitigs (.gz ok)")
    p.add_argument(
        "--bcalm-in", help="BCALM2 fasta file containing the input unitigs (.gz ok)"
    )
    for algo in ("pathtigs", "eulertigs", "greedytigs", "matchtigs"):
        p.add_argument(f"--{algo}-gfa-out", help=f"Compute {algo}, write GFA (.gz ok)")
        p.add_argument(f"--{algo}-fa-out", help=f"Compute {algo}, write fasta (.gz ok)")
    p.add_argument(
        "--greedytigs-duplication-bitvector-out",
        help="ASCII bitvector: 0 per duplicated kmer in the greedytigs",
    )
    p.add_argument(
        "--matchtigs-duplication-bitvector-out",
        help="ASCII bitvector: 0 per duplicated kmer in the matchtigs",
    )
    p.add_argument("-k", type=int, help="kmer size (required for fasta/bcalm input)")
    p.add_argument(
        "-t",
        "--threads",
        type=int,
        default=None,
        help="host threads for the native Dijkstra (default: all cores); "
        "device parallelism is batch-based",
    )
    # The SSSP perf knobs default to None and are filled from the algorithm
    # dataclasses at dispatch time, so the CLI can never silently diverge
    # from the GreedytigConfig/MatchtigConfig defaults (C=4, batch 4096).
    # tests/test_cli.py asserts the defaults stay equal.
    p.add_argument(
        "--sssp-initial-capacity",
        type=int,
        default=None,
        help="initial per-source working-set capacity of the batched search "
        f"(default: {GreedytigConfig.initial_capacity})",
    )
    p.add_argument(
        "--sssp-batch-size",
        type=int,
        default=None,
        help="number of sources relaxed per device batch "
        f"(default: {GreedytigConfig.batch_size})",
    )
    p.add_argument(
        "--sssp-overflow-mode",
        choices=("host", "ladder"),
        default="host",
        help="finish capacity-overflow sources on the host (native Dijkstra) "
        "or retry on device with 4x capacity per stage",
    )
    p.add_argument(
        "--host-route-threshold",
        type=int,
        default=1,
        help="route sources whose min incident edge weight is <= this to the "
        "concurrent host Dijkstra (-1 disables the split); 1 matches the "
        "GreedytigConfig default",
    )
    p.add_argument(
        "--use-mesh",
        choices=("auto", "true", "false"),
        default="auto",
        help="shard source batches over the device mesh (auto: when >1 device)",
    )
    p.add_argument(
        "--matching-dense-limit",
        type=int,
        default=None,
        help="largest candidate component solved with the dense exact blossom "
        "(bigger ones use the sparse exact solver)",
    )
    p.add_argument(
        "--matching-file-prefix",
        help="write the matchtigs matching instance/solution to "
        "<prefix>.matching[.solution] (durable intermediate, analog of the "
        "reference's .minimalperfectmatching files)",
    )
    p.add_argument(
        "--debug-print-graph",
        action="store_true",
        help="print the de Bruijn graph constructed from the input unitigs",
    )
    p.add_argument("--debug-print-walks", action="store_true")
    p.add_argument(
        "--debug-spell-prefix",
        help="write per-edge spell annotations to <prefix>.<algo>.spell "
        "alongside each fasta/GFA output (the reference writers' debug "
        "channel, src/bin.rs:608-818)",
    )
    p.add_argument("--log-level", default="Info")
    # Reference-CLI compatibility: accepted, mapped or ignored with a note.
    p.add_argument("--blossom5-command", help=argparse.SUPPRESS)
    p.add_argument(
        "--dijkstra-node-weight-array-type",
        choices=("EpochNodeWeightArray", "HashbrownHashMap"),
        help="host Dijkstra distance-structure strategy "
        "(reference flag, src/implementation/mod.rs:62-83): "
        "EpochNodeWeightArray selects the dense epoch-array Dial engine "
        "(framework default), HashbrownHashMap the binary-heap + hashmap "
        "engine (the reference's default semantics)",
    )
    p.add_argument(
        "--dijkstra-heap-type",
        choices=("StdBinaryHeap",),
        help="heap strategy (reference flag; StdBinaryHeap is the only "
        "value the reference defines, src/implementation/mod.rs:86-103)",
    )
    p.add_argument("--dijkstra-performance-data-type", help=argparse.SUPPRESS)
    p.add_argument(
        "--dijkstra-staged-parallelism-divisor", type=float, help=argparse.SUPPRESS
    )
    p.add_argument(
        "--dijkstra-resource-limit-factor", type=int, help=argparse.SUPPRESS
    )
    p.add_argument(
        "--compression-level",
        type=int,
        default=6,
        choices=range(10),
        help="gzip level for .gz outputs",
    )
    return p


def _sssp_overrides(opts) -> dict:
    """SSSP perf knobs the user set explicitly; unset flags fall through to
    the dataclass defaults instead of shadowing them."""
    out = {}
    if opts.sssp_initial_capacity is not None:
        out["initial_capacity"] = opts.sssp_initial_capacity
    if opts.sssp_batch_size is not None:
        out["batch_size"] = opts.sssp_batch_size
    return out


def _want_counters(opts) -> bool:
    """--dijkstra-performance-data-type <anything but none> enables the
    per-source search counters (the reference's opt-in performance data,
    /root/reference/src/bin.rs:160-165, greedytigs/mod.rs:646-673)."""
    v = opts.dijkstra_performance_data_type
    return bool(v) and v.lower() not in ("none", "off")


def _host_strategy(opts) -> str:
    """Map the reference's Dijkstra strategy flags to a host engine
    (reference dispatch: /root/reference/src/implementation/mod.rs:62-126,
    greedytigs/mod.rs:92-198).  Unset -> the framework's own default."""
    v = opts.dijkstra_node_weight_array_type
    if v is None:
        return "dial"
    strategy = "heap" if v == "HashbrownHashMap" else "dial"
    logger.info(
        "Dijkstra strategy: %s + %s -> host engine %r",
        opts.dijkstra_heap_type or "StdBinaryHeap",
        v,
        strategy,
    )
    return strategy


def _log_mem(label: str) -> None:
    """Per-phase memory snapshot at info level — the analog of the
    reference's log_memory_usage after every phase
    (/root/reference/src/bin.rs:842-848, called at 872, 921, 998)."""
    peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    current_kb = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    current_kb = int(line.split()[1])
                    break
    except OSError:
        pass
    if current_kb is not None:
        logger.info(
            "%s memory usage: %.1f MiB physical (peak %.1f MiB)",
            label,
            current_kb / 1024,
            peak_kb / 1024,
        )
    else:
        logger.info("%s peak memory usage: %.1f MiB", label, peak_kb / 1024)


def main(argv: list[str] | None = None) -> int:
    opts = build_parser().parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, opts.log_level.upper(), logging.INFO),
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
    )
    logger.info("matchtigs-tpu starting")
    from .utils.compile_cache import enable_compile_cache
    from .utils.malloc_tuning import tune_malloc

    enable_compile_cache()
    tune_malloc()

    load_start = time.monotonic()
    store, k, gfa_header, links = load_unitigs(
        gfa_in=opts.gfa_in, fa_in=opts.fa_in, bcalm_in=opts.bcalm_in, k=opts.k
    )
    if links:
        logger.info("Building graph from %d explicit topology links", len(links))
        graph = build_bigraph_from_links(store, links, k)
    else:
        graph = build_bigraph_from_unitigs(store, k)
    logger.info("Loading took %.1f seconds", time.monotonic() - load_start)
    logger.info("k = %d", k)
    logger.info(
        "Graph has %d nodes and %d edges", graph.n_nodes, graph.n_edges
    )
    _log_mem("After load")

    # Pre-fault the working-set arena in one bulk syscall: the candidate
    # columns / sort keys of the greedy/optimal matchtig search scale
    # with the candidate count (~3.3 per edge at k=31, 24B+8B key each,
    # x2 for scratch), and lazy first-touch faults can be slow on
    # oversubscribed virtualized hosts.
    # Only the candidate-building algorithms need it, and the target is
    # capped by available memory so the prewarm can never thrash a host
    # the real working set would have fit on.
    wants_search = any(
        getattr(opts, f"{algo}_{out}", None)
        for algo in ("greedytigs", "matchtigs")
        for out in ("fa_out", "gfa_out", "duplication_bitvector_out")
    )
    if wants_search:
        from .utils.malloc_tuning import available_memory_bytes, prewarm_heap

        prewarm = min(224 * graph.n_edges, 12 << 30)
        avail = available_memory_bytes()
        if avail is not None:
            prewarm = min(prewarm, avail // 2)
        if prewarm > (64 << 20) and prewarm_heap(prewarm):
            logger.info("Prewarmed %.1f GiB of heap arena", prewarm / 2**30)

    if opts.blossom5_command:
        logger.info(
            "--blossom5-command is accepted for compatibility; the matching "
            "runs with the built-in native blossom solver"
        )
    if opts.dijkstra_staged_parallelism_divisor or opts.dijkstra_resource_limit_factor:
        logger.info(
            "Staged-parallelism flags map to the built-in capacity ladder "
            "(--sssp-initial-capacity); searches that exceed the working-set "
            "capacity are retried automatically with more memory"
        )

    if opts.debug_print_graph:
        logger.info("Printing graph to stdout, because --debug-print-graph was set")
        for e in range(graph.n_edges):
            print(
                f"{e} ({int(graph.srcs()[e])} -> {int(graph.dsts()[e])}) "
                f"{store.get_ascii(int(graph.handles()[e]), bool(graph.forwards()[e])).decode()}"
            )

    requested = []
    if opts.pathtigs_fa_out or opts.pathtigs_gfa_out:
        requested.append("pathtigs")
    if opts.eulertigs_fa_out or opts.eulertigs_gfa_out:
        requested.append("eulertigs")
    if (
        opts.greedytigs_fa_out
        or opts.greedytigs_gfa_out
        or opts.greedytigs_duplication_bitvector_out
    ):
        requested.append("greedytigs")
    if (
        opts.matchtigs_fa_out
        or opts.matchtigs_gfa_out
        or opts.matchtigs_duplication_bitvector_out
    ):
        requested.append("matchtigs")
    if not requested:
        logger.warning("No outputs requested; nothing to do")
        return 0

    times: dict[str, tuple[float, float]] = {}
    for algo in requested:
        logger.info("Computing %s", algo)
        g = graph if algo == "pathtigs" else graph.copy()
        t0 = time.monotonic()
        if algo == "pathtigs":
            tigs = compute_pathtigs(g)
        elif algo == "eulertigs":
            tigs = compute_eulertigs(g, EulertigConfig(k=k))
        elif algo == "greedytigs":
            tigs = compute_greedytigs(
                g,
                GreedytigConfig(
                    k=k,
                    **_sssp_overrides(opts),
                    host_threads=opts.threads,
                    overflow_mode=opts.sssp_overflow_mode,
                    host_route_threshold=opts.host_route_threshold,
                    use_mesh={"auto": "auto", "true": True, "false": False}[
                        opts.use_mesh
                    ],
                    performance_counters=_want_counters(opts),
                    host_strategy=_host_strategy(opts),
                ),
            )
        else:
            tigs = compute_matchtigs(
                g,
                MatchtigConfig(
                    k=k,
                    **_sssp_overrides(opts),
                    host_threads=opts.threads,
                    dense_limit=opts.matching_dense_limit,
                    matching_file_prefix=opts.matching_file_prefix,
                    performance_counters=_want_counters(opts),
                    host_strategy=_host_strategy(opts),
                ),
            )
        compute_time = time.monotonic() - t0

        t0 = time.monotonic()
        fa_out = getattr(opts, f"{algo}_fa_out")
        gfa_out = getattr(opts, f"{algo}_gfa_out")
        debug_path = (
            f"{opts.debug_spell_prefix}.{algo}.spell"
            if opts.debug_spell_prefix
            else None
        )
        if fa_out:
            logger.info("Writing %s as fasta to %s", algo, fa_out)
            write_walks_fasta(
                g, tigs, store, k, fa_out, opts.compression_level,
                debug_path=debug_path,
            )
            debug_path = None  # one debug file per algorithm
        if gfa_out:
            logger.info("Writing %s as gfa to %s", algo, gfa_out)
            write_walks_gfa(
                g, tigs, store, k, gfa_header, gfa_out, opts.compression_level,
                debug_path=debug_path,
            )
        bv_out = getattr(opts, f"{algo}_duplication_bitvector_out", None)
        if bv_out:
            logger.info("Writing %s duplication bitvector to %s", algo, bv_out)
            write_duplication_bitvector(g, tigs, bv_out, opts.compression_level)
        if opts.debug_print_walks:
            for walk in tigs:
                print(", ".join(str(int(e)) for e in walk))
        write_time = time.monotonic() - t0
        times[algo] = (compute_time, write_time)
        _log_mem(f"After {algo}")

    for algo, (ct, wt) in times.items():
        logger.info("Computing %s took %.1fs and writing took %.1fs", algo, ct, wt)
    _log_mem("Final")
    logger.info("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
