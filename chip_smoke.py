"""Drive greedy and optimal matchtigs once on an NVIDIA GPU and check them.

Usage (from the root of a checkout; one process drives the card(s)):

    python chip_smoke.py              # one GPU
    python chip_smoke.py --multi      # four GPUs: the mesh path only

One GPU, in order:

1. Device report: ``jax.devices()`` and the card's name and power limit
   (read by an ``nvidia-smi`` child that does not import JAX).  Any
   platform other than ``gpu`` exits non-zero; there is no CPU fallback.
2. Kernel parity at real width: the flagship graph (seeded synthetic
   pangenome: 10M-base genome, 7 strains, 1% mutations, repeat families,
   k=31), its first 64k difficulty-ordered sources, bound k-1=30.  Every
   static branch of the device SSSP (pool/batch schedule x packed/two-key
   sort x packed/two-buffer adjacency, the unpacked-output path of graphs
   past 2^24 nodes, and the on-device compacted stage) must give exactly
   the (u, v, d) triples of the native host Dijkstra on every source that
   did not overflow, and the same overflow flags as each other.
3. Library path: ``compute_greedytigs`` and ``compute_matchtigs`` with
   ``engine="device"`` (the device stage must have run) produce tigs
   byte-identical to ``engine="host"``; optimal <= greedy in cumulative
   length.
4. CLI path: ``matchtigs_tpu.cli.main`` on a gz fasta of the flagship with
   the default ``engine="auto"`` (which must pick the device kernel),
   writing greedytigs and matchtigs fasta and duplication bitvectors; the
   written files must spell exactly the input k-mer set.
5. Last line: ``{"ok": true, "device": {...}}``.

``--multi`` needs four GPUs and runs only the mesh greedytigs (compared
byte for byte with the single-device tigs; every card must get a slice
of the SSSP sources) and the mesh-sharded acceptance-key sort (compared
with ``np.sort``).

Times printed here are for information, each beside the card's name and
power limit; they are not a benchmark.  Any failed check raises, and the
script then exits non-zero without printing the last line.
"""

from __future__ import annotations

import argparse
import gzip
import json
import logging
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

GENOME_LENGTH = 10_000_000
K = 31
N_STRAINS = 7
MUTATION_RATE = 0.01
SEED = 0
DATA_CACHE = Path(__file__).resolve().parent / ".bench_data"
PARITY_SOURCES = 1 << 16
CAPACITY = 4
BATCH_SIZE = 4096
N_MULTI = 4

# Static branches of the device SSSP.  ``packed``: single-key sorts (node
# ids < 2^23); ``adj_packed``: one int32 per adjacency slot (ids < 2^24);
# ``pack_out=False``: separate node/dist result buffers (ids >= 2^24);
# ``compact``: the pool stage plus on-device valid-slot compaction.
BRANCHES = [
    dict(schedule=s, packed=p, adj_packed=a)
    for s in ("pool", "batch")
    for p in (True, False)
    for a in (True, False)
] + [
    dict(schedule=s, packed=False, adj_packed=False, pack_out=False)
    for s in ("pool", "batch")
] + [dict(schedule="pool", packed=True, adj_packed=True, compact=True)]


def branch_name(branch: dict) -> str:
    parts = [
        branch["schedule"],
        "packed-sort" if branch["packed"] else "two-key-sort",
        "packed-adj" if branch["adj_packed"] else "two-buffer-adj",
    ]
    if not branch.get("pack_out", True):
        parts.append("unpacked-out")
    if branch.get("compact"):
        parts.append("compact")
    return "/".join(parts)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_report() -> str:
    """``name, power.limit`` of every visible card, from nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def triple_keys(tri) -> np.ndarray:
    """Sorted int64 keys of (u, v, d) triples (ids < 2^24, d < 2^7)."""
    u = np.asarray(tri.u, dtype=np.int64)
    v = np.asarray(tri.v, dtype=np.int64)
    d = np.asarray(tri.d, dtype=np.int64)
    return np.sort((u << 31) | (v << 7) | d)


def parity_sources(dg, out_nodes: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` sources in the device stage's difficulty order
    (minimum incident edge weight descending, node id ascending)."""
    out_nodes = np.asarray(out_nodes, dtype=np.int64)
    difficulty = dg.nw.min(axis=1)[out_nodes]
    order = np.lexsort((out_nodes, -difficulty))
    return out_nodes[order][:n].astype(np.int32)


def host_reference(dg, sources, max_weight: int, in_mask) -> np.ndarray:
    from matchtigs_tpu.ops.sssp import host_dijkstra_candidates

    return triple_keys(host_dijkstra_candidates(
        dg, np.asarray(sources, dtype=np.int64), max_weight, in_mask
    ))


def run_branch(dg, sources, in_mask, max_weight: int, branch: dict,
               capacity: int, batch_size: int):
    """Run one static branch of the device SSSP on ``sources``.

    Returns (triples of the non-overflowed sources, overflow [S], info);
    ``info`` holds compile and run seconds and, for the explicitly
    compiled programs, the ``Compiled`` object."""
    import jax
    import jax.numpy as jnp

    from matchtigs_tpu.ops import sssp
    from matchtigs_tpu.ops.candidates import Candidates

    sources = np.asarray(sources, dtype=np.int32)
    S = len(sources)
    if branch.get("compact"):
        t0 = time.monotonic()
        stage = sssp.batched_bounded_sssp_dispatch(
            dg, sources, max_weight, capacity, batch_size, compact=True
        )
        tri, over = stage.fetch_candidates(dg, sources, in_mask)
        return tri, over, {"compile_s": None,
                           "run_s": time.monotonic() - t0}

    pack_out = branch.get("pack_out", True)
    nbr, nw = dg.device_buffers(adj_packed=branch["adj_packed"])
    if nw is None:
        nw = sssp._dummy_nw()
    batch = max(1, min(batch_size, S))
    S_pad = -(-S // batch) * batch
    padded = np.full(S_pad, dg.n_nodes, dtype=np.int32)
    padded[:S] = sources
    static = dict(
        capacity=capacity, max_rounds=int(max_weight), deg_pad=dg.deg_pad,
        packed=branch["packed"], pack_out=pack_out,
        adj_packed=branch["adj_packed"],
    )
    if branch["schedule"] == "pool":
        fn = sssp._sssp_run_pool
        static["pool"] = batch
    else:
        fn = sssp._sssp_run_batches
        static.update(batch=batch, n_batches=S_pad // batch)
    args = (nbr, nw, jnp.asarray(padded), jnp.int32(max_weight))
    t0 = time.monotonic()
    compiled = fn.lower(*args, **static).compile()
    compile_s = time.monotonic() - t0
    t0 = time.monotonic()
    nodes_buf, dist_buf, over_buf = jax.block_until_ready(compiled(*args))
    run_s = time.monotonic() - t0
    over = np.asarray(over_buf)[:S]
    if pack_out:
        key = np.asarray(nodes_buf)[:S]
        tri = sssp.extract_packed_candidates(dg, key, sources, ~over, in_mask)
    else:
        nodes = np.asarray(nodes_buf)[:S]
        dist = np.asarray(dist_buf)[:S]
        valid = (nodes != dg.sentinel) & (dist >= 1) & (dist <= max_weight)
        valid &= (~over)[:, None]
        valid &= np.asarray(in_mask, dtype=bool)[
            np.minimum(nodes, len(in_mask) - 1)
        ]
        s_idx, c_idx = np.nonzero(valid)
        tri = Candidates(sources[s_idx], nodes[s_idx, c_idx],
                         dist[s_idx, c_idx])
    return tri, over, {"compile_s": compile_s, "run_s": run_s,
                       "compiled": compiled}


def check_branch(dg, sources, in_mask, max_weight: int, host_keys,
                 branch: dict, capacity: int = CAPACITY,
                 batch_size: int = BATCH_SIZE) -> dict:
    """Run one branch and assert exact parity with the host Dijkstra's
    sorted triple keys ``host_keys`` on the non-overflowed sources.
    Returns the branch's counts and times."""
    tri, over, info = run_branch(
        dg, sources, in_mask, max_weight, branch, capacity, batch_size
    )
    done = np.zeros(dg.n_nodes + 1, dtype=bool)
    done[np.asarray(sources)[~over]] = True
    want = host_keys[done[host_keys >> 31]]
    got = triple_keys(tri)
    name = branch_name(branch)
    if not np.array_equal(got, want):
        raise AssertionError(
            f"{name}: {len(got)} device triples != {len(want)} host triples "
            f"on {int((~over).sum())} complete sources"
        )
    return {"name": name, "overflow": over, "n_triples": len(got),
            "n_done": int((~over).sum()), **info}


def load_flagship():
    from matchtigs_tpu import testing
    from matchtigs_tpu.graph.build import build_bigraph_from_unitigs

    store, kmers, k = testing.make_pangenome_store(
        genome_length=GENOME_LENGTH, k=K, n_strains=N_STRAINS,
        mutation_rate=MUTATION_RATE, seed=SEED, cache_dir=str(DATA_CACHE),
        with_repeats=True,
    )
    return store, kmers, k, build_bigraph_from_unitigs(store, k)


def parity_phase(g, k: int, card: str) -> None:
    from matchtigs_tpu.ops.device_graph import build_device_graph
    from matchtigs_tpu.ops.matching import unbalanced_nodes

    dg = build_device_graph(g, renumber=False)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    sources = parity_sources(dg, out_nodes, PARITY_SOURCES)
    max_weight = k - 1
    t0 = time.monotonic()
    host_keys = host_reference(dg, sources, max_weight, in_mask)
    say(f"[parity] {len(sources)} sources, bound {max_weight}, C={CAPACITY}, "
        f"pool/batch {BATCH_SIZE}; host Dijkstra {len(host_keys)} triples "
        f"in {time.monotonic() - t0:.3f}s")
    ref_over = None
    for branch in BRANCHES:
        r = check_branch(dg, sources, in_mask, max_weight, host_keys, branch)
        if ref_over is None:
            ref_over = r["overflow"]
            compiled = r["compiled"]
            say(f"[parity] pool program memory_analysis: "
                f"{compiled.memory_analysis()}")
        elif not np.array_equal(r["overflow"], ref_over):
            raise AssertionError(f"{r['name']}: overflow flags differ")
        comp = ("n/a" if r["compile_s"] is None
                else f"{r['compile_s']:.3f}s")
        say(f"[parity] OK {r['name']}: {r['n_triples']} triples equal on "
            f"{r['n_done']}/{len(sources)} complete sources "
            f"(overflow {1 - r['n_done'] / len(sources):.4f}); compile "
            f"{comp}, run {r['run_s']:.3f}s [{card}]")


def cumulative_len(g, tigs, k: int) -> int:
    """(k-1) per tig + the traversed edge weights: the spelled length."""
    return int((k - 1) * len(tigs) + g.weights()[tigs.flat].sum())


def stage_summary(stats) -> str:
    srcs = sum(s for s, _ in zip(stats.stage_sources, stats.stage_times))
    secs = sum(stats.stage_times)
    rate = srcs / secs if secs else float("nan")
    return (f"device stage {secs:.3f}s for {srcs} sources ({rate:.0f} "
            f"sources/s), overflow share "
            f"{[round(x, 4) for x in stats.stage_overflow_frac]}, "
            f"{stats.host_routed} host-routed")


def library_phase(g, k: int, card: str) -> None:
    from matchtigs_tpu.algos.greedytigs import (
        GreedytigConfig,
        SearchStats,
        compute_greedytigs,
    )
    from matchtigs_tpu.algos.matchtigs import MatchtigConfig, compute_matchtigs

    cum = {}
    for name, compute, config, runs in (
        ("greedytigs", compute_greedytigs, GreedytigConfig, ("cold", "warm")),
        ("matchtigs", compute_matchtigs, MatchtigConfig, ("warm",)),
    ):
        for run in runs:
            stats = SearchStats()
            g_dev = g.copy()
            t0 = time.monotonic()
            tigs = compute(g_dev, config(k=k, engine="device"), stats=stats)
            el = time.monotonic() - t0
            if not stats.stage_times:
                raise AssertionError(f"{name}: the device stage did not run")
            say(f"[library] {name} engine=device ({run}): {el:.3f}s, "
                f"{len(tigs)} tigs; {stage_summary(stats)} [{card}]")
        g_host = g.copy()
        t0 = time.monotonic()
        tigs_host = compute(g_host, config(k=k, engine="host"))
        say(f"[library] {name} engine=host: {time.monotonic() - t0:.3f}s")
        if not (np.array_equal(tigs.offsets, tigs_host.offsets)
                and np.array_equal(tigs.flat, tigs_host.flat)):
            raise AssertionError(f"{name}: device tigs != host tigs")
        cum[name] = cumulative_len(g_dev, tigs, k)
        say(f"[library] OK {name}: device tigs byte-identical to host; "
            f"cumulative length {cum[name]}")
    if cum["matchtigs"] > cum["greedytigs"]:
        raise AssertionError(f"optimal {cum['matchtigs']} > greedy "
                             f"{cum['greedytigs']}")
    say(f"[library] OK optimal <= greedy "
        f"({cum['matchtigs']} <= {cum['greedytigs']})")


def write_unitigs_fasta(store, path: Path) -> None:
    asc = np.frombuffer(b"ACGT", dtype=np.uint8)[store.codes].tobytes()
    off = store.offsets.tolist()
    parts = []
    for i in range(len(store)):
        parts += [b">%d\n" % i, asc[off[i]:off[i + 1]], b"\n"]
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(b"".join(parts))


def check_tig_file(fa: Path, bv: Path, kmers: np.ndarray, k: int) -> str:
    """The k-mer oracle: the tigs in ``fa`` spell exactly ``kmers`` and
    the duplication bitvector ``bv`` marks each repeated k-mer '0'."""
    from matchtigs_tpu import testing
    from matchtigs_tpu.io.readers import read_fasta

    store, _ = read_fasta(fa)
    seqs = np.split(store.codes, np.asarray(store.offsets)[1:-1])
    ms = testing.kmer_multiset_of_walk_seqs(seqs, k)
    if not np.array_equal(np.unique(ms), kmers):
        raise AssertionError(f"{fa.name}: k-mer set differs from the input")
    bits = gzip.decompress(bv.read_bytes()).replace(b"\n", b"")
    n_dup = len(ms) - len(np.unique(ms))
    if len(bits) != len(ms) or bits.count(b"0") != n_dup:
        raise AssertionError(f"{bv.name}: bitvector does not match the tigs")
    return f"{len(store)} tigs, {len(ms)} k-mers ({n_dup} duplicated)"


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def cli_phase(store, kmers, k: int, card: str) -> None:
    from matchtigs_tpu import cli

    engine_log = _Records()
    logging.getLogger("matchtigs_tpu.algos.greedytigs").addHandler(engine_log)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.monotonic()
        fa_in = tmp / "unitigs.fa.gz"
        write_unitigs_fasta(store, fa_in)
        say(f"[cli] wrote {len(store)} unitigs to gz fasta in "
            f"{time.monotonic() - t0:.3f}s")
        outs = {a: (tmp / f"{a}.fa.gz", tmp / f"{a}.bv.gz")
                for a in ("greedytigs", "matchtigs")}
        argv = ["--fa-in", str(fa_in), "-k", str(k), "--log-level", "Warning"]
        for a, (fa, bv) in outs.items():
            argv += [f"--{a}-fa-out", str(fa),
                     f"--{a}-duplication-bitvector-out", str(bv)]
        t0 = time.monotonic()
        rc = cli.main(argv)
        el = time.monotonic() - t0
        if rc != 0:
            raise AssertionError(f"cli.main returned {rc}")
        picked = [m for m in engine_log.messages
                  if m.startswith("engine=auto")]
        if not picked or not all("device kernel" in m for m in picked):
            raise AssertionError(f"engine=auto did not pick the device "
                                 f"kernel: {picked}")
        say(f"[cli] cli.main: {el:.3f}s; {picked[0]} [{card}]")
        for a, (fa, bv) in outs.items():
            say(f"[cli] OK {a}: k-mer oracle holds; "
                f"{check_tig_file(fa, bv, kmers, k)}")
    logging.getLogger("matchtigs_tpu.algos.greedytigs").removeHandler(
        engine_log)


class _SourceShards:
    """While active, count the real sources each device receives in the
    source array of every mesh SSSP stage, read from the array's
    addressable shards."""

    def __init__(self, devices):
        self.per_device = dict.fromkeys(devices, 0)

    def __enter__(self):
        from jax.sharding import PartitionSpec

        from matchtigs_tpu.parallel import mesh

        real_sssp, real_global = mesh.sharded_bounded_sssp, mesh._make_global
        source_spec = PartitionSpec(mesh.SOURCE_AXIS)

        def sssp(dg, *args, **kw):
            def make_global(m, spec, host_value):
                arr = real_global(m, spec, host_value)
                if spec == source_spec:
                    for shard in arr.addressable_shards:
                        self.per_device[shard.device] += int(
                            (np.asarray(shard.data) != dg.n_nodes).sum())
                return arr

            mesh._make_global = make_global
            try:
                return real_sssp(dg, *args, **kw)
            finally:
                mesh._make_global = real_global

        self._restore = lambda: setattr(mesh, "sharded_bounded_sssp",
                                        real_sssp)
        mesh.sharded_bounded_sssp = sssp
        return self

    def __exit__(self, *exc):
        self._restore()


def multi_phase(g, k: int, card: str, n_keys: int = 5_000_000) -> None:
    import contextlib

    import jax

    from matchtigs_tpu.algos.greedytigs import (
        GreedytigConfig,
        SearchStats,
        compute_greedytigs,
    )
    from matchtigs_tpu.parallel.mesh import make_mesh, sharded_accept_key_sort

    devices = jax.devices()
    tigs = {}
    shards = _SourceShards(devices)
    for name, use_mesh in (("single-device", False), ("mesh", True)):
        stats = SearchStats()
        t0 = time.monotonic()
        with shards if use_mesh else contextlib.nullcontext():
            tigs[name] = compute_greedytigs(
                g.copy(),
                GreedytigConfig(k=k, engine="device", use_mesh=use_mesh),
                stats=stats,
            )
        if not stats.stage_times:
            raise AssertionError(f"{name}: the device stage did not run")
        say(f"[multi] greedytigs {name}: {time.monotonic() - t0:.3f}s, "
            f"{len(tigs[name])} tigs; {stage_summary(stats)} [{card}]")
    a, b = tigs["single-device"], tigs["mesh"]
    if not (np.array_equal(a.offsets, b.offsets)
            and np.array_equal(a.flat, b.flat)):
        raise AssertionError("mesh tigs != single-device tigs")
    say(f"[multi] OK mesh greedytigs byte-identical to single-device "
        f"({len(devices)} devices)")
    counts = [shards.per_device[d] for d in devices]
    if not all(c > 0 for c in counts):
        raise AssertionError(f"a device got no SSSP sources: {counts}")
    say(f"[multi] OK every device got a slice of the SSSP sources: {counts}")

    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, 1 << 62, size=n_keys, dtype=np.int64)
    t0 = time.monotonic()
    got = sharded_accept_key_sort(keys, make_mesh(devices))
    el = time.monotonic() - t0
    if not np.array_equal(got, np.sort(keys)):
        raise AssertionError("sharded_accept_key_sort != np.sort")
    say(f"[multi] OK sharded_accept_key_sort of {len(keys)} keys equals "
        f"np.sort ({el:.3f}s) [{card}]")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four GPUs: mesh greedytigs and sharded sort only")
    ap.add_argument("--log-file",
                    help="also write the library's INFO log to this file")
    opts = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    say(f"[device] jax.devices(): {devices}")
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {platform!r}",
              file=sys.stderr)
        return 2
    if opts.multi and len(devices) < N_MULTI:
        print(f"chip_smoke --multi: needs {N_MULTI} GPUs, JAX found "
              f"{len(devices)}", file=sys.stderr)
        return 2
    card = card_report()
    say(card)
    card = card.splitlines()[0]

    from matchtigs_tpu.utils.compile_cache import enable_compile_cache

    say(f"[device] compile cache: {enable_compile_cache()}")
    logging.basicConfig(level=logging.WARNING)
    for h in logging.getLogger().handlers:
        h.setLevel(logging.WARNING)  # INFO goes to --log-file only
    if opts.log_file:
        Path(opts.log_file).parent.mkdir(parents=True, exist_ok=True)
        handler = logging.FileHandler(opts.log_file, mode="w")
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s [%(name)s] %(message)s"))
        pkg = logging.getLogger("matchtigs_tpu")
        pkg.setLevel(logging.INFO)
        pkg.addHandler(handler)

    t0 = time.monotonic()
    store, kmers, k, g = load_flagship()
    say(f"[data] pangenome {GENOME_LENGTH} bases, k={k}: {len(store)} "
        f"unitigs, {len(kmers)} k-mers, {g.n_nodes} nodes in "
        f"{time.monotonic() - t0:.3f}s")
    t_all = time.monotonic()
    if opts.multi:
        multi_phase(g, k, card)
    else:
        parity_phase(g, k, card)
        library_phase(g, k, card)
        cli_phase(store, kmers, k, card)
    say(f"[done] all phases passed in {time.monotonic() - t_all:.3f}s "
        f"[{card}]")
    print(json.dumps({"ok": True, "device": {
        "platform": platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
