import numpy as np
import pytest

from matchtigs_tpu import testing
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu.ops.device_graph import build_device_graph
from matchtigs_tpu.ops.sssp import batched_bounded_sssp, sssp_reference_host


@pytest.mark.parametrize(
    "case",
    [
        dict(genome_length=3000, k=9, seed=0),
        dict(genome_length=6000, k=11, seed=1),
        dict(genome_length=2000, k=7, seed=2),
    ],
)
def test_device_sssp_matches_host_dijkstra(case):
    store, _, k = testing.make_unitig_store(**case)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    rng = np.random.default_rng(0)
    sources = rng.choice(g.n_nodes, size=min(32, g.n_nodes), replace=False)

    nodes, dist, overflow = batched_bounded_sssp(
        dg, sources, max_weight=k - 1, capacity=256, batch_size=16
    )
    assert not overflow.any(), "searches should be complete at capacity 256"

    for i, s in enumerate(sources):
        expected = sssp_reference_host(dg, int(s), k - 1)
        got = {
            int(n): int(d)
            for n, d in zip(nodes[i], dist[i])
            if n != dg.sentinel
        }
        assert got == expected, f"source {s}: {got} != {expected}"


def test_overflow_flag_and_retry():
    store, _, k = testing.make_unitig_store(genome_length=6000, k=9, seed=3)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    sources = np.arange(min(16, g.n_nodes), dtype=np.int32)
    # Tiny capacity: most searches must overflow and be flagged.
    nodes_s, dist_s, over_s = batched_bounded_sssp(
        dg, sources, max_weight=k - 1, capacity=4, batch_size=16
    )
    nodes_l, dist_l, over_l = batched_bounded_sssp(
        dg, sources, max_weight=k - 1, capacity=512, batch_size=16
    )
    assert not over_l.any()
    # Complete (non-overflowed) small-capacity searches must agree with the
    # large-capacity truth.
    for i in range(len(sources)):
        if not over_s[i]:
            got = {
                (int(n), int(d))
                for n, d in zip(nodes_s[i], dist_s[i])
                if n != dg.sentinel
            }
            want = {
                (int(n), int(d))
                for n, d in zip(nodes_l[i], dist_l[i])
                if n != dg.sentinel
            }
            assert got == want


def test_empty_sources():
    store, _, k = testing.make_unitig_store(genome_length=2000, k=9, seed=4)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    nodes, dist, over = batched_bounded_sssp(dg, np.empty(0, np.int32), 8)
    assert nodes.shape[0] == 0 and over.shape[0] == 0


def test_unpacked_mode_large_max_weight():
    """k >= 128 uses the two-key sort fallback; results must still match
    the host oracle (regression: dist_cap used to clamp at 127)."""
    store, _, k = testing.make_unitig_store(genome_length=3000, k=9, seed=6)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    max_w = 200  # > 127: forces packed=False
    sources = np.arange(min(8, g.n_nodes), dtype=np.int32)
    nodes, dist, over = batched_bounded_sssp(
        dg, sources, max_weight=max_w, capacity=512, batch_size=8
    )
    assert not over.any()
    for i, s in enumerate(sources):
        expected = sssp_reference_host(dg, int(s), max_w)
        got = {
            int(n): int(d)
            for n, d in zip(nodes[i], dist[i])
            if n != dg.sentinel
        }
        assert got == expected


def test_reference_design_baseline_matches_production_dijkstra():
    """The bench baseline (binary heap + hashmap, reference default
    semantics) must produce the same candidate set as the framework's
    Dial-bucket production Dijkstra — independent code, same answers."""
    from matchtigs_tpu import testing
    from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
    from matchtigs_tpu.ops.device_graph import build_device_graph
    from matchtigs_tpu.ops.matching import unbalanced_nodes
    from matchtigs_tpu.ops.sssp import (
        host_dijkstra_candidates,
        reference_dijkstra_candidates,
    )

    store, _, k = testing.make_unitig_store(genome_length=6000, k=11, seed=3)
    g = build_bigraph_from_unitigs(store, k)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    dg = build_device_graph(g)
    a = host_dijkstra_candidates(dg, out_nodes, k - 1, in_mask, n_threads=3)
    b = reference_dijkstra_candidates(dg, out_nodes, k - 1, in_mask, n_threads=2)
    sa = {tuple(r) for r in a.to_triples().tolist()}
    sb = {tuple(r) for r in b.to_triples().tolist()}
    assert sa == sb and len(sa) > 0


def test_two_key_sort_with_packed_output(monkeypatch):
    """Graphs between 2^23 and 2^24 nodes use two-key sorts but still
    pack results one-int32-per-slot; both paths must agree (the sort
    packing is forced off here via _can_pack)."""
    from matchtigs_tpu import testing
    from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
    from matchtigs_tpu.ops import sssp as sssp_mod
    from matchtigs_tpu.ops.device_graph import build_device_graph
    from matchtigs_tpu.ops.matching import unbalanced_nodes

    store, _, k = testing.make_unitig_store(
        genome_length=6000, k=11, seed=3
    )
    g = build_bigraph_from_unitigs(store, k)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    dg = build_device_graph(g, renumber=True)
    src = dg.map_sources(out_nodes.astype(np.int32))
    ref = sssp_mod.batched_bounded_sssp(dg, src, max_weight=k - 1, capacity=32)
    monkeypatch.setattr(sssp_mod, "_can_pack", lambda *a: False)
    got = sssp_mod.batched_bounded_sssp(dg, src, max_weight=k - 1, capacity=32)
    # per-source (node, dist) sets must match (slot order may differ)
    for i in range(len(src)):
        a = {(int(n), int(d)) for n, d in zip(ref[0][i], ref[1][i]) if d < sssp_mod.INF}
        b = {(int(n), int(d)) for n, d in zip(got[0][i], got[1][i]) if d < sssp_mod.INF}
        assert a == b, i
    assert np.array_equal(ref[2], got[2])


@pytest.mark.parametrize("pack", [True, False])
def test_pool_schedule_matches_batch_schedule(monkeypatch, pack):
    """The persistent-pool scheduler must agree with the batch scheduler
    per source: identical (node, dist) sets for non-overflowed sources
    and identical overflow flags (retirement-on-overflow may stop a
    pool lane earlier, but the overflow *decision* is the same witness:
    a valid entry beyond slot C)."""
    from matchtigs_tpu.ops import sssp as sssp_mod

    store, _, k = testing.make_unitig_store(genome_length=6000, k=11, seed=5)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    rng = np.random.default_rng(1)
    sources = rng.choice(
        g.n_nodes, size=min(100, g.n_nodes), replace=False
    ).astype(np.int32)
    if not pack:
        monkeypatch.setattr(sssp_mod, "_can_pack", lambda *a: False)

    for cap in (4, 64):  # overflowing and complete regimes
        bn, bd, bo = sssp_mod.batched_bounded_sssp(
            dg, sources, max_weight=k - 1, capacity=cap, batch_size=16
        )
        # pool smaller than S: exercises refill; also ragged (29) vs S
        pn, pd, po = sssp_mod.batched_bounded_sssp(
            dg, sources, max_weight=k - 1, capacity=cap, batch_size=29,
            schedule="pool",
        )
        assert np.array_equal(bo, po), cap
        for i in range(len(sources)):
            if bo[i]:
                continue
            a = {(int(n), int(d)) for n, d in zip(bn[i], bd[i]) if d < sssp_mod.INF}
            b = {(int(n), int(d)) for n, d in zip(pn[i], pd[i]) if d < sssp_mod.INF}
            assert a == b, (cap, i)


def test_pool_schedule_packed_output_path():
    """Pool scheduler with return_packed (the production extraction
    contract): packed rows must decode to the batch scheduler's sets."""
    from matchtigs_tpu.ops import sssp as sssp_mod

    store, _, k = testing.make_unitig_store(genome_length=4000, k=9, seed=7)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    sources = np.arange(min(50, g.n_nodes), dtype=np.int32)
    key, none, over = sssp_mod.batched_bounded_sssp(
        dg, sources, max_weight=k - 1, capacity=64, batch_size=16,
        schedule="pool", return_packed=True,
    )
    assert none is None
    bn, bd, bo = sssp_mod.batched_bounded_sssp(
        dg, sources, max_weight=k - 1, capacity=64, batch_size=16
    )
    assert np.array_equal(over, bo)
    cap = np.int32((1 << sssp_mod.DIST_BITS) - 1)
    for i in range(len(sources)):
        if over[i]:
            continue
        d = key[i] & cap
        n = key[i] >> sssp_mod.DIST_BITS
        a = {(int(nn), int(dd)) for nn, dd in zip(n, d) if dd < cap}
        b = {(int(nn), int(dd)) for nn, dd in zip(bn[i], bd[i]) if dd < sssp_mod.INF}
        assert a == b, i


def test_packed_adjacency_matches_unpacked():
    """adj_packed=True (one int32 per adjacency slot) must reproduce the
    two-buffer kernel bit for bit, including overflow flags and clamped
    out-of-bound weights."""
    from matchtigs_tpu.ops import sssp as sssp_mod

    store, _, k = testing.make_unitig_store(genome_length=6000, k=11, seed=4)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    assert sssp_mod._can_pack_adj(dg, k - 1)
    sources = np.arange(min(64, g.n_nodes), dtype=np.int32)

    res = {}
    for adj_packed in (False, True):
        nbr, nw = dg.device_buffers(adj_packed=adj_packed)
        if nw is None:
            nw = sssp_mod._dummy_nw()
        for schedule, extra in (
            ("pool", dict(pool=16)),
            ("batch", dict(batch=16, n_batches=len(sources) // 16)),
        ):
            fn = (
                sssp_mod._sssp_run_pool
                if schedule == "pool"
                else sssp_mod._sssp_run_batches
            )
            nodes_buf, dist_buf, over_buf = fn(
                nbr,
                nw,
                np.asarray(sources),
                np.int32(k - 1),
                capacity=32,
                max_rounds=k - 1,
                deg_pad=dg.deg_pad,
                packed=True,
                pack_out=True,
                adj_packed=adj_packed,
                **extra,
            )
            res[(adj_packed, schedule)] = (
                np.asarray(nodes_buf),
                np.asarray(over_buf),
            )
    for schedule in ("pool", "batch"):
        a, b = res[(False, schedule)], res[(True, schedule)]
        assert np.array_equal(a[0], b[0]), schedule
        assert np.array_equal(a[1], b[1]), schedule


@pytest.mark.parametrize("budget", [None, 7])
def test_compact_dispatch_matches_full_extraction(budget):
    """fetch_candidates on a compact-dispatched stage == the full-buffer
    native extraction, as (u, v, dist) multisets and overflow flags,
    both when the valid count fits the budget (compact download) and
    when a tiny forced budget trips the full-download fallback."""
    from matchtigs_tpu.ops import sssp as sssp_mod

    store, _, k = testing.make_unitig_store(genome_length=6000, k=11, seed=3)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    sources = np.arange(min(96, g.n_nodes), dtype=np.int32)
    in_mask = np.ones(dg.n_nodes + 1, dtype=np.int8)
    in_mask[:: 3] = 0  # nontrivial mask

    h_full = sssp_mod.batched_bounded_sssp_dispatch(
        dg, sources, k - 1, capacity=4, batch_size=16, compact=False
    )
    key, over_full = h_full.fetch()
    tri_full = sssp_mod.extract_packed_candidates(
        dg, key, sources, ~over_full, in_mask
    )

    h = sssp_mod.batched_bounded_sssp_dispatch(
        dg, sources, k - 1, capacity=4, batch_size=16, compact=True,
        budget=budget,
    )
    if budget is not None:
        assert int(h._total) > budget  # must exercise the fallback
    tri, over = h.fetch_candidates(dg, sources, in_mask)
    assert np.array_equal(over, over_full)
    assert len(tri) == len(tri_full)

    def triples(t):
        return sorted(zip(t.u.tolist(), t.v.tolist(), t.d.tolist()))

    assert triples(tri) == triples(tri_full)


def test_compact_dispatch_rejects_keys_past_2_30():
    """The compaction key marks invalid slots at 2^30, so a stage with
    (S_pad + 1) * capacity >= 2^30 slots must be refused, not corrupted."""
    from matchtigs_tpu.ops import sssp as sssp_mod

    store, _, k = testing.make_unitig_store(genome_length=3000, k=9, seed=0)
    dg = build_device_graph(build_bigraph_from_unitigs(store, k))
    sources = np.arange(4, dtype=np.int32)
    with pytest.raises(ValueError, match="2\\^30"):
        sssp_mod.batched_bounded_sssp_dispatch(
            dg, sources, k - 1, capacity=1 << 28, batch_size=4, compact=True
        )
