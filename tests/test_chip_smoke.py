"""CPU tests of chip_smoke.py: its parity check of every static SSSP
branch (here on a small graph under XLA's CPU backend), its k-mer oracle,
and its refusal to run without a GPU."""

import json

import numpy as np
import pytest

import chip_smoke
from matchtigs_tpu import testing
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu.ops.device_graph import build_device_graph
from matchtigs_tpu.ops.matching import unbalanced_nodes


@pytest.fixture(scope="module")
def small_graph():
    store, _, k = testing.make_unitig_store(genome_length=60000, k=13, seed=42)
    g = build_bigraph_from_unitigs(store, k)
    dg = build_device_graph(g)
    out_nodes, in_mask, _ = unbalanced_nodes(g)
    sources = chip_smoke.parity_sources(dg, out_nodes, 96)
    host_keys = chip_smoke.host_reference(dg, sources, k - 1, in_mask)
    return dg, sources, in_mask, k, host_keys


@pytest.mark.parametrize(
    "branch", chip_smoke.BRANCHES, ids=chip_smoke.branch_name
)
def test_parity_branch_matches_host_dijkstra(small_graph, branch):
    dg, sources, in_mask, k, host_keys = small_graph
    r = chip_smoke.check_branch(
        dg, sources, in_mask, k - 1, host_keys, branch,
        capacity=2, batch_size=16,
    )
    # both regimes present: complete sources compared, overflowed skipped
    assert 0 < r["n_done"] < len(sources)
    assert r["n_triples"] > 0


def test_parity_check_detects_a_missing_triple(small_graph):
    dg, sources, in_mask, k, host_keys = small_graph
    with pytest.raises(AssertionError, match="device triples"):
        chip_smoke.check_branch(
            dg, sources, in_mask, k - 1, host_keys[1:],
            chip_smoke.BRANCHES[0], capacity=2, batch_size=16,
        )


def test_parity_sources_follow_the_device_stage_order(small_graph):
    dg, sources, *_ = small_graph
    difficulty = dg.nw.min(axis=1)[sources]
    assert np.all(np.diff(difficulty) <= 0)
    ties = np.diff(difficulty) == 0
    assert np.all(np.diff(sources)[ties] > 0)


def test_tig_file_oracle_accepts_tigs_and_rejects_a_bad_bitvector(tmp_path):
    import gzip

    from matchtigs_tpu.algos.greedytigs import (
        GreedytigConfig,
        compute_greedytigs,
    )
    from matchtigs_tpu.io.writers import (
        write_duplication_bitvector,
        write_walks_fasta,
    )

    store, kmers, k = testing.make_unitig_store(
        genome_length=20000, k=11, seed=1
    )
    g = build_bigraph_from_unitigs(store, k)
    tigs = compute_greedytigs(g, GreedytigConfig(k=k, engine="host"))
    fa, bv = tmp_path / "t.fa.gz", tmp_path / "t.bv.gz"
    write_walks_fasta(g, tigs, store, k, fa)
    write_duplication_bitvector(g, tigs, bv)
    assert "tigs" in chip_smoke.check_tig_file(fa, bv, kmers, k)
    bits = gzip.decompress(bv.read_bytes()).replace(b"0", b"1")
    bv.write_bytes(gzip.compress(bits))
    with pytest.raises(AssertionError, match="bitvector"):
        chip_smoke.check_tig_file(fa, bv, kmers, k)


def test_multi_phase_on_the_virtual_mesh(capsys):
    import jax

    store, _, k = testing.make_unitig_store(genome_length=20000, k=11, seed=1)
    g = build_bigraph_from_unitigs(store, k)
    chip_smoke.multi_phase(g, k, "cpu", n_keys=4096)
    out = capsys.readouterr().out
    assert "mesh greedytigs byte-identical" in out
    assert "of the SSSP sources: [" in out
    assert len(jax.devices()) == 8


def test_source_shards_sees_an_idle_device(small_graph):
    import jax

    from matchtigs_tpu.parallel import mesh

    dg, sources, _, k, _ = small_graph
    real = mesh.sharded_bounded_sssp
    with chip_smoke._SourceShards(jax.devices()) as shards:
        mesh.sharded_bounded_sssp(dg, sources[:3], k - 1, capacity=2)
    assert mesh.sharded_bounded_sssp is real
    assert sorted(shards.per_device.values()) == [0] * 5 + [1] * 3


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_refuses_the_cpu_platform(capsys, argv):
    rc = chip_smoke.main(argv)
    out = capsys.readouterr()
    assert rc != 0
    assert "needs" in out.err
    for line in out.out.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
