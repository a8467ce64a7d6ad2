import gzip

import numpy as np
import pytest

from matchtigs_tpu import testing
from matchtigs_tpu.cli import main
from matchtigs_tpu.io.readers import read_fasta, read_gfa


@pytest.fixture(scope="module")
def unitig_fa(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    store, kmers, k = testing.make_unitig_store(genome_length=4000, k=11, seed=5)
    path = tmp / "unitigs.fa.gz"
    with gzip.open(path, "wb") as f:
        for i in range(len(store)):
            f.write(b">%d\n%s\n" % (i, store.get_ascii(i)))
    return path, kmers, k


def test_cli_all_algorithms(unitig_fa, tmp_path):
    path, kmers, k = unitig_fa
    outs = {a: tmp_path / f"{a}.fa" for a in ("pathtigs", "eulertigs", "greedytigs", "matchtigs")}
    rc = main(
        [
            "--fa-in",
            str(path),
            "-k",
            str(k),
            "--pathtigs-fa-out",
            str(outs["pathtigs"]),
            "--eulertigs-fa-out",
            str(outs["eulertigs"]),
            "--greedytigs-fa-out",
            str(outs["greedytigs"]),
            "--matchtigs-fa-out",
            str(outs["matchtigs"]),
            "--greedytigs-duplication-bitvector-out",
            str(tmp_path / "greedy.bv"),
            "--log-level",
            "Warning",
        ]
    )
    assert rc == 0
    for algo, out in outs.items():
        store, _ = read_fasta(out)
        seqs = [store.get(i) for i in range(len(store))]
        ms = testing.kmer_multiset_of_walk_seqs(seqs, k)
        assert np.all(np.unique(ms) == kmers), f"{algo} kmer set mismatch"
        if algo in ("pathtigs", "eulertigs"):
            assert len(ms) == len(kmers), f"{algo} must not duplicate kmers"
    # bitvector: number of 0s equals number of duplicated kmers in greedytigs
    bv = (tmp_path / "greedy.bv").read_bytes().replace(b"\n", b"")
    store, _ = read_fasta(outs["greedytigs"])
    seqs = [store.get(i) for i in range(len(store))]
    ms = testing.kmer_multiset_of_walk_seqs(seqs, k)
    assert len(bv) == len(ms)
    assert bv.count(b"0") == len(ms) - len(np.unique(ms))


def test_cli_gfa_roundtrip(unitig_fa, tmp_path):
    path, kmers, k = unitig_fa
    gfa_out = tmp_path / "eulertigs.gfa.gz"
    rc = main(
        [
            "--fa-in",
            str(path),
            "-k",
            str(k),
            "--eulertigs-gfa-out",
            str(gfa_out),
            "--log-level",
            "Warning",
        ]
    )
    assert rc == 0
    store, props = read_gfa(gfa_out)
    assert props.k == k  # written header declares KL:Z:k
    seqs = [store.get(i) for i in range(len(store))]
    ms = testing.kmer_multiset_of_walk_seqs(seqs, k)
    assert np.all(np.unique(ms) == kmers)


def test_cli_no_outputs(unitig_fa):
    path, _, k = unitig_fa
    assert main(["--fa-in", str(path), "-k", str(k), "--log-level", "Warning"]) == 0


def test_cli_compression_levels(unitig_fa, tmp_path):
    path, kmers, k = unitig_fa
    for level in (0, 9):
        out = tmp_path / f"e{level}.fa.gz"
        rc = main(
            [
                "--fa-in",
                str(path),
                "-k",
                str(k),
                "--eulertigs-fa-out",
                str(out),
                "--compression-level",
                str(level),
                "--log-level",
                "Warning",
            ]
        )
        assert rc == 0
        store, _ = read_fasta(out)
        seqs = [store.get(i) for i in range(len(store))]
        ms = testing.kmer_multiset_of_walk_seqs(seqs, k)
        assert np.all(np.unique(ms) == kmers)


def test_cli_threads_flag(unitig_fa, tmp_path):
    path, kmers, k = unitig_fa
    rc = main(
        [
            "--fa-in",
            str(path),
            "-k",
            str(k),
            "-t",
            "2",
            "--greedytigs-fa-out",
            str(tmp_path / "g.fa"),
            "--log-level",
            "Warning",
        ]
    )
    assert rc == 0


def test_debug_spell_output(tmp_path):
    """--debug-spell-prefix emits per-edge annotations whose concatenated
    spelled parts reconstruct each tig exactly."""
    import re

    from matchtigs_tpu import testing

    store, _, k = testing.make_unitig_store(genome_length=3000, k=9, seed=8)
    fa_in = tmp_path / "in.fa"
    with open(fa_in, "wb") as f:
        for i in range(len(store)):
            f.write(b">%d\n%s\n" % (i, store.get_ascii(i)))
    fa_out = tmp_path / "out.fa"
    prefix = tmp_path / "dbg"
    from matchtigs_tpu.cli import main

    rc = main([
        "--fa-in", str(fa_in), "-k", str(k),
        "--eulertigs-fa-out", str(fa_out),
        "--debug-spell-prefix", str(prefix),
    ])
    assert rc == 0
    spell = (tmp_path / "dbg.eulertigs.spell").read_text()
    tig_blocks = re.split(r"tig \d+\n", spell)[1:]
    fasta_seqs = [
        l.strip() for l in open(fa_out) if not l.startswith(">")
    ]
    assert len(tig_blocks) == len(fasta_seqs)
    for block, seq in zip(tig_blocks, fasta_seqs):
        parts = []
        for ann in block.split("|")[1:]:
            ann = ann.strip()
            if ann.startswith("skip dummy"):
                continue
            parts.append(ann.split()[-1])
        assert "".join(parts) == seq


def test_gfa_star_sequence_rejected(tmp_path):
    """GFA S-lines with '*' (absent) sequences must fail with a clear
    error: tig computation needs the sequences to spell outputs."""
    gfa = tmp_path / "star.gfa"
    gfa.write_text("H\tVN:Z:1.0\nS\t1\tACGT\nS\t2\t*\tLN:i:7\n")
    with pytest.raises(ValueError, match="'\\*'"):
        read_gfa(gfa)


def test_performance_counters_logged(unitig_fa, tmp_path, caplog):
    """--dijkstra-performance-data-type enables ball-size counters (the
    reference's opt-in Dijkstra performance data analog)."""
    import logging

    path, kmers, k = unitig_fa
    with caplog.at_level(logging.INFO, logger="matchtigs_tpu"):
        rc = main([
            "--fa-in", str(path), "-k", str(k),
            "--greedytigs-fa-out", str(tmp_path / "g.fa"),
            "--dijkstra-performance-data-type", "Complete",
            "--log-level", "Info",
        ])
    assert rc == 0
    assert any("Ball sizes:" in r.message for r in caplog.records)


def test_read_fasta_trailing_cr_no_newline(tmp_path):
    """CRLF file truncated after the final CR must still parse (the old
    per-line parser accepted it; regression for the vectorized parse)."""
    import numpy as np

    p = tmp_path / "cr.fa"
    p.write_bytes(b">u1\r\nACGTACGT\r\nACGT\r")
    store, headers = read_fasta(p)
    assert len(store) == 1
    assert store.length(0) == 12
    assert headers == [b"u1"]


def test_dijkstra_strategy_flags(unitig_fa, tmp_path, caplog):
    """The reference's Dijkstra strategy flags select a real host engine
    (reference dispatch src/implementation/mod.rs:62-126): HashbrownHashMap
    maps to the binary-heap + hashmap engine, EpochNodeWeightArray to the
    Dial-bucket epoch-array engine; outputs are identical."""
    import logging

    path, kmers, k = unitig_fa
    out_default = tmp_path / "default.fa"
    out_heap = tmp_path / "heap.fa"
    assert (
        main(
            ["--fa-in", str(path), "-k", str(k),
             "--greedytigs-fa-out", str(out_default),
             "--dijkstra-node-weight-array-type", "EpochNodeWeightArray",
             "--log-level", "Warning"]
        )
        == 0
    )
    with caplog.at_level(logging.INFO, logger="matchtigs_tpu"):
        assert (
            main(
                ["--fa-in", str(path), "-k", str(k),
                 "--greedytigs-fa-out", str(out_heap),
                 "--dijkstra-heap-type", "StdBinaryHeap",
                 "--dijkstra-node-weight-array-type", "HashbrownHashMap",
                 "--log-level", "Warning"]
            )
            == 0
        )
    assert any("host engine 'heap'" in r.message for r in caplog.records)
    assert out_default.read_bytes() == out_heap.read_bytes()


def test_dijkstra_strategy_flag_rejects_unknown(unitig_fa, tmp_path):
    path, _, k = unitig_fa
    with pytest.raises(SystemExit):
        main(
            ["--fa-in", str(path), "-k", str(k),
             "--greedytigs-fa-out", str(tmp_path / "x.fa"),
             "--dijkstra-node-weight-array-type", "BTreeMap"]
        )


def test_phase_memory_logged_at_info(unitig_fa, tmp_path, caplog):
    """The reference logs a memory snapshot after every phase at info
    level (src/bin.rs:842-848 called at 872, 921, 998)."""
    import logging

    path, _, k = unitig_fa
    with caplog.at_level(logging.INFO, logger="matchtigs_tpu"):
        main(
            ["--fa-in", str(path), "-k", str(k),
             "--eulertigs-fa-out", str(tmp_path / "e.fa"),
             "--log-level", "Warning"]
        )
    mem_lines = [r.message for r in caplog.records if "memory usage" in r.message]
    assert any("After load" in m for m in mem_lines)
    assert any("After eulertigs" in m for m in mem_lines)


def test_sssp_cli_defaults_track_config_defaults():
    """Unset --sssp-* flags must resolve to the dataclass defaults, never
    shadow them (the CLI once pinned C=16/batch=8192 while the dataclass
    defaults were 4/4096)."""
    from matchtigs_tpu.algos.greedytigs import GreedytigConfig
    from matchtigs_tpu.algos.matchtigs import MatchtigConfig
    from matchtigs_tpu.cli import _sssp_overrides, build_parser

    opts = build_parser().parse_args(["--fa-in", "x.fa", "-k", "5"])
    assert opts.sssp_initial_capacity is None
    assert opts.sssp_batch_size is None
    assert _sssp_overrides(opts) == {}
    # Both algorithm configs agree (so "fill from the dataclass" is
    # unambiguous), and an explicit flag still wins.
    assert GreedytigConfig.initial_capacity == MatchtigConfig.initial_capacity
    assert GreedytigConfig.batch_size == MatchtigConfig.batch_size
    opts = build_parser().parse_args(
        ["--fa-in", "x.fa", "-k", "5",
         "--sssp-initial-capacity", "8", "--sssp-batch-size", "2048"]
    )
    assert _sssp_overrides(opts) == {"initial_capacity": 8, "batch_size": 2048}
