"""k in (32, 63]: two-word k-mer packing and the full pipeline on branchy
graphs (the void-row builder path and deeper bounded searches)."""

import numpy as np
import pytest

from matchtigs_tpu import testing
from matchtigs_tpu.algos.eulertigs import EulertigConfig, compute_eulertigs
from matchtigs_tpu.algos.greedytigs import GreedytigConfig, compute_greedytigs
from matchtigs_tpu.algos.pathtigs import compute_pathtigs
from matchtigs_tpu.graph.build import build_bigraph_from_unitigs
from matchtigs_tpu.utils import dna


def _brute_canonical_kmers(codes, k):
    out = set()
    for i in range(len(codes) - k + 1):
        km = codes[i : i + k]
        out.add(min(km.tobytes(), dna.revcomp(km).tobytes()))
    return out


@pytest.mark.parametrize("k", [33, 47, 63])
def test_two_word_packing_matches_bruteforce(k):
    codes = testing.random_genome(500, seed=k)
    got = testing.kmer_set_of_codes(codes, k)
    brute = _brute_canonical_kmers(codes, k)
    assert len(got) == len(brute)
    # decode packed canon kmers back to byte keys and compare
    hi, lo = testing._void_to_pairs(got)
    k_hi = k - 32
    decoded = set()
    for h, l in zip(hi.tolist(), lo.tolist()):
        arr = np.empty(k, dtype=np.uint8)
        for j in range(k_hi):
            arr[j] = (h >> (2 * (k_hi - 1 - j))) & 3
        for j in range(32):
            arr[k_hi + j] = (l >> (2 * (31 - j))) & 3
        decoded.add(arr.tobytes())
    assert decoded == brute


@pytest.mark.parametrize("seed", range(4))
def test_large_k_pipeline(seed):
    """Branchy graphs at k=33..63: repeats force junctions even at large k."""
    rng = np.random.default_rng(seed)
    k = int(rng.choice([33, 45, 63]))
    genome = testing.random_genome_with_repeats(
        20000, seed=seed, repeat_len=150, n_families=2,
        copies_per_family=40, divergence=0.08,
    )
    kmers = testing.kmer_set_of_codes(genome, k)
    unitigs = testing.unitigs_from_kmers(kmers, k)
    store = testing.SequenceStore()
    for u in unitigs:
        store.add(u)
    store.finalize()
    if len(store) < 3:
        pytest.skip("degenerate: too few unitigs")
    # generator output must reproduce the kmer set exactly, no duplicates
    ms = testing.kmer_multiset_of_walk_seqs(
        [store.get(i) for i in range(len(store))], k
    )
    assert len(ms) == len(kmers) and np.all(np.unique(ms) == kmers)

    g = build_bigraph_from_unitigs(store, k)
    for name, run in [
        ("pathtigs", lambda gg: compute_pathtigs(gg)),
        ("eulertigs", lambda gg: compute_eulertigs(gg, EulertigConfig(k=k))),
        ("greedytigs", lambda gg: compute_greedytigs(gg, GreedytigConfig(k=k, batch_size=128))),
    ]:
        gg = build_bigraph_from_unitigs(store, k)
        tigs = run(gg)
        testing.assert_tigs_spell_kmer_set(
            gg, tigs, store, k, kmers,
            allow_duplicates=name == "greedytigs",
        )


@pytest.mark.parametrize("k", [4, 6, 9, 31])
def test_unitigs_canonical_unique_and_complete(k):
    """Unitig extraction on repeat-rich input (cycles and palindromes at
    small k): every unitig is in its lexicographically smaller
    orientation, none repeats in either orientation, and together they
    spell the input k-mer set exactly once."""
    from matchtigs_tpu.utils import dna

    genome = testing.random_genome_with_repeats(
        20000, seed=k, repeat_len=50, copies_per_family=30
    )
    kmers = testing.kmer_set_of_codes(genome, k)
    unitigs = testing.unitigs_from_kmers(kmers, k)
    keys = set()
    for u in unitigs:
        fwd, bwd = u.tobytes(), dna.revcomp(u).tobytes()
        assert fwd <= bwd
        assert min(fwd, bwd) not in keys
        keys.add(min(fwd, bwd))
    ms = testing.kmer_multiset_of_walk_seqs(unitigs, k)
    assert np.array_equal(ms, kmers)


@pytest.mark.parametrize("k", [3, 11, 31])
def test_kmer_multiset_matches_scalar_canonical_kmers(k):
    """The k-mer oracle equals the scalar canonical form of every window
    of every sequence (sequences shorter than k add nothing, and no
    k-mer spans two sequences)."""
    from matchtigs_tpu.utils import dna

    rng = np.random.default_rng(k)
    seqs = [
        rng.integers(0, 4, n, dtype=np.uint8)
        for n in (0, 1, k - 1, k, k + 1, 50, 200)
    ]
    want = np.sort(np.array([
        min(dna.pack_u64(s[i : i + k]),
            dna.pack_u64(dna.revcomp(s[i : i + k])))
        for s in seqs for i in range(len(s) - k + 1)
    ], dtype=np.uint64))
    assert np.array_equal(testing.kmer_multiset_of_walk_seqs(seqs, k), want)
