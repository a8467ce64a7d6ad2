import numpy as np
import pytest

from matchtigs_tpu.utils import dna


def test_encode_decode_roundtrip():
    seq = b"ACGTACGTTTGGCCA"
    codes = dna.encode_ascii(seq)
    assert dna.decode_to_ascii(codes) == seq


def test_encode_rejects_invalid():
    with pytest.raises(ValueError):
        dna.encode_ascii(b"ACGN")


def test_revcomp():
    codes = dna.encode_ascii(b"AACGT")
    assert dna.decode_to_ascii(dna.revcomp(codes)) == b"ACGTT"


def test_pack_kmers_matches_scalar():
    codes = dna.encode_ascii(b"ACGTACGTA")
    k = 4
    packed = dna.pack_kmers_u64(codes, k)
    for i in range(len(codes) - k + 1):
        assert int(packed[i]) == dna.pack_u64(codes[i : i + k])


@pytest.mark.parametrize("k", [1, 5, 16, 31])
def test_revcomp_packed(k):
    codes = np.random.default_rng(k).integers(0, 4, 60, dtype=np.uint8)
    packed = dna.pack_kmers_u64(codes, k)
    rc = dna.revcomp_packed_u64(packed, k)
    for i in range(len(packed)):
        expected = dna.pack_u64(dna.revcomp(codes[i : i + k]))
        assert int(rc[i]) == expected


def test_canonical_packed():
    codes = dna.encode_ascii(b"ACGTTGCAAC")
    k = 5
    packed = dna.pack_kmers_u64(codes, k)
    canon = dna.canonical_packed_u64(packed, k)
    rc = dna.revcomp_packed_u64(packed, k)
    assert np.all(canon == np.minimum(packed, rc))
    # canonical is orientation-invariant
    rc_canon = dna.canonical_packed_u64(rc, k)
    assert np.all(canon == rc_canon)


def test_sequence_store_2bit_packing():
    """Arena is 2-bit packed: ~4x smaller than byte-per-base, with exact
    slice/revcomp round-trips at unaligned offsets."""
    import numpy as np

    from matchtigs_tpu.io.sequence_store import SequenceStore

    rng = np.random.default_rng(3)
    store = SequenceStore()
    seqs = []
    for _ in range(200):
        s = rng.integers(0, 4, int(rng.integers(1, 77))).astype(np.uint8)
        seqs.append(s)
        store.add(s.copy())
    store.finalize()
    total = sum(len(s) for s in seqs)
    assert store.size_in_memory() < total // 2  # ~total/4 + offsets
    for i, s in enumerate(seqs):
        assert np.array_equal(store.get(i), s)
        assert np.array_equal(store.get_rc(i), (3 - s)[::-1])
    # gather_windows at arbitrary offsets
    offs = store.offsets
    L = 5
    ok = np.flatnonzero((offs[1:] - offs[:-1]) >= L)
    got = store.gather_windows(offs[:-1][ok], L)
    for row, i in zip(got, ok.tolist()):
        assert np.array_equal(row, seqs[i][:L])


def test_sequence_store_from_flat_roundtrip():
    import numpy as np

    from matchtigs_tpu.io.sequence_store import SequenceStore

    rng = np.random.default_rng(4)
    store = SequenceStore()
    for _ in range(37):
        store.add(rng.integers(0, 4, int(rng.integers(1, 30))).astype(np.uint8))
    store.finalize()
    clone = SequenceStore.from_flat(store.codes, store.offsets)
    assert np.array_equal(clone.packed, store.packed)
    for i in range(len(store)):
        assert np.array_equal(clone.get(i), store.get(i))


def test_packed_windows_matches_gather_pack():
    """packed_windows must produce byte-identical keys to the
    gather_windows + _pack_rows path at every alignment and length."""
    import numpy as np

    from matchtigs_tpu.graph.build import _pack_rows
    from matchtigs_tpu.io.sequence_store import SequenceStore

    rng = np.random.default_rng(11)
    store = SequenceStore()
    for _ in range(40):
        store.add(rng.integers(0, 4, int(rng.integers(8, 90))).astype(np.uint8))
    store.finalize()
    total = int(store.offsets[-1])
    for length in (1, 2, 7, 15, 30, 31):
        starts = rng.integers(0, total - length + 1, 500).astype(np.int64)
        want = _pack_rows(store.gather_windows(starts, length))
        got = store.packed_windows(starts, length)
        assert got.dtype == np.uint64
        assert np.array_equal(got, want), length
