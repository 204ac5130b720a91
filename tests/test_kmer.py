from collections import Counter

import pytest

import jax.numpy as jnp
import numpy as np

from mitoflex_tpu.io import encoding
from mitoflex_tpu.ops import kmer as kmer_ops
from tests import synth


def naive_kmer_counts(seqs, k):
    """Both-strand k-mer counter (skip windows with N)."""
    comp = str.maketrans("ACGTN", "TGCAN")
    c = Counter()
    for s in seqs:
        for strand in (s, s.translate(comp)[::-1]):
            for i in range(len(strand) - k + 1):
                w = strand[i : i + k]
                if "N" not in w:
                    c[w] += 1
    return c


def pack_str(s, W):
    words = [0] * W
    for i, ch in enumerate(s):
        w, t = divmod(i, 16)
        words[w] |= "ACGT".index(ch) << (2 * (15 - t))
    return tuple(words)


def _to_batch(seqs, L):
    B = len(seqs)
    arr = np.full((B, L), 4, dtype=np.int8)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = encoding.encode(s)
        lens[i] = len(s)
    return arr, lens


def test_extract_kmers_small():
    seqs, lens = _to_batch(["ACGTA", "GGNCC"], 8)
    words, valid = kmer_ops.extract_kmers(jnp.asarray(seqs), jnp.asarray(lens), 3)
    valid = np.asarray(valid)
    w0 = np.asarray(words[0])
    # row 0: ACG, CGT, GTA valid
    assert valid[0].tolist() == [True, True, True, False, False, False]
    assert w0[0, 0] == pack_str("ACG", 1)[0]
    assert w0[0, 2] == pack_str("GTA", 1)[0]
    # row 1: GGN, GNC, NCC invalid (N), nothing valid
    assert valid[1].tolist() == [False, False, False, False, False, False]


def test_count_chunk_matches_naive(rng):
    g = synth.random_genome(rng, 300)
    reads = [r for r, _ in synth.shotgun_reads(rng, g, 40, read_len=60)]
    k = 21
    seqs, lens = _to_batch(reads, 64)
    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lens), k)
    nu = int(nu)
    keys = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    counts = np.asarray(uc)[:nu]
    got = {}
    W = keys.shape[1]
    for row, c in zip(keys, counts):
        got[tuple(int(x) for x in row)] = int(c)
    want = naive_kmer_counts(reads, k)
    want_packed = Counter()
    for s, c in want.items():
        want_packed[pack_str(s, W)] += c
    assert got == dict(want_packed)
    # sortedness
    view = kmer_ops.np_keys_view(keys)
    assert (np.sort(view) == view).all()


def test_count_chunk_long_kmer(rng):
    """k > 16 spans multiple words; k=33 spans 3."""
    g = synth.random_genome(rng, 200)
    reads = [g[i : i + 80] for i in range(0, 120, 7)]
    k = 33
    seqs, lens = _to_batch(reads, 96)
    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lens), k)
    nu = int(nu)
    keys = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    counts = np.asarray(uc)[:nu]
    want = naive_kmer_counts(reads, k)
    assert nu == len(want)
    assert int(counts.sum()) == sum(want.values())


def test_merge_sorted_counts():
    a = np.array([[1, 0], [3, 5], [7, 7]], np.uint32)
    ac = np.array([2, 1, 4], np.uint64)
    b = np.array([[0, 9], [3, 5], [9, 0]], np.uint32)
    bc = np.array([1, 10, 3], np.uint64)
    mk, mc = kmer_ops.merge_sorted_counts(a, ac, b, bc)
    assert mk.tolist() == [[0, 9], [1, 0], [3, 5], [7, 7], [9, 0]]
    assert mc.tolist() == [1, 2, 11, 4, 3]


def test_multiword_searchsorted():
    rng = np.random.default_rng(1)
    V, Q, W = 100, 64, 3
    table = rng.integers(0, 50, size=(V, W)).astype(np.uint32)
    view = kmer_ops.np_keys_view(table)
    table = table[np.argsort(view)]
    pad = np.full((28, W), 0xFFFFFFFF, np.uint32)
    padded = np.concatenate([table, pad])
    queries = rng.integers(0, 55, size=(Q, W)).astype(np.uint32)
    got = kmer_ops.multiword_searchsorted(
        [jnp.asarray(padded[:, w]) for w in range(W)],
        [jnp.asarray(queries[:, w]) for w in range(W)],
        jnp.int32(V),
    )
    want = np.searchsorted(
        kmer_ops.np_keys_view(table), kmer_ops.np_keys_view(queries), side="left"
    )
    np.testing.assert_array_equal(np.asarray(got), want)


def test_count_chunk_runs_matches_exact(rng):
    """The fast run-length path agrees with the exact compacted path,
    including ragged rows and N windows."""
    g = synth.random_genome(rng, 400)
    reads = [r for r, _ in synth.shotgun_reads(rng, g, 30, read_len=70)]
    reads.append("ACGTNNACGTACGTACGTACGTACGTACGTACGTACGT")
    k = 17
    seqs, lens = _to_batch(reads, 80)
    keys_f, cnt_f = kmer_ops.count_chunk_host(seqs, lens, k)
    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lens), k)
    nu = int(nu)
    keys_e = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    np.testing.assert_array_equal(keys_f, keys_e)
    np.testing.assert_array_equal(cnt_f, np.asarray(uc)[:nu])


def test_count_chunk_runs_all_t_sentinel(rng):
    """A poly-T read produces real all-T k-mers of word width 16 — they
    share bits with the invalid sentinel and must still count correctly."""
    k = 16  # 32 bits exactly: all-T 16-mer == 0xFFFFFFFF
    reads = ["T" * 40, "A" * 40, synth.random_genome(rng, 40)]
    seqs, lens = _to_batch(reads, 48)
    keys, cnt = kmer_ops.count_chunk_host(seqs, lens, k)
    got = {tuple(int(x) for x in row): int(c) for row, c in zip(keys, cnt)}
    want = naive_kmer_counts(reads, k)
    allt = pack_str("T" * k, kmer_ops.num_words(k))
    assert got[allt] == want["T" * k]
    total_want = sum(want.values())
    assert int(cnt.sum()) == total_want


def test_revcomp_codes():
    seqs, lens = _to_batch(["ACGT", "AAC"], 6)
    rc = np.asarray(kmer_ops.revcomp_codes(jnp.asarray(seqs), jnp.asarray(lens)))
    assert encoding.decode(rc[0][:4]) == "ACGT"
    assert encoding.decode(rc[1][:3]) == "GTT"
    assert (rc[0][4:] == 4).all() and (rc[1][3:] == 4).all()


def test_canonical_counting_expands_to_both_strand(rng):
    """canonical count + expand == both-strand count, incl. a palindromic
    k-mer (k even) and N windows."""
    g = synth.random_genome(rng, 300)
    # embed a palindromic 16-mer (revcomp of ACGTTGCA+rc construction)
    half = "ACGTTGCA"
    pal = half + encoding.revcomp_str(half)
    reads = [g[i : i + 70] for i in range(0, 150, 9)] + [g[40:90] + pal + g[90:110], "ACGTNNA" + pal]
    k = 16
    seqs, lens = _to_batch(reads, 96)
    # both-strand ground truth via the exact path
    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lens), k)
    nu = int(nu)
    keys_e = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    counts_e = np.asarray(uc)[:nu].astype(np.uint64)
    # canonical + expansion
    ck, cc = kmer_ops.count_chunk_host(seqs, lens, k, canonical=True)
    xk, xc = kmer_ops.expand_canonical(ck, cc, k)
    np.testing.assert_array_equal(xk, keys_e)
    np.testing.assert_array_equal(xc, counts_e)


def test_np_revcomp_keys_matches_string(rng):
    for k in (17, 32, 33, 21):
        W = kmer_ops.num_words(k)
        s = synth.random_genome(rng, k)
        key = np.array([pack_str(s, W)], dtype=np.uint32)
        rc = kmer_ops.np_revcomp_keys(key, k)
        want = np.array([pack_str(encoding.revcomp_str(s), W)], dtype=np.uint32)
        np.testing.assert_array_equal(rc, want)


def test_merge_runs_device_matches_host(rng):
    """Device LSM merge == host sorted-run merge, incl. all-T/pad overlap."""
    W = 2
    def mk_run(nkeys, cap, seed):
        r = np.random.default_rng(seed)
        keys = r.integers(0, 2**32, (nkeys, W), dtype=np.uint32)
        keys[0] = [0xFFFFFFFF, 0xFFFFFFFF]  # a real all-ones key
        view = kmer_ops.np_keys_view(keys)
        keys = keys[np.argsort(view)]
        keys = keys[np.concatenate([[True], view[np.argsort(view)][1:] != view[np.argsort(view)][:-1]])]
        counts = r.integers(1, 50, len(keys)).astype(np.uint64)
        words = [np.full(cap, 0xFFFFFFFF, np.uint32) for _ in range(W)]
        ccap = np.zeros(cap, np.uint32)
        for w in range(W):
            words[w][: len(keys)] = keys[:, w]
        ccap[: len(keys)] = counts
        return keys, counts, ([jnp.asarray(x) for x in words], jnp.asarray(ccap),
                              jnp.int32(len(keys)))

    ka, ca, run_a = mk_run(40, 64, 1)
    kb, cb, run_b = mk_run(30, 64, 2)
    # overlap some keys
    mw, mc, mn = kmer_ops.merge_runs_device(*run_a, *run_b)
    mn = int(mn)
    got_keys = np.stack([np.asarray(w)[:mn] for w in mw], axis=1)
    got_counts = np.asarray(mc)[:mn].astype(np.uint64)
    want_keys, want_counts = kmer_ops.merge_sorted_counts(ka, ca, kb, cb)
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_array_equal(got_counts, want_counts)


def test_count_chunk_device_matches_host(rng):
    g = synth.random_genome(rng, 400)
    reads = [r for r, _ in synth.shotgun_reads(rng, g, 40, read_len=70)]
    k = 22
    seqs, lens = _to_batch(reads, 80)
    for canonical in (False, True):
        words, counts, n = kmer_ops.count_chunk_device(
            jnp.asarray(seqs), jnp.asarray(lens), k, canonical
        )
        n = int(n)
        got_k = np.stack([np.asarray(w)[:n] for w in words], axis=1)
        got_c = np.asarray(counts)[:n].astype(np.uint64)
        want_k, want_c = kmer_ops.count_chunk_host(seqs, lens, k, canonical=canonical)
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_c, want_c)


def test_multiword_join_sorted(rng):
    W = 2
    table = rng.integers(0, 100, (50, W)).astype(np.uint32)
    view = kmer_ops.np_keys_view(table)
    order = np.argsort(view)
    table = table[order]
    keep = np.concatenate([[True], view[order][1:] != view[order][:-1]])
    table = table[keep]
    Tn = len(table)
    cap = 64
    padded = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    padded[:Tn] = table
    # queries: members of the table, shuffled, with repeats
    qidx = rng.integers(0, Tn, 40)
    queries = table[qidx]
    got = np.asarray(kmer_ops.multiword_join_sorted(
        [jnp.asarray(padded[:, w]) for w in range(W)],
        jnp.int32(Tn),
        [jnp.asarray(queries[:, w]) for w in range(W)],
    ))
    np.testing.assert_array_equal(got, qidx)


def test_unique_words_device(rng):
    W = 2
    raw = rng.integers(0, 8, (30, W)).astype(np.uint32)
    valid = rng.random(30) > 0.2
    words, n = kmer_ops.unique_words_device(
        [jnp.asarray(raw[:, w]) for w in range(W)], jnp.asarray(valid)
    )
    n = int(n)
    got = np.stack([np.asarray(w)[:n] for w in words], axis=1)
    want = np.unique(kmer_ops.np_keys_view(raw[valid]))
    assert n == len(want)
    np.testing.assert_array_equal(kmer_ops.np_keys_view(got), want)


def test_multiword_member_sorted(rng):
    W = 2
    table = rng.integers(0, 60, (40, W)).astype(np.uint32)
    view = kmer_ops.np_keys_view(table)
    order = np.argsort(view)
    table = table[order]
    keep = np.concatenate([[True], view[order][1:] != view[order][:-1]])
    table = table[keep]
    Tn = len(table)
    cap = 64
    padded = np.full((cap, W), 0xFFFFFFFF, np.uint32)
    padded[:Tn] = table
    # half members, half foreign keys
    members = table[rng.integers(0, Tn, 25)]
    foreign = rng.integers(100, 200, (25, W)).astype(np.uint32)
    queries = np.concatenate([members, foreign])
    perm = rng.permutation(len(queries))
    queries = queries[perm]
    want = perm < 25
    got = np.asarray(kmer_ops.multiword_member_sorted(
        [jnp.asarray(padded[:, w]) for w in range(W)],
        jnp.int32(Tn),
        [jnp.asarray(queries[:, w]) for w in range(W)],
    ))
    np.testing.assert_array_equal(got, want)


def test_multiword_member_sorted_all_ones_collision():
    """An all-0xFFFFFFFF QUERY key (the all-T (k+1)-mer when 2(k+1) is a
    multiple of 32, e.g. k=15 or k=31) must NOT match table PADDING —
    only a real table row with that key."""
    W = 1
    padded = np.full((8, W), 0xFFFFFFFF, np.uint32)
    padded[0, 0] = 5
    padded[1, 0] = 9
    Tn = 2
    q = np.array([[0xFFFFFFFF], [5], [7]], np.uint32)
    got = np.asarray(kmer_ops.multiword_member_sorted(
        [jnp.asarray(padded[:, 0])], jnp.int32(Tn), [jnp.asarray(q[:, 0])]
    ))
    np.testing.assert_array_equal(got, [False, True, False])
    # and when the all-T key IS a real row, it must match
    padded2 = padded.copy()
    padded2[2, 0] = 0xFFFFFFFF
    got2 = np.asarray(kmer_ops.multiword_member_sorted(
        [jnp.asarray(padded2[:, 0])], jnp.int32(3), [jnp.asarray(q[:, 0])]
    ))
    np.testing.assert_array_equal(got2, [True, True, False])


def test_count_chunk_scattered_matches_host(rng):
    g = synth.random_genome(rng, 400)
    reads = [r for r, _ in synth.shotgun_reads(rng, g, 40, read_len=70)]
    k = 22
    seqs, lens = _to_batch(reads, 80)
    for canonical in (False, True):
        words, counts = kmer_ops.count_chunk_scattered(
            jnp.asarray(seqs), jnp.asarray(lens), k, canonical
        )
        n = counts.shape[0]
        assert n >= 128 and (n & (n - 1)) == 0  # pow2 capacity contract
        got_k, got_c = kmer_ops.pull_scattered(words, counts)
        want_k, want_c = kmer_ops.count_chunk_host(seqs, lens, k, canonical=canonical)
        np.testing.assert_array_equal(got_k, want_k)
        np.testing.assert_array_equal(got_c, want_c)


def test_scattered_lsm_matches_host_merge(rng):
    """Chained merge_scattered over unequal-capacity scattered runs (incl.
    a real all-T key colliding with padding) == host merge_sorted_counts."""
    W = 2

    def mk_scattered(nkeys, cap, seed, all_t=False):
        r = np.random.default_rng(seed)
        keys = r.integers(0, 2**32, (nkeys, W), dtype=np.uint32)
        if all_t:
            keys[0] = [0xFFFFFFFF, 0xFFFFFFFF]
        view = kmer_ops.np_keys_view(keys)
        order = np.argsort(view)
        keys = keys[order]
        keep = np.concatenate([[True], view[order][1:] != view[order][:-1]])
        keys = keys[keep]
        counts = r.integers(1, 50, len(keys)).astype(np.uint64)
        words = [np.full(cap, 0xFFFFFFFF, np.uint32) for _ in range(W)]
        cc = np.zeros(cap, np.uint32)
        for w in range(W):
            words[w][: len(keys)] = keys[:, w]
        cc[: len(keys)] = counts
        return keys, counts, ([jnp.asarray(x) for x in words], jnp.asarray(cc))

    ka, ca, ra = mk_scattered(40, 128, 1, all_t=True)
    kb, cb, rb = mk_scattered(30, 128, 2)
    kc, cc_, rc = mk_scattered(90, 256, 3, all_t=True)
    m1 = kmer_ops.merge_scattered(ra[0], ra[1], rb[0], rb[1])
    m2 = kmer_ops.merge_scattered(m1[0], m1[1], rc[0], rc[1])  # 256 vs 256
    got_k, got_c = kmer_ops.pull_scattered(m2[0], m2[1])
    w1 = kmer_ops.merge_sorted_counts(ka, ca, kb, cb)
    want_k, want_c = kmer_ops.merge_sorted_counts(w1[0], w1[1], kc, cc_)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


def test_kmer_counter_spill_path(rng):
    """KmerCounter with a tiny device cap: scattered runs spill to the
    host mid-LSM and the final table still matches a one-shot count
    (mixed device/host levels, canonical + expand path exercised by
    solid())."""
    from mitoflex_tpu.stages.assemble import KmerCounter

    g = synth.random_genome(rng, 1200)
    reads = [r for r, _ in synth.shotgun_reads(rng, g, 300, read_len=70)]
    k = 25
    counter = KmerCounter(k, canonical=True, max_device_rows=4096,
                          prefer_host=False)
    for i in range(0, len(reads), 60):
        seqs, lens = _to_batch(reads[i : i + 60], 80)
        counter.add_chunk(seqs, lens)
    got_k, got_c = counter.solid(1)
    assert counter._levels, "cap never spilled - test misconfigured"

    big = KmerCounter(k, canonical=True)
    seqs, lens = _to_batch(reads, 80)
    big.add_chunk(seqs, lens)
    want_k, want_c = big.solid(1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)


@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", [15, 22, 31, 32])
def test_count_chunk_numpy_matches_host(rng, k, canonical):
    """The pure-numpy rolling-pack counter (the CPU backend's hot path)
    must match count_chunk_host byte for byte — including N poisoning,
    short rows, and canonical min-of-strands."""
    B, L = 37, 70
    seqs = rng.integers(0, 4, (B, L)).astype(np.int8)
    # sprinkle Ns and a fully-invalid row
    seqs[rng.random((B, L)) < 0.05] = 4
    seqs[3] = 4
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[5] = 0
    want_k, want_c = kmer_ops.count_chunk_host(seqs, lens, k, canonical=canonical)
    got_k, got_c = kmer_ops.count_chunk_numpy(seqs, lens, k, canonical=canonical)
    np.testing.assert_array_equal(want_k, got_k)
    np.testing.assert_array_equal(want_c, got_c)


def test_count_chunk_numpy_empty():
    z_k, z_c = kmer_ops.count_chunk_numpy(np.zeros((0, 50), np.int8),
                                          np.zeros(0, np.int32), 21)
    assert z_k.shape == (0, 2) and len(z_c) == 0
    z_k, z_c = kmer_ops.count_chunk_numpy(np.zeros((4, 10), np.int8),
                                          np.full(4, 10, np.int32), 21)
    assert len(z_c) == 0


def test_count_chunk_numpy2_parity(rng):
    """Two-u64 host counting (32 < k <= 64) matches the device runs path
    exactly — keys, counts, canonical min, N handling, short reads."""
    from mitoflex_tpu.ops import kmer as kmer_ops

    for k in (33, 48, 56, 64):
        seqs = rng.integers(0, 5, (200, 120)).astype(np.int8)
        lens = rng.integers(0, 121, 200).astype(np.int32)
        for canonical in (False, True):
            k1, c1 = kmer_ops.count_chunk_host(seqs, lens, k,
                                               canonical=canonical)
            k2, c2 = kmer_ops.count_chunk_numpy2(seqs, lens, k,
                                                 canonical=canonical)
            np.testing.assert_array_equal(k1, k2)
            np.testing.assert_array_equal(c1.astype(np.uint64), c2)


@pytest.mark.parametrize("k", [31, 39, 59, 79, 99, 119, 141])
def test_scattered_chain_matches_host_route_default_klist(k):
    """The device LSM route at every k of the default k-list ((k+1)-mer
    keys up to W=9): count_chunk_scattered per chunk plus a chain of
    merge_scattered equals the CPU backend's host route (per-chunk host
    counting + merge_sorted_counts), keys and uint64 totals exact."""
    from mitoflex_tpu.stages import assemble as asm

    rng = np.random.default_rng(k)
    genome = synth.random_genome(rng, 900)
    chunks = []
    for _ in range(3):
        reads = [r for r, _ in synth.shotgun_reads(
            rng, genome, 24, read_len=150, circular=True, error_rate=0.01)]
        chunks.append(_to_batch(reads, 160))
    kp1 = k + 1
    runs = [kmer_ops.count_chunk_scattered(jnp.asarray(s), jnp.asarray(l), kp1, True)
            for s, l in chunks]
    merged = runs[0]
    for r in runs[1:]:
        merged = kmer_ops.merge_scattered(merged[0], merged[1], r[0], r[1])
    got_k, got_c = kmer_ops.pull_scattered(*merged)
    host = asm.KmerCounter(kp1, canonical=True, prefer_host=True)
    for s, l in chunks:
        host.add_chunk(s, l)
    want_k, want_c = host._merged()
    assert got_k.shape[1] == kmer_ops.num_words(kp1)
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_c, want_c)
