import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mitoflex_tpu.ops import filter as filter_ops
from mitoflex_tpu.ops import kmer as kmer_ops
from mitoflex_tpu.parallel import mesh as mesh_mod


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return mesh_mod.make_mesh((8,), ("data",))


def _batch(rng, B=64, L=128):
    seqs = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    quals = rng.integers(60, 74, size=(B, L)).astype(np.int8)
    lengths = rng.integers(32, L + 1, size=B).astype(np.int32)
    return seqs, quals, lengths


def test_sharded_filter_matches_single(mesh8, rng):
    seqs, quals, lengths = _batch(rng)
    ds, dq, dl = mesh_mod.shard_batch(
        mesh8, jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lengths)
    )
    keep_s, h1_s, h2_s = mesh_mod.filter_reads_sharded(mesh8, ds, dq, dl)
    keep, h1, h2 = filter_ops.filter_reads_ref(seqs, quals, lengths, 10, 55, 0.2)
    np.testing.assert_array_equal(np.asarray(keep_s), np.asarray(keep))
    np.testing.assert_array_equal(np.asarray(h1_s), np.asarray(h1))


def test_sharded_kmer_count_matches_single(mesh8, rng):
    seqs, _, lengths = _batch(rng, B=64, L=96)
    k = 21
    ds, dl = mesh_mod.shard_batch(mesh8, jnp.asarray(seqs), jnp.asarray(lengths))
    words_s, counts_s, n_s = mesh_mod.count_kmers_sharded(mesh8, ds, dl, k)
    n_s = int(n_s)
    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lengths), k)
    nu = int(nu)
    assert n_s == nu
    got = kmer_ops.words_to_np_keys([np.asarray(w)[:n_s] for w in words_s])
    want = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.asarray(counts_s)[:n_s], np.asarray(uc)[:nu]
    )


def test_partitioned_kmer_merge_matches_single(mesh8, rng):
    """all_to_all range-partitioned merge: concatenating the per-device
    key-range shards reproduces the single-device global table exactly,
    with zero bucket overflow at the default slack."""
    seqs, _, lengths = _batch(rng, B=64, L=96)
    k = 21
    ds, dl = mesh_mod.shard_batch(mesh8, jnp.asarray(seqs), jnp.asarray(lengths))
    words_p, counts_p, n_per, overflow = mesh_mod.count_kmers_sharded_partitioned(
        mesh8, ds, dl, k
    )
    assert int(overflow) == 0
    n_per = np.asarray(n_per)
    ndev = 8
    shard_rows = counts_p.shape[0] // ndev
    got_keys, got_counts = [], []
    for d in range(ndev):
        nu = int(n_per[d])
        rows = slice(d * shard_rows, d * shard_rows + nu)
        got_keys.append(kmer_ops.words_to_np_keys(
            [np.asarray(w)[rows] for w in words_p]))
        got_counts.append(np.asarray(counts_p)[rows])
    got_keys = np.concatenate(got_keys)
    got_counts = np.concatenate(got_counts)

    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lengths), k)
    nu = int(nu)
    want_keys = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    # shards are ascending key ranges, so the concatenation is sorted too
    np.testing.assert_array_equal(got_keys, want_keys)
    np.testing.assert_array_equal(got_counts, np.asarray(uc)[:nu])


def test_sharded_mapper_matches_single(mesh8, rng):
    from mitoflex_tpu.io.fasta import FastaRecord
    from mitoflex_tpu.ops import mapper as mapper_ops
    from tests import synth

    g = synth.random_genome(rng, 3000)
    recs = [FastaRecord("c0", g[:1500]), FastaRecord("c1", g[1500:])]
    index = mapper_ops.ContigIndex.build(recs)
    B, L = 64, 100
    seqs = np.zeros((B, L), np.int8)
    lengths = np.full(B, L, np.int32)
    from mitoflex_tpu.io import encoding
    for i in range(B):
        s = int(rng.integers(0, len(g) - L))
        seqs[i] = encoding.encode(g[s : s + L].encode())
    ds, dl = mesh_mod.shard_batch(mesh8, jnp.asarray(seqs), jnp.asarray(lengths))
    c_s, p_s, st_s, v_s, r_s = mesh_mod.map_reads_sharded(
        mesh8, index.keys, index.contig_of, index.pos_of, ds, dl
    )
    want = mapper_ops.map_batch(index, seqs, lengths, min_votes=2)
    np.testing.assert_array_equal(np.asarray(c_s), want.contig)
    np.testing.assert_array_equal(np.asarray(p_s), want.pos)
    np.testing.assert_array_equal(np.asarray(st_s), want.strand)
    np.testing.assert_array_equal(np.asarray(r_s), want.raw_pos)


def test_sharded_sw_matches_single(mesh8, rng):
    from mitoflex_tpu.ops import sw as sw_ops

    B, L = 64, 80
    seqs = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    tgts = seqs.copy()
    tgts[:, 10:14] = (tgts[:, 10:14] + 1) % 4          # plant mismatches
    lens = np.full(B, L, np.int32)
    sm = jnp.asarray(sw_ops.nucleotide_matrix())
    dq, dl, dt, dtl = mesh_mod.shard_batch(
        mesh8, jnp.asarray(seqs), jnp.asarray(lens),
        jnp.asarray(tgts), jnp.asarray(lens),
    )
    got = mesh_mod.sw_align_sharded(mesh8, dq, dl, dt, dtl, sm,
                                    gap_open=5.0, gap_extend=2.0)
    want = sw_ops.sw_align(jnp.asarray(seqs), jnp.asarray(lens),
                           jnp.asarray(tgts), jnp.asarray(lens), sm,
                           gap_open=5.0, gap_extend=2.0)
    np.testing.assert_allclose(np.asarray(got.score), np.asarray(want.score))
    np.testing.assert_array_equal(np.asarray(got.n_ident), np.asarray(want.n_ident))
    np.testing.assert_array_equal(np.asarray(got.q_from), np.asarray(want.q_from))


def test_graft_entry_and_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.asarray(out.score).shape == (64,)
    ge.dryrun_multichip(8)
    ge.dryrun_multichip(2)


def test_partitioned_merge_clipped_buckets(mesh8, rng):
    """The all_to_all-partitioned merge when bucket windows are clipped
    (start < lo[j]): foreign keys ride with count 0 and the merged table
    still equals the single-device count. Random near-unique keys make
    lo[last] > M - C, so clipping engages."""
    # FULL-length random reads: nearly every window is valid and unique,
    # so nu ~ M and the last buckets start past M - C
    seqs = rng.integers(0, 4, size=(64, 96)).astype(np.int8)
    lengths = np.full(64, 96, np.int32)
    k = 21
    ds, dl = mesh_mod.shard_batch(mesh8, jnp.asarray(seqs), jnp.asarray(lengths))
    words_p, counts_p, n_per, overflow = (
        mesh_mod.count_kmers_sharded_partitioned(mesh8, ds, dl, k)
    )
    assert int(overflow) == 0
    n_per = np.asarray(n_per)
    shard_rows = counts_p.shape[0] // 8
    got_keys, got_counts = [], []
    for d in range(8):
        rows = slice(d * shard_rows, d * shard_rows + int(n_per[d]))
        got_keys.append(kmer_ops.words_to_np_keys(
            [np.asarray(w)[rows] for w in words_p]))
        got_counts.append(np.asarray(counts_p)[rows])
    uw, uc, nu = kmer_ops.count_chunk(jnp.asarray(seqs), jnp.asarray(lengths), k)
    nu = int(nu)
    want_keys = kmer_ops.words_to_np_keys([np.asarray(w)[:nu] for w in uw])
    np.testing.assert_array_equal(np.concatenate(got_keys), want_keys)
    np.testing.assert_array_equal(np.concatenate(got_counts), np.asarray(uc)[:nu])
