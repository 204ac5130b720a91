"""Per-kernel device microbenchmarks (honest timing).

Each kernel is wrapped in a device-side fori_loop with a per-iteration
input perturbation and a scalar reduction readback, so the wall clock
covers real executions regardless of async dispatch or result caching
(see bench.py). Run on the target backend:

    python scripts/microbench.py [filter|kmer|viterbi|sw|genewise|mapper|merge|unitig|all]
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")


def _timed_loop(make_run, iters=20):
    """Every invocation gets a fresh seed argument so no result can be
    served from a cache of (executable, inputs)."""
    import numpy as np

    run_1, run_n = make_run(1), make_run(iters)
    seed = [100]

    def call(fn):
        seed[0] += 1
        return int(fn(np.int32(seed[0])))

    call(run_1)  # compile
    call(run_n)
    t0 = time.perf_counter()
    call(run_1)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    call(run_n)
    tn = time.perf_counter() - t0
    return max((tn - t1) / (iters - 1), 1e-9)


def bench_filter():
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.ops import filter as F

    B, L = 65536, 256
    rng = np.random.default_rng(0)
    ds = jnp.asarray(rng.integers(0, 4, (B, L)).astype(np.int8))
    dq = jnp.asarray(rng.integers(35, 74, (B, L)).astype(np.int8))
    dl = jnp.asarray(np.full(B, L, np.int32))
    kern = F.filter_reads_ref

    def make(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                keep, h1, _ = kern(ds ^ ((i + seed) & 3).astype(jnp.int8), dq, dl, 10, 55, 0.2)
                return acc + jnp.sum(keep.astype(jnp.int32)) + h1[0].astype(jnp.int32)

            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        return run

    dt = _timed_loop(make)
    print(f"filter      : {dt*1e3:8.2f} ms/batch  {B*L/dt/1e9:8.2f} Gbase/s")


def bench_kmer(k=31):
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.ops import kmer as K

    B, L = 4096, 256
    rng = np.random.default_rng(0)
    ds = jnp.asarray(rng.integers(0, 4, (B, L)).astype(np.int8))
    dl = jnp.asarray(np.full(B, L, np.int32))
    nk = 2 * B * (L - k - 1 + 1 + 1)

    def make(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                sw_, c_, st_, en_ = K.count_chunk_runs(ds ^ ((i + seed) & 3).astype(jnp.int8), dl, k)
                return acc + c_[0].astype(jnp.int32) + st_[0].astype(jnp.int32)

            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        return run

    dt = _timed_loop(make, iters=10)
    print(f"kmer k={k:3d} : {dt*1e3:8.2f} ms/chunk  {nk/dt/1e6:8.0f} Mkmer/s  {B*L/dt/1e6:8.0f} Mbp/s")


def bench_viterbi():
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.models import hmm as H
    from mitoflex_tpu.ops import phmm as P

    rng = np.random.default_rng(0)
    cons = "".join("ACGT"[i] for i in rng.integers(0, 4, 660))
    prof = P.stage_profile(H.profile_from_consensus("X", cons))
    W, T = 32, 1536
    ds = jnp.asarray(rng.integers(0, 4, (W, T)).astype(np.int8))
    dl = jnp.asarray(np.full(W, T, np.int32))

    def make(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                h = P.viterbi_scan(prof, ds ^ ((i + seed) & 3).astype(jnp.int8), dl, 660)
                return acc + h.seq_to[0] + h.score[0].astype(jnp.int32)

            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        return run

    dt = _timed_loop(make, iters=5)
    cells = W * T * 660
    print(f"viterbi L660: {dt*1e3:8.2f} ms/scan   {cells/dt/1e9:8.2f} Gcell/s  {W*T/dt/1e6:8.2f} Mbp/s")


def bench_sw():
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.models import codon
    from mitoflex_tpu.ops import sw as SW

    rng = np.random.default_rng(0)
    B, Lq, Lt = 64, 256, 1024
    q = jnp.asarray(rng.integers(0, 20, (B, Lq)).astype(np.int8))
    ql = jnp.asarray(np.full(B, Lq, np.int32))
    t = jnp.asarray(rng.integers(0, 20, (B, Lt)).astype(np.int8))
    tl = jnp.asarray(np.full(B, Lt, np.int32))
    sub = jnp.asarray(codon.blosum62())

    def make(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                h = SW.sw_align(q, ql, t ^ ((i + seed) & 3).astype(jnp.int8), tl, sub, 12.0, 1.0)
                return acc + h.q_to[0] + h.score[0].astype(jnp.int32)

            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        return run

    dt = _timed_loop(make, iters=5)
    cells = B * Lq * Lt
    print(f"sw          : {dt*1e3:8.2f} ms/batch  {cells/dt/1e9:8.2f} Gcell/s")


def bench_genewise():
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.models import codon
    from mitoflex_tpu.ops import genewise as GW

    rng = np.random.default_rng(0)
    B, Lq, T = 32, 256, 1024
    q = jnp.asarray(rng.integers(0, 20, (B, Lq)).astype(np.int8))
    ql = jnp.asarray(np.full(B, Lq, np.int32))
    aa = jnp.asarray(rng.integers(0, 20, (B, T)).astype(np.int8))
    tl = jnp.asarray(np.full(B, T, np.int32))
    sub = jnp.asarray(codon.blosum62())

    def make(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                h = GW.genewise_align(q, ql, aa ^ ((i + seed) & 3).astype(jnp.int8), tl, sub)
                return acc + h.q_to[0] + h.score[0].astype(jnp.int32)

            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        return run

    dt = _timed_loop(make, iters=5)
    cells = B * Lq * T
    print(f"genewise    : {dt*1e3:8.2f} ms/batch  {cells/dt/1e9:8.2f} Gcell/s")


def bench_mapper(B=65536, L=100, n_contigs=8, contig_len=18000):
    """Sort-join read mapper: B reads vs a mito-scale contig index."""
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.io.fasta import FastaRecord
    from mitoflex_tpu.ops import mapper as M

    rng = np.random.default_rng(0)
    contigs = [
        FastaRecord(f"c{i}", "".join("ACGT"[b] for b in rng.integers(0, 4, contig_len)))
        for i in range(n_contigs)
    ]
    index = M.ContigIndex.build(contigs)
    # reads sampled from the contigs so the join does real work
    seqs = np.zeros((B, L), np.int8)
    for r in range(B):
        c = contigs[rng.integers(0, n_contigs)].codes
        s = rng.integers(0, len(c) - L)
        seqs[r] = c[s : s + L]
    ds = jnp.asarray(seqs)
    dl = jnp.asarray(np.full(B, L, np.int32))

    def make(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                contig, pos, strand, votes, _raw = M._map_device(
                    index.keys, index.contig_of, index.pos_of,
                    ds ^ ((i + seed) & 3).astype(jnp.int8), dl,
                )
                return acc + jnp.sum(contig >= 0) + pos[0] + votes[0]

            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))

        return run

    dt = _timed_loop(make, iters=8)
    print(
        f"mapper      : {dt*1e3:8.2f} ms/{B//1024}k reads  "
        f"{B/dt/1e6:8.2f} Mreads/s  {B*L/dt/1e9:8.2f} Gbase/s"
    )


def bench_merge(m=1 << 21):
    """LSM merge step: old two-sort merge_runs_device vs the scattered
    lax.sort merge, on two m-row sorted runs (W=2 keys + count payload)."""
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.ops import kmer as K

    def mk_run(seed):
        r = np.random.default_rng(seed)
        w0 = r.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
        w1 = r.integers(0, 2**32, m, dtype=np.uint64).astype(np.uint32)
        order = np.lexsort((w1, w0))
        cnt = r.integers(1, 9, m, dtype=np.uint64).astype(np.uint32)
        return (jnp.asarray(w0[order]), jnp.asarray(w1[order]),
                jnp.asarray(cnt))

    a0, a1, ac = mk_run(1)
    b0, b1, bc = mk_run(2)
    an = jnp.int32(m)

    def make_old(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                p = (i + seed).astype(jnp.uint32)
                w, c, n = K.merge_runs_device(
                    [a0 ^ p, a1], ac, an, [b0, b1], bc, an
                )
                return acc + w[0][0].astype(jnp.int32) + c[0].astype(jnp.int32)
            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))
        return run

    def make_scat_xla(iters):
        @jax.jit
        def run(seed):
            def body(i, acc):
                p = (i + seed).astype(jnp.uint32)
                s = jax.lax.sort(
                    [jnp.concatenate([a0 ^ p, b0]), jnp.concatenate([a1, b1]),
                     jnp.concatenate([ac, bc])], num_keys=2)
                return acc + s[0][0].astype(jnp.int32) + s[2][0].astype(jnp.int32)
            return jax.lax.fori_loop(0, iters, body, jnp.int32(0))
        return run

    variants = [("old 2sort", make_old), ("scat xla", make_scat_xla)]
    for name, mk in variants:
        dt = _timed_loop(mk, iters=8)
        print(f"{name:12s} 2x{m}: {dt*1e3:8.2f} ms  {2*m/dt/1e6:8.1f} Mkeys/s")


def bench_unitig(n_unitigs=10_000_000, chain=3, k=31):
    """Host-side per-unitig layer at scale (round-3 VERDICT weak #2 /
    directive #4): a synthetic graph with `n_unitigs` unitigs of `chain`
    nodes each runs unitig extraction + one cleaning round + strand dedup
    as bulk numpy. Target: single-digit seconds per round at 10M unitigs.

    The GraphPass is synthesized directly (host arrays in the device
    layout) — this measures the formerly-Python layer, not the device
    pass."""
    import types

    from mitoflex_tpu.ops import dbg as dbg_ops
    from mitoflex_tpu.stages import graph_clean

    rng = np.random.default_rng(0)
    U, C = n_unitigs, chain
    n = U * C
    W = (k + 15) // 16
    # chains: nodes [C*u .. C*u+C-1]; internal edges between consecutive
    ids = np.arange(n, dtype=np.int32)
    root = (ids // C) * C
    offset = ids % C
    link = rng.integers(1, 60, n).astype(np.uint32)
    link[offset == 0] = 0
    cyc = np.zeros(n, bool)
    words = np.sort(
        rng.integers(0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32),
        axis=0,
    )
    gp = types.SimpleNamespace(
        n_nodes=n, root=root, offset=offset, link_count=link, is_cycle=cyc,
        node_words=[words[:, w] for w in range(W)],
    )
    t0 = time.perf_counter()
    uset = dbg_ops.unitig_set_from_pass(gp, k)
    t_extract = time.perf_counter() - t0

    # internal edges + 10% extra cross-unitig branch edges
    pre_i = ids[offset < C - 1]
    suf_i = pre_i + 1
    nx = n // 10
    pre_x = rng.integers(0, n, nx).astype(np.int64)
    suf_x = rng.integers(0, n, nx).astype(np.int64)
    pre = np.concatenate([pre_i.astype(np.int64), pre_x])
    suf = np.concatenate([suf_i.astype(np.int64), suf_x])
    ecnt = rng.integers(1, 60, len(pre)).astype(np.uint64)
    out_deg = np.bincount(pre, minlength=n).astype(np.int32)
    in_deg = np.bincount(suf, minlength=n).astype(np.int32)
    params = graph_clean.CleanParams(prune_depth=2.0, prune_level=2,
                                     bubble_level=2, disconnect_ratio=0.1,
                                     low_local_ratio=0.2)
    t0 = time.perf_counter()
    res = graph_clean.analyze_round(uset, in_deg, out_deg, pre, suf, ecnt,
                                    k, params)
    t_round = time.perf_counter() - t0
    t0 = time.perf_counter()
    keep = dbg_ops.dedup_strand_mask(uset, k)
    t_dedup = time.perf_counter() - t0
    print(
        f"unitig {U/1e6:.0f}M : extract {t_extract:6.2f} s   "
        f"clean-round {t_round:6.2f} s   dedup {t_dedup:6.2f} s   "
        f"(bad_nodes {int(res.bad_nodes.sum())}, kept {int(keep.sum())})"
    )


if __name__ == "__main__":
    import jax

    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    print(f"backend: {jax.default_backend()}")
    table = {
        "filter": bench_filter, "kmer": bench_kmer, "viterbi": bench_viterbi,
        "sw": bench_sw, "genewise": bench_genewise,
        "mapper": bench_mapper, "merge": bench_merge, "unitig": bench_unitig,
    }
    for name, fn in table.items():
        if which in (name, "all"):
            fn()
