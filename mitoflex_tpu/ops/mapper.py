"""Read-to-contig mapping and coverage — on device.

Replaces the reference's ``bwa index/mem | samtools view -q30 | sort`` +
``samtools depth -aa | avgdep_bin`` chains (findmitoscaf.py:439-467 depth
retag, visualize.py:102-113 depth track, bim/bim.py:43-58 bait mapping).

Design: seed-vote placement, not SAM-grade alignment — every consumer in
this pipeline needs read placements and per-base depth, not CIGARs. The
whole path runs as one jitted XLA computation per read batch:

- the contig set is indexed by exact 15-mers (30 bits -> one uint32 word,
  packed by ops/kmer.extract_kmers), sorted once with positions;
- each read contributes sampled 15-mers on both strands; seeds are
  resolved against the index with SORT-BASED joins (a rank join + a
  payload-fetch join, both gather-free — a binary search would be log2(T)
  sequential gather rounds), yielding
  up to ``max_mult`` (contig, diagonal) candidates per seed;
- candidates are sorted per read and the longest run (= most seeds
  agreeing on one diagonal) wins if it reaches ``min_votes`` and strictly
  beats the runner-up (q30-like uniqueness);
- per-base depth is an interval sum via segment_sum over read endpoints.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..io import encoding
from ..io.fasta import FastaRecord
from . import kmer as kmer_ops

K = 15
SEED_STEP = 4
MAX_MULT = 4
INDEX_FLOOR = 1 << 15


def _pad_pow2(n: int, floor: int = 256) -> int:
    c = floor
    while c < n:
        c <<= 1
    return c


@dataclass
class ContigIndex:
    """Sorted 15-mer index of the contig set, device-resident."""

    ids: List[str]
    lengths: np.ndarray      # [n_contigs]
    keys: jax.Array          # [cap] uint32 sorted (pad 0xFFFFFFFF)
    contig_of: jax.Array     # [cap] int32
    pos_of: jax.Array        # [cap] int32
    n_entries: int

    @classmethod
    def build(cls, contigs: Sequence[FastaRecord]) -> "ContigIndex":
        maxlen = max((len(r.seq) for r in contigs), default=K)
        maxlen = max(maxlen, K)
        B = len(contigs)
        batch = np.full((max(B, 1), maxlen), encoding.N, np.int8)
        lens = np.zeros(max(B, 1), np.int32)
        for i, r in enumerate(contigs):
            batch[i, : len(r.seq)] = r.codes
            lens[i] = len(r.seq)
        words, valid = kmer_ops.extract_kmers(jnp.asarray(batch), jnp.asarray(lens), K)
        # 15-mers left-align to bits 2..31 of the word; drop the two zero
        # low bits so keys are TRUE 30-bit values — the sort-join packs
        # (key, tag) into one int32/uint32 and treats negative (bit-31)
        # keys as padding, so unshifted keys starting with G/T would be
        # silently discarded (halving seed sensitivity)
        w = np.asarray(words[0]) >> 2
        v = np.asarray(valid)
        ridx, cidx = np.nonzero(v)
        keys = w[ridx, cidx]
        order = np.argsort(keys, kind="stable")
        keys = keys[order]
        contig = ridx[order].astype(np.int32)
        pos = cidx[order].astype(np.int32)
        # one capacity for every mito-scale index (~32 kb of contigs): the
        # local-extension, remap and visualize indexes then share one
        # compiled join instead of one per contig set
        cap = _pad_pow2(len(keys), floor=INDEX_FLOOR)
        pk = np.full(cap, 0xFFFFFFFF, np.uint32)
        pc = np.zeros(cap, np.int32)
        pp = np.zeros(cap, np.int32)
        pk[: len(keys)] = keys
        pc[: len(keys)] = contig
        pp[: len(keys)] = pos
        return cls(
            [r.id for r in contigs],
            np.asarray([len(r.seq) for r in contigs], np.int64),
            jnp.asarray(pk), jnp.asarray(pc), jnp.asarray(pp), len(keys),
        )


@dataclass
class MappedBatch:
    contig: np.ndarray     # [B] int32, -1 = unmapped
    pos: np.ndarray        # [B] int32 leftmost ref position (0-based, clamped >= 0)
    strand: np.ndarray     # [B] int8 (+1/-1)
    votes: np.ndarray      # [B] int32 supporting seeds
    # unclamped leftmost position: negative when the read overhangs the
    # contig's 5' end (drives the left-end local extension); equals ``pos``
    # otherwise. Required — consumers (stages/assemble._extend_ends)
    # index it unconditionally.
    raw_pos: np.ndarray


def _last_valid_fill(has: jax.Array, *vals: jax.Array):
    """Forward-fill: row i receives the values of the nearest row j <= i
    with has[j] True. Associative "last valid" scan — the gather-free way
    to propagate NON-monotone payloads along a sorted axis (monotone ones
    can use lax.cummax instead)."""

    def combine(a, b):
        bh = b[0]
        out = [jnp.logical_or(bh, a[0])]
        for av, bv in zip(a[1:], b[1:]):
            out.append(jnp.where(bh, bv, av))
        return tuple(out)

    return jax.lax.associative_scan(combine, (has,) + vals)


def _rank_join(table_key: jax.Array, q: jax.Array) -> jax.Array:
    """For each query key, the POSITION of the last table row with an equal
    key (-1 if absent). Gather-free: one sort + two cummaxes + a restore
    sort. Real keys must be non-negative int32 < 2**30 (15-mers are 30
    bits); NEGATIVE table keys are padding (remapped past the query
    sentinel 2**30 with position suppressed, so they can never win a
    fill). Sort operands are PACKED — (key, tag) into one int32 sort key,
    (tag, row) into one restore key — because every extra operand of a
    variadic lax.sort multiplies comparator cost."""
    T = table_key.shape[0]
    Q = q.shape[0]
    tkey = jnp.where(table_key >= 0, table_key, jnp.int32((1 << 30) + 1))
    # packed sort key (uint32 — the query sentinel 2**30 packs to 2**31+1):
    # key*2 + tag; ties put table rows first so the cummax fill sees them
    # before equal-key queries
    key_cat = jnp.concatenate(
        [tkey.astype(jnp.uint32) * 2, q.astype(jnp.uint32) * 2 + 1]
    )
    pos_t = jax.lax.broadcasted_iota(jnp.int32, (T, 1), 0).squeeze(-1)
    pos_t = jnp.where(table_key >= 0, pos_t, -1)  # padding never wins
    payload = jnp.concatenate(
        [pos_t, jax.lax.broadcasted_iota(jnp.int32, (Q, 1), 0).squeeze(-1)]
    )
    s_key, s_pay = jax.lax.sort([key_cat, payload], num_keys=1)
    s_tag = jax.lax.bitwise_and(s_key, jnp.uint32(1)).astype(jnp.int32)
    # sorted by key => table keys are monotone; cummax is a valid fill.
    # NOTE: the key-0 table row (poly-A 15-mer) packs to 0, equal to the
    # cummax seed — its queries still resolve because last_pos carries the
    # row position independently, and a truly-absent key 0 leaves
    # last_pos = -1; do not use last_key alone as a "row seen" test.
    last_pos = jax.lax.cummax(jnp.where(s_tag == 0, s_pay, jnp.int32(-1)))
    last_key = jax.lax.cummax(jnp.where(s_tag == 0, s_key, jnp.uint32(0)))
    p = jnp.where(
        jnp.logical_and(s_tag == 1, last_key == s_key - 1), last_pos, jnp.int32(-1)
    )
    # restore key: tag<<29 | row+1 (rows < 2**28; table pos payloads can
    # be -1, hence the +1)
    rkey = jax.lax.shift_left(s_tag, 29) | (s_pay + 1)
    s2 = jax.lax.sort([rkey, p], num_keys=1)
    return s2[1][T:]


def _fetch_rows(
    table_key: jax.Array, contig_of: jax.Array, pos_of: jax.Array,
    desired: jax.Array, qkey: jax.Array,
):
    """Fetch (key-checked) table payloads at integer positions ``desired``
    (-1 = skip) without gathers: sort the position requests against the
    table's own positions, forward-fill payloads with a last-valid scan,
    sort back. A candidate is valid iff the filled row is exactly the
    desired position AND its key equals the query's key (run boundaries:
    position p-j may hold a smaller key). Sort operands are PACKED —
    (pos, tag) into one sort key, the table key and the query's expected
    key share one column (rows are disjoint by tag), (tag, row) into one
    restore key — to keep the variadic-sort comparator narrow."""
    T = table_key.shape[0]
    Q = desired.shape[0]
    # packed sort key: (pos+1)*2 + tag; desired -1 -> 1, before all table
    # rows (key 2, 4, ...) so its fill check can never pass
    pos_cat = jnp.concatenate(
        [(jax.lax.broadcasted_iota(jnp.int32, (T, 1), 0).squeeze(-1) + 1) * 2,
         (desired + 1) * 2 + 1]
    )
    pay = jnp.concatenate(
        [jnp.full((T,), -1, jnp.int32),
         jax.lax.broadcasted_iota(jnp.int32, (Q, 1), 0).squeeze(-1)]
    )
    # shared key column: the table row's own key / the query's expected key
    key_cat = jnp.concatenate([table_key, qkey])
    z = jnp.zeros((Q,), jnp.int32)
    con_cat = jnp.concatenate([contig_of, z])
    tp_cat = jnp.concatenate([pos_of, z])
    s = jax.lax.sort([pos_cat, pay, key_cat, con_cat, tp_cat], num_keys=1)
    s_pos, s_pay, s_key, s_con, s_tp = s
    s_tag = jax.lax.bitwise_and(s_pos, 1)
    has, f_pos, f_key, f_con, f_tp = _last_valid_fill(
        s_tag == 0, s_pos, s_key, s_con, s_tp
    )
    ok = jnp.logical_and(
        jnp.logical_and(s_tag == 1, has),
        # filled table row sits at exactly the requested position (its
        # packed key is ours minus the tag bit) and carries the right key
        jnp.logical_and(f_pos == s_pos - 1, f_key == s_key),
    )
    out_con = jnp.where(ok, f_con, jnp.int32(-1))
    out_tp = jnp.where(ok, f_tp, jnp.int32(-1))
    rkey = jax.lax.shift_left(s_tag, 29) | (s_pay + 1)
    s2 = jax.lax.sort([rkey, out_con, out_tp], num_keys=1)
    return s2[1][T:], s2[2][T:]


@functools.partial(jax.jit, static_argnames=("min_votes", "step", "max_mult"))
def _map_device(
    keys: jax.Array, contig_of: jax.Array, pos_of: jax.Array,
    seqs: jax.Array, lengths: jax.Array,
    min_votes: int = 2, step: int = SEED_STEP, max_mult: int = MAX_MULT,
):
    """Both strands in one computation. Returns (contig, pos, strand,
    votes) device arrays."""
    B, L = seqs.shape
    rc = kmer_ops.revcomp_codes(seqs, lengths)
    both = jnp.concatenate([seqs, rc], axis=0)              # [2B, L]
    lens2 = jnp.concatenate([lengths, lengths])

    words, valid = kmer_ops.extract_kmers(both, lens2, K)
    # match ContigIndex.build's 30-bit key contract (low 2 bits dropped)
    w = (words[0] >> 2)[:, ::step]                           # [2B, S]
    v = valid[:, ::step]
    S = w.shape[1]
    offs = (jnp.arange(S, dtype=jnp.int32) * step)

    # ---- seed resolution: rank join + payload-fetch join (no gathers) ----
    qkey = jnp.where(v, w.astype(jnp.int32), jnp.int32(1 << 30)).reshape(-1)
    tkey = keys.astype(jnp.int32)  # 30-bit keys; 0xFFFFFFFF padding -> -1,
    # which sorts first as int32 with payload position -1 (harmless)
    p = _rank_join(tkey, qkey)  # [2B*S]
    desired = p[:, None] - jnp.arange(max_mult, dtype=jnp.int32)[None, :]
    desired = jnp.where(p[:, None] >= 0, desired, jnp.int32(-1))
    qkey_m = jnp.broadcast_to(qkey[:, None], desired.shape)
    cand_con, cand_tp = _fetch_rows(
        tkey, contig_of, pos_of, desired.reshape(-1), qkey_m.reshape(-1)
    )
    cand_con = cand_con.reshape(2 * B, S, max_mult)
    cand_tp = cand_tp.reshape(2 * B, S, max_mult)
    miss = cand_con < 0
    MISS = jnp.int32(2 ** 28)
    contig_c = jnp.where(miss, MISS, cand_con).reshape(2 * B, S * max_mult)
    diag_c = jnp.where(
        miss, MISS, cand_tp - offs[None, :, None]
    ).reshape(2 * B, S * max_mult)

    # ---- per-read diagonal voting -------------------------------------
    # lexicographic sort by (contig, diagonal): misses sort to the end
    contig_s, diag_s = jax.lax.sort([contig_c, diag_c], num_keys=2, dimension=1)
    M = contig_s.shape[1]
    pos_i = jax.lax.broadcasted_iota(jnp.int32, (2 * B, M), 1)
    same = jnp.logical_and(
        contig_s[:, 1:] == contig_s[:, :-1], diag_s[:, 1:] == diag_s[:, :-1]
    )
    is_new = jnp.concatenate([jnp.ones((2 * B, 1), bool), jnp.logical_not(same)], axis=1)
    run_start = jnp.where(is_new, pos_i, 0)
    run_start = jax.lax.cummax(run_start, axis=1)
    run_len = pos_i - run_start + 1
    run_len = jnp.where(contig_s < MISS, run_len, 0)
    is_end = jnp.concatenate([jnp.logical_not(same), jnp.ones((2 * B, 1), bool)], axis=1)
    end_len = jnp.where(is_end, run_len, 0)
    best_votes = jnp.max(end_len, axis=1)
    best_idx = jnp.argmax(end_len, axis=1)
    sel = pos_i == best_idx[:, None]
    second_votes = jnp.max(jnp.where(sel, jnp.int32(-1), end_len), axis=1)
    contig = jnp.sum(jnp.where(sel, contig_s, 0), axis=1)
    diag = jnp.sum(jnp.where(sel, diag_s, 0), axis=1)
    ok = jnp.logical_and(best_votes >= min_votes, best_votes > second_votes)
    contig = jnp.where(ok, contig, -1)
    raw = diag          # may be negative: read overhangs the contig 5' end
    diag = jnp.maximum(diag, 0)

    c_f, c_r = contig[:B], contig[B:]
    p_f, p_r = diag[:B], diag[B:]
    r_f, r_r = raw[:B], raw[B:]
    v_f, v_r = best_votes[:B], best_votes[B:]
    use_r = v_r > v_f
    contig = jnp.where(use_r, c_r, c_f)
    pos = jnp.where(use_r, p_r, p_f)
    raw = jnp.where(use_r, r_r, r_f)
    votes = jnp.where(use_r, v_r, v_f)
    strand = jnp.where(use_r, jnp.int8(-1), jnp.int8(1))
    return (contig.astype(jnp.int32), pos.astype(jnp.int32), strand,
            votes.astype(jnp.int32), raw.astype(jnp.int32))


def _host_windows_u32(seqs: np.ndarray, lengths: np.ndarray, k: int):
    """Numpy mirror of extract_kmers for W == 1 (k <= 16): [B, P] uint32
    left-aligned window keys + validity (inside content, N-free)."""
    B, L = seqs.shape
    P = L - k + 1
    cc = np.where(seqs < 4, seqs, 0).astype(np.uint32)
    acc = np.zeros((B, P), np.uint32)
    for t in range(k):
        acc |= cc[:, t : t + P] << np.uint32(
            2 * (kmer_ops.BASES_PER_WORD - 1 - t)
        )
    is_n = (seqs == encoding.N).astype(np.int32)
    cum = np.cumsum(is_n, axis=1)
    hi = cum[:, k - 1 :]
    lo = np.pad(cum[:, : P - 1], ((0, 0), (1, 0)))
    col = np.arange(P, dtype=np.int32)[None, :]
    valid = (col + k <= lengths[:, None]) & (hi - lo == 0)
    return acc, valid


def _map_host(
    index: ContigIndex, seqs: np.ndarray, lengths: np.ndarray,
    min_votes: int, step: int, max_mult: int,
):
    """Numpy mirror of _map_device — bit-identical placements (the
    mesh-parity tests compare this host path against the sharded device
    kernel). On the CPU backend plain searchsorted against the (small,
    cache-resident) index is ~10x faster and was the dominant term of
    the CPU e2e's assemble stage (local-extension mapping sweeps)."""
    B, L = seqs.shape
    # both strands: rc rows left-aligned like revcomp_codes
    comp = np.where(seqs < 4, 3 - seqs, seqs).astype(np.int8)
    rev = comp[:, ::-1]
    col = np.arange(L, dtype=np.int32)[None, :]
    src = np.clip(col + (L - lengths[:, None]), 0, L - 1)
    rc = np.take_along_axis(rev, src, axis=1)
    rc = np.where(col < lengths[:, None], rc, np.int8(encoding.N))
    both = np.concatenate([seqs, rc])
    lens2 = np.concatenate([lengths, lengths])

    w, v = _host_windows_u32(both, lens2, K)
    w = (w >> np.uint32(2))[:, ::step]  # ContigIndex 30-bit key contract
    v = v[:, ::step]
    S = w.shape[1]
    offs = (np.arange(S, dtype=np.int64) * step)

    tk = np.asarray(index.keys)[: index.n_entries]
    con_of = np.asarray(index.contig_of)[: index.n_entries].astype(np.int64)
    pos_of = np.asarray(index.pos_of)[: index.n_entries].astype(np.int64)

    q = w.reshape(-1)
    qv = v.reshape(-1)
    lo = np.searchsorted(tk, q, side="left")
    hi = np.searchsorted(tk, q, side="right")
    # candidates = the LAST max_mult index rows of each key's run (the
    # device fetches positions p, p-1, ... from the rank join's p = hi-1)
    rows = (hi - 1)[:, None] - np.arange(max_mult, dtype=np.int64)[None, :]
    okc = (rows >= lo[:, None]) & qv[:, None] & (hi > lo)[:, None]
    rows_s = np.clip(rows, 0, max(len(tk) - 1, 0))
    MISS = np.int64(2 ** 28)
    if len(tk):
        con = np.where(okc, con_of[rows_s], MISS)
        tp = np.where(okc, pos_of[rows_s], 0)
    else:
        con = np.full(rows.shape, MISS, np.int64)
        tp = np.zeros(rows.shape, np.int64)
    offs_flat = np.tile(offs, 2 * B)
    diag = np.where(okc, tp - offs_flat[:, None], MISS)

    # per-read voting: pack (contig, diag) into one int64 and sort rows
    BIAS = np.int64(1) << np.int64(32)
    key = (con << np.int64(33)) + diag + BIAS
    key = key.reshape(2 * B, S * max_mult)
    key.sort(axis=1)
    M = key.shape[1]
    con_s = key >> np.int64(33)
    diag_s = (key & ((np.int64(1) << np.int64(33)) - 1)) - BIAS
    pos_i = np.broadcast_to(np.arange(M, dtype=np.int64)[None, :], key.shape)
    same = key[:, 1:] == key[:, :-1]
    is_new = np.concatenate([np.ones((2 * B, 1), bool), ~same], axis=1)
    run_start = np.maximum.accumulate(np.where(is_new, pos_i, 0), axis=1)
    run_len = pos_i - run_start + 1
    run_len = np.where(con_s < MISS, run_len, 0)
    is_end = np.concatenate([~same, np.ones((2 * B, 1), bool)], axis=1)
    end_len = np.where(is_end, run_len, 0)
    best_votes = end_len.max(axis=1)
    best_idx = end_len.argmax(axis=1)
    second_votes = np.where(
        pos_i == best_idx[:, None], np.int64(-1), end_len
    ).max(axis=1)
    contig = np.take_along_axis(con_s, best_idx[:, None], axis=1)[:, 0]
    diag_w = np.take_along_axis(diag_s, best_idx[:, None], axis=1)[:, 0]
    ok = (best_votes >= min_votes) & (best_votes > second_votes)
    contig = np.where(ok, contig, -1)
    raw = diag_w
    pos = np.maximum(diag_w, 0)

    c_f, c_r = contig[:B], contig[B:]
    p_f, p_r = pos[:B], pos[B:]
    r_f, r_r = raw[:B], raw[B:]
    v_f, v_r = best_votes[:B], best_votes[B:]
    use_r = v_r > v_f
    return (
        np.where(use_r, c_r, c_f).astype(np.int32),
        np.where(use_r, p_r, p_f).astype(np.int32),
        np.where(use_r, np.int8(-1), np.int8(1)),
        np.where(use_r, v_r, v_f).astype(np.int32),
        np.where(use_r, r_r, r_f).astype(np.int32),
    )


def map_batch(
    index: ContigIndex,
    seqs: np.ndarray,
    lengths: np.ndarray,
    min_votes: int = 2,
    sample_step: int = SEED_STEP,
    max_key_mult: int = MAX_MULT,
    mesh=None,
) -> MappedBatch:
    """``mesh``: shard reads over the data axis with the (mito-scale)
    seed index replicated (parallel.mesh.map_reads_sharded) — per-read
    results are bit-identical to the single-device join."""
    B, L = seqs.shape
    if B == 0 or L < K or index.n_entries == 0:
        return MappedBatch(
            np.full(B, -1, np.int32), np.zeros(B, np.int32),
            np.ones(B, np.int8), np.zeros(B, np.int32),
            np.zeros(B, np.int32),
        )
    # Canonicalize the batch shape before tracing. Read buffers are padded
    # to the reader's capacity (often 256 cols for 100 bp reads) — but the
    # device work (seed count, join sort rows) scales with the column
    # count, so slice to a pow2 bucket of the real max read length. Rows
    # are bucketed up to pow2 with empty reads: distinct callers then
    # share one (cap, B, L) jit signature instead of compiling per batch.
    seqs = np.asarray(seqs)
    lengths = np.asarray(lengths)
    lmax = int(lengths[:B].max(initial=0)) if B else 0
    w = _pad_pow2(max(lmax, K), floor=64)
    if w < L:
        seqs = seqs[:, :w]
    Bp = _pad_pow2(B, floor=256)
    if Bp > B:
        seqs = np.concatenate(
            [seqs, np.zeros((Bp - B, seqs.shape[1]), seqs.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(Bp - B, lengths.dtype)])
    ndev = int(np.prod(mesh.devices.shape)) if mesh is not None else 1
    if ndev > 1 and Bp % ndev == 0:
        from ..parallel import mesh as mesh_mod

        ds, dl = mesh_mod.shard_batch(
            mesh, jnp.asarray(seqs), jnp.asarray(lengths)
        )
        contig, pos, strand, votes, raw = mesh_mod.map_reads_sharded(
            mesh, index.keys, index.contig_of, index.pos_of, ds, dl,
            min_votes, sample_step, max_key_mult,
        )
    else:
        import jax

        try:
            on_cpu = jax.default_backend() == "cpu"
        except Exception:
            on_cpu = False
        if on_cpu:
            contig, pos, strand, votes, raw = _map_host(
                index, seqs, lengths, min_votes, sample_step, max_key_mult
            )
        else:
            contig, pos, strand, votes, raw = _map_device(
                index.keys, index.contig_of, index.pos_of,
                jnp.asarray(seqs), jnp.asarray(lengths),
                min_votes, sample_step, max_key_mult,
            )
    return MappedBatch(
        np.asarray(contig)[:B], np.asarray(pos)[:B], np.asarray(strand)[:B],
        np.asarray(votes)[:B], np.asarray(raw)[:B],
    )


def add_coverage(
    depth: List[np.ndarray], index: ContigIndex, mapped: MappedBatch, lengths: np.ndarray
) -> None:
    """Accumulate per-base depth via difference arrays."""
    sel = np.nonzero(mapped.contig >= 0)[0]
    cis = mapped.contig[sel]
    starts = mapped.pos[sel]
    ends = np.minimum(starts + lengths[sel], index.lengths[cis])
    for ci in np.unique(cis):
        rows = sel[cis == ci]
        d = depth[int(ci)]
        np.add.at(d, mapped.pos[rows], 1)
        e = np.minimum(mapped.pos[rows] + lengths[rows], len(d) - 1)
        np.add.at(d, e, -1)


def finish_coverage(depth: List[np.ndarray]) -> List[np.ndarray]:
    out = []
    for d in depth:
        out.append(np.cumsum(d[:-1]) if len(d) else d)
    return out


def coverage_of_reads(
    contigs: Sequence[FastaRecord],
    batches,
    min_votes: int = 2,
    mesh=None,
) -> Tuple[List[np.ndarray], Dict[str, float], int, int]:
    """Map all read batches; returns (per-contig depth arrays, contig id ->
    mean depth, n_mapped, n_total) — the avgdep equivalent
    (findmitoscaf/avgdep/src/main.rs:57-96)."""
    index = ContigIndex.build(contigs)
    depth = [np.zeros(int(l) + 1, np.int64) for l in index.lengths]
    n_mapped = n_total = 0
    for batch in batches:
        count = batch.count
        mapped = map_batch(index, batch.seqs[:count], batch.lengths[:count],
                           min_votes, mesh=mesh)
        add_coverage(depth, index, mapped, batch.lengths[:count])
        n_mapped += int((mapped.contig >= 0).sum())
        n_total += count
    per_base = finish_coverage(depth)
    means = {
        index.ids[i]: float(per_base[i].mean()) if len(per_base[i]) else 0.0
        for i in range(len(index.ids))
    }
    return per_base, means, n_mapped, n_total
