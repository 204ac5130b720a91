"""K-mer extraction and counting as XLA passes.

Device replacement for megahit_core's ``count`` stage (reference
assemble/assemble_wrapper.py:217-224: solid (k+1)-mer extraction with a
minimum-multiplicity gate). Design:

- k-mers are packed 2 bits/base into W = ceil(2k/32) uint32 words,
  LEFT-aligned (base 0 in the high bits of word 0), so word-wise
  lexicographic order equals base-string lexicographic order and a
  multi-word sort via ``lax.sort(num_keys=W)`` orders k-mers correctly;
- extraction is a fan of shifted ORs over the [reads, len] code matrix —
  elementwise work, one pass over device memory;
- the hot counting path (count_chunk_runs/count_chunk_device) is
  CANONICAL (min of a window's two orientations — half the volume), folds
  validity into all-ones sentinel keys, counts runs with cumsum/cummax
  (no segment_sum scatter), and compacts with a stable flag-keyed sort
  (no gathers);
- cross-chunk merging is a device-resident LSM (merge_runs_device) with
  host spill (stages/assemble.KmerCounter); the exact both-strand path
  (sort_count_unique/count_chunk) remains for graph-node tables and
  weighted contig re-injection;
- cross-device histogram merge rides all_gather / all_to_all
  (parallel/mesh.py).
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

N_CODE = 4
BASES_PER_WORD = 16


def num_words(k: int) -> int:
    return -(-k // BASES_PER_WORD)


def revcomp_codes(seqs: jax.Array, lengths: jax.Array) -> jax.Array:
    """Reverse-complement each row of a padded [B, L] code matrix, keeping
    sequences left-aligned (pad stays on the right)."""
    B, L = seqs.shape
    comp = jnp.where(seqs < 4, 3 - seqs, seqs)
    rev = comp[:, ::-1]
    # roll each row left by (L - len) so the sequence is left-aligned again
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    src = col + (L - lengths[:, None])
    src = jnp.clip(src, 0, L - 1)
    out = jnp.take_along_axis(rev, src, axis=1)
    return jnp.where(col < lengths[:, None], out, jnp.int8(N_CODE)).astype(jnp.int8)


def revcomp_codes_padfront(seqs: jax.Array) -> jax.Array:
    """Cheap reverse-complement: plain reversal, pad moves to the FRONT.
    Safe for k-mer extraction because pad is the N code and N-containing
    windows are masked out anyway (no per-row realignment gather)."""
    comp = jnp.where(seqs < 4, 3 - seqs, seqs)
    return comp[:, ::-1].astype(jnp.int8)


def extract_kmers(
    seqs: jax.Array, lengths: jax.Array, k: int, right_aligned: bool = False
) -> Tuple[List[jax.Array], jax.Array]:
    """Extract all k-mers of each row.

    Returns (words, valid): ``words`` is a list of W arrays, each [B, P]
    uint32 (P = L - k + 1); ``valid`` is [B, P] bool (inside the row's
    content region and N-free). ``right_aligned`` marks rows whose content
    sits at the END of the row (e.g. pad-front reverse complements)."""
    B, L = seqs.shape
    P = L - k + 1
    assert P > 0, f"max_read_len {L} shorter than k {k}"
    W = num_words(k)
    s32 = seqs.astype(jnp.uint32)
    words: List[jax.Array] = []
    for w in range(W):
        acc = jnp.zeros((B, P), jnp.uint32)
        nb = min(BASES_PER_WORD, k - w * BASES_PER_WORD)
        for t in range(nb):
            col = w * BASES_PER_WORD + t
            acc = acc | (jnp.where(s32[:, col : col + P] < 4, s32[:, col : col + P], 0)
                         << (2 * (BASES_PER_WORD - 1 - t)))
        words.append(acc)
    # validity: window inside the content region and contains no N
    col = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    if right_aligned:
        fits = col >= (L - lengths)[:, None]
    else:
        fits = col + k <= lengths[:, None]
    is_n = (seqs == N_CODE).astype(jnp.int32)
    cum = jnp.cumsum(is_n, axis=1)
    # #N in [j, j+k) = cum[j+k-1] - cum[j-1]
    hi = cum[:, k - 1 :]
    lo = jnp.pad(cum[:, : P - 1], ((0, 0), (1, 0)))
    n_in_window = hi - lo
    valid = jnp.logical_and(fits, n_in_window == 0)
    return words, valid


def sort_count_unique(
    words: List[jax.Array], valid: jax.Array, weights: jax.Array | None = None
) -> Tuple[List[jax.Array], jax.Array, jax.Array]:
    """Sort flattened k-mers and produce unique keys with counts.

    Inputs may be any shape; they are flattened to N entries. Returns
    (unique_words [N] x W, counts [N] uint32, n_unique scalar): the first
    ``n_unique`` rows are the sorted unique k-mers with their counts,
    the rest is padding (all-ones keys, zero counts).

    ``weights`` (optional, same shape as valid, uint32) weights each
    occurrence — used when re-injecting contigs with known depth into the
    next k iteration (megahit `iterate` analog).
    """
    flat = [w.reshape(-1) for w in words]
    v = valid.reshape(-1)
    n = v.shape[0]
    wt = (weights.reshape(-1).astype(jnp.uint32) if weights is not None
          else jnp.ones((n,), jnp.uint32))
    wt = jnp.where(v, wt, 0)
    invalid_key = jnp.where(v, jnp.uint32(0), jnp.uint32(1))
    operands = [invalid_key] + flat + [wt]
    sorted_ops = jax.lax.sort(operands, num_keys=1 + len(flat))
    s_invalid, s_words, s_wt = sorted_ops[0], sorted_ops[1:-1], sorted_ops[-1]
    s_valid = s_invalid == 0
    # boundary detection among valid rows
    diff = jnp.zeros((n,), jnp.bool_)
    for w in s_words:
        diff = jnp.logical_or(diff, jnp.concatenate([jnp.ones((1,), jnp.bool_), w[1:] != w[:-1]]))
    is_new = jnp.logical_and(diff, s_valid)
    seg = jnp.cumsum(is_new.astype(jnp.int32)) - 1
    seg = jnp.where(s_valid, seg, n - 1)  # dump invalid into the last segment
    counts = jax.ops.segment_sum(s_wt, seg, num_segments=n)
    n_unique = jnp.sum(is_new.astype(jnp.int32))
    # compact unique rows to the front (stable sort on ~is_new)
    order = jnp.argsort(jnp.logical_not(is_new), stable=True)
    uniq_words = [jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1) < n_unique,
        w[order], jnp.uint32(0xFFFFFFFF)) for w in s_words]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    counts = jnp.where(idx < n_unique, counts[idx], 0).astype(jnp.uint32)
    return uniq_words, counts, n_unique


@functools.partial(jax.jit, static_argnames=("k",))
def count_chunk(
    seqs: jax.Array, lengths: jax.Array, k: int, weights: jax.Array | None = None
) -> Tuple[List[jax.Array], jax.Array, jax.Array]:
    """Count k-mers of a read chunk on both strands.

    Returns (unique_words, counts, n_unique) as in sort_count_unique, with
    capacity 2 * B * (L - k + 1).
    """
    rc = revcomp_codes_padfront(seqs)
    w_f, v_f = extract_kmers(seqs, lengths, k)
    w_r, v_r = extract_kmers(rc, lengths, k, right_aligned=True)
    words = [jnp.concatenate([a, b]) for a, b in zip(w_f, w_r)]
    valid = jnp.concatenate([v_f, v_r])
    wts = jnp.concatenate([weights, weights]) if weights is not None else None
    return sort_count_unique(words, valid, wts)


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def count_chunk_runs(
    seqs: jax.Array, lengths: jax.Array, k: int, canonical: bool = False
):
    """Fast-path UNWEIGHTED counting without on-device compaction or extra
    sort operands.

    With ``canonical=False`` both strands' k-mers enter the sort (2 rows
    per window); with ``canonical=True`` each window contributes
    min(kmer, revcomp(kmer)) — HALF the sort and transfer volume. The
    canonical count equals the per-orientation count of the old scheme
    except for palindromic k-mers (see expand_canonical).

    Validity is folded into the keys (invalid windows become the all-ones
    sentinel, which sorts last; a real all-T k-mer shares the key but the
    first rows of that block are attributed to it — equal keys are
    interchangeable). Counts are run lengths; run ends are each run's last
    valid row. Device work = extraction + ONE W-operand lexicographic sort
    + elementwise passes (no segment_sum scatter, no argsort gathers); the
    host finishes with two boolean masks (count_chunk_host).

    Returns (sorted_words [N] x W, run_counts [N], is_start [N],
    is_end [N]); the i-th True of is_start and of is_end bracket the same
    run, so keys[is_start] pairs elementwise with counts[is_end].
    """
    rc = revcomp_codes_padfront(seqs)
    w_f, v_f = extract_kmers(seqs, lengths, k)
    w_r, v_r = extract_kmers(rc, lengths, k, right_aligned=True)
    if canonical:
        # rc kmer of fwd window j sits at rc-column P-1-j: flip columns
        w_rf = [w[:, ::-1] for w in w_r]
        # elementwise lexicographic min over the word lists
        take_f = jnp.zeros(v_f.shape, jnp.bool_)
        eq = jnp.ones(v_f.shape, jnp.bool_)
        for a, b in zip(w_f, w_rf):
            take_f = jnp.logical_or(take_f, jnp.logical_and(eq, a < b))
            eq = jnp.logical_and(eq, a == b)
        take_f = jnp.logical_or(take_f, eq)
        words = [
            jnp.where(v_f, jnp.where(take_f, a, b), jnp.uint32(0xFFFFFFFF)).reshape(-1)
            for a, b in zip(w_f, w_rf)
        ]
        valid = v_f.reshape(-1)
    else:
        valid2 = [v_f, v_r]
        words = [
            jnp.concatenate([
                jnp.where(v, w, jnp.uint32(0xFFFFFFFF)) for w, v in zip(pair, valid2)
            ]).reshape(-1)
            for pair in zip(w_f, w_r)
        ]
        valid = jnp.concatenate(valid2).reshape(-1)
    n = valid.shape[0]
    s_words = list(jax.lax.sort(words, num_keys=len(words)))

    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    all_ones = jnp.ones((n,), jnp.bool_)
    for w in s_words:
        all_ones = jnp.logical_and(all_ones, w == jnp.uint32(0xFFFFFFFF))
    n_invalid = jnp.sum(jnp.logical_not(valid).astype(jnp.int32))
    s_valid = jnp.logical_or(jnp.logical_not(all_ones), pos < n - n_invalid)

    diff = jnp.zeros((n,), jnp.bool_)
    for w in s_words:
        diff = jnp.logical_or(
            diff, jnp.concatenate([jnp.ones((1,), jnp.bool_), w[1:] != w[:-1]])
        )
    is_start = jnp.logical_and(diff, s_valid)
    next_diff = jnp.concatenate([diff[1:], jnp.ones((1,), jnp.bool_)])
    next_invalid = jnp.concatenate(
        [jnp.logical_not(s_valid[1:]), jnp.ones((1,), jnp.bool_)]
    )
    is_end = jnp.logical_and(s_valid, jnp.logical_or(next_diff, next_invalid))

    run_start = jax.lax.cummax(jnp.where(diff, pos, 0))
    counts = (pos - run_start + 1).astype(jnp.uint32)
    return s_words, counts, is_start, is_end


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def count_chunk_device(
    seqs: jax.Array, lengths: jax.Array, k: int, canonical: bool = True
):
    """Chunk counting producing a COMPACTED device run (sorted unique
    words + counts + n_unique). Compaction uses the stable-sort trick
    (no gathers). SUPERSEDED on the production path by
    count_chunk_scattered (which skips the compaction sort entirely);
    kept for consumers that need the compacted contract directly."""
    s_words, counts, is_start, is_end = count_chunk_runs(seqs, lengths, k, canonical)
    W = len(s_words)
    n = counts.shape[0]
    flag = jnp.where(is_end, jnp.int32(0), jnp.int32(1))
    compacted = jax.lax.sort(
        [flag] + list(s_words) + [counts.astype(jnp.int32)],
        num_keys=1, is_stable=True,
    )
    out_words, out_counts = compacted[1 : 1 + W], compacted[1 + W]
    n_unique = jnp.sum(is_end.astype(jnp.int32))
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    out_words = [
        jnp.where(pos < n_unique, w, jnp.uint32(0xFFFFFFFF)) for w in out_words
    ]
    out_counts = jnp.where(pos < n_unique, out_counts, 0).astype(jnp.uint32)
    return out_words, out_counts, n_unique


@jax.jit
def merge_runs_device(
    a_words: List[jax.Array], a_counts: jax.Array, a_n: jax.Array,
    b_words: List[jax.Array], b_counts: jax.Array, b_n: jax.Array,
):
    """Merge two sorted-unique device runs into one, summing counts of
    equal keys. Fully gather-free: concat -> stable W-key sort (counts as
    payload) -> run-combine via cumsum difference -> compaction via a
    SECOND stable sort keyed on not-is-unique (payload permutation inside
    lax.sort, no gathers).

    Runs are (words [cap] x W uint32 sorted with 0xFFFFFFFF padding,
    counts [cap] uint32, n valid). Output capacity = capA + capB.
    SUPERSEDED on the production path by merge_scattered (one pure
    sorted merge with a single re-sum at extraction); kept as the
    compacted-contract reference and for its tests."""
    W = len(a_words)
    words = [jnp.concatenate([a, b]) for a, b in zip(a_words, b_words)]
    n = words[0].shape[0]
    idx_a = jax.lax.broadcasted_iota(jnp.int32, (a_counts.shape[0], 1), 0).squeeze(-1)
    idx_b = jax.lax.broadcasted_iota(jnp.int32, (b_counts.shape[0], 1), 0).squeeze(-1)
    valid = jnp.concatenate([idx_a < a_n, idx_b < b_n])
    counts = jnp.concatenate([a_counts, b_counts])
    counts = jnp.where(valid, counts, 0)
    # ensure padding sorts last even if caller padding was not all-ones
    words = [jnp.where(valid, w, jnp.uint32(0xFFFFFFFF)) for w in words]
    # validity tiebreaker key: within the all-ones block, real all-T rows
    # must precede padding or a run could be split and double-emitted
    inv = jnp.where(valid, jnp.uint32(0), jnp.uint32(1))

    sorted_ops = jax.lax.sort(words + [inv, counts.astype(jnp.int32)], num_keys=W + 1)
    s_words, s_cnt = sorted_ops[:W], sorted_ops[W + 1]

    diff = jnp.zeros((n,), jnp.bool_)
    for w in s_words:
        diff = jnp.logical_or(
            diff, jnp.concatenate([jnp.ones((1,), jnp.bool_), w[1:] != w[:-1]])
        )
    # number of valid rows: padding has count 0 and all-ones keys; a real
    # all-T key also has all-ones words but nonzero count
    s_valid = s_cnt > 0
    # run-summed counts at each run's last valid row (cumsum difference)
    cs = jnp.cumsum(s_cnt)
    cs_prev = jnp.concatenate([jnp.zeros((1,), cs.dtype), cs[:-1]])
    prev_cs = jax.lax.cummax(jnp.where(diff, cs_prev, 0))
    run_counts = cs - prev_cs
    next_diff = jnp.concatenate([diff[1:], jnp.ones((1,), jnp.bool_)])
    next_invalid = jnp.concatenate(
        [jnp.logical_not(s_valid[1:]), jnp.ones((1,), jnp.bool_)]
    )
    is_end = jnp.logical_and(s_valid, jnp.logical_or(next_diff, next_invalid))
    # compaction: stable sort on NOT-is_end brings one row per unique key
    # (carrying the summed count) to the front, preserving key order
    flag = jnp.where(is_end, jnp.int32(0), jnp.int32(1))
    compacted = jax.lax.sort(
        [flag] + list(s_words) + [run_counts.astype(jnp.int32)],
        num_keys=1, is_stable=True,
    )
    out_words, out_counts = compacted[1 : 1 + W], compacted[1 + W]
    n_unique = jnp.sum(is_end.astype(jnp.int32))
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    out_words = [
        jnp.where(pos < n_unique, w, jnp.uint32(0xFFFFFFFF)) for w in out_words
    ]
    out_counts = jnp.where(pos < n_unique, out_counts, 0).astype(jnp.uint32)
    return out_words, out_counts, n_unique


# ----------------------------------------------------- scattered-run LSM path
# A SCATTERED run is (words [cap] x W uint32 sorted ascending with all-ones
# padding, counts [cap] uint32) with the single invariant "sum of counts over
# the rows of a key == that key's total occurrence count" — totals need NOT
# sit at any particular row of an equal-key run. This weaker contract makes
# LSM merging a PURE sorted merge of (keys, counts-as-payload): no validity
# tiebreaker key, no per-merge run re-sum, and no stable compaction sort
# (the two extra passes merge_runs_device pays). Padding is all-ones keys
# with zero counts, indistinguishable from (and safely summable with) a real
# all-T key. One re-sum happens at host extraction where uint64 is free
# (a device-side cumsum would wrap uint32 at ~4G total occurrences).


@functools.partial(jax.jit, static_argnames=("k", "canonical"))
def count_chunk_scattered(
    seqs: jax.Array, lengths: jax.Array, k: int, canonical: bool = True
):
    """Chunk counting producing a SCATTERED device run — the single-sort
    unit the scattered LSM merges (vs count_chunk_device's sort + stable
    compaction sort). Capacity is padded to a power of two (>= 128), which
    bounds the number of distinct merge shapes the LSM compiles."""
    s_words, counts, _is_start, is_end = count_chunk_runs(seqs, lengths, k, canonical)
    sc = jnp.where(is_end, counts, jnp.uint32(0))
    n0 = sc.shape[0]
    n = max(128, 1 << max(n0 - 1, 1).bit_length())
    if n > n0:
        pad = n - n0
        s_words = [
            jnp.concatenate([w, jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)])
            for w in s_words
        ]
        sc = jnp.concatenate([sc, jnp.zeros((pad,), jnp.uint32)])
    return s_words, sc


@jax.jit
def merge_scattered(
    a_words: List[jax.Array], a_counts: jax.Array,
    b_words: List[jax.Array], b_counts: jax.Array,
):
    """Merge two scattered runs: ONE sorted merge with counts as payload.
    Unequal capacities are padded to the larger (all-ones keys, zero
    counts — appending to a sorted run keeps it sorted). The merge is one
    W-key lax.sort of the concatenation."""
    W = len(a_words)
    na, nb = a_counts.shape[0], b_counts.shape[0]
    if na != nb:
        m = max(na, nb)

        def _pad(ws, cs, n):
            p = m - n
            ws = [jnp.concatenate([w, jnp.full((p,), 0xFFFFFFFF, jnp.uint32)])
                  for w in ws]
            return ws, jnp.concatenate([cs, jnp.zeros((p,), jnp.uint32)])

        if na < m:
            a_words, a_counts = _pad(a_words, a_counts, na)
        else:
            b_words, b_counts = _pad(b_words, b_counts, nb)
    ops = [jnp.concatenate([x, y]) for x, y in zip(a_words, b_words)]
    ops.append(jnp.concatenate([a_counts, b_counts]))
    s = jax.lax.sort(ops, num_keys=W)
    return list(s[:W]), s[W]


@jax.jit
def scattered_to_unique(words, counts):
    """Compact a SCATTERED run to the (unique words, counts, n_unique)
    device contract: run totals by cumsum difference + ONE stable
    compaction sort. Requires total occurrences < 2^31 (the int32 cumsum
    must not wrap) — fine for per-batch tables like the sharded
    all_to_all merge; the host LSM uses pull_scattered (uint64) instead.
    Zero-total keys (padding, and the all-ones run when no real all-T
    key exists) are dropped; output padding is all-ones/0."""
    W = len(words)
    n = counts.shape[0]
    diff = jnp.zeros((n,), jnp.bool_)
    for w in words:
        diff = jnp.logical_or(
            diff, jnp.concatenate([jnp.ones((1,), jnp.bool_), w[1:] != w[:-1]])
        )
    cs = jnp.cumsum(counts.astype(jnp.int32))
    cs_prev = jnp.concatenate([jnp.zeros((1,), cs.dtype), cs[:-1]])
    prev_cs = jax.lax.cummax(jnp.where(diff, cs_prev, 0))
    totals = cs - prev_cs
    is_end = jnp.concatenate([diff[1:], jnp.ones((1,), jnp.bool_)])
    keep = jnp.logical_and(is_end, totals > 0)
    flag = jnp.where(keep, jnp.int32(0), jnp.int32(1))
    comp = jax.lax.sort(
        [flag] + list(words) + [totals], num_keys=1, is_stable=True
    )
    n_unique = jnp.sum(keep.astype(jnp.int32))
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    out_words = [
        jnp.where(pos < n_unique, w, jnp.uint32(0xFFFFFFFF))
        for w in comp[1 : 1 + W]
    ]
    out_counts = jnp.where(pos < n_unique, comp[1 + W], 0).astype(jnp.uint32)
    return out_words, out_counts, n_unique


def pull_scattered(words, counts) -> Tuple[np.ndarray, np.ndarray]:
    """Host extraction of a scattered run: ONE re-sum per key (uint64, so
    totals past 2^32 occurrences are exact), dropping zero-total keys
    (padding). Returns (keys [U, W] uint32 sorted, counts [U] uint64)."""
    keys = np.stack([np.asarray(w) for w in words], axis=1)
    cnt = np.asarray(counts).astype(np.uint64)
    n = len(cnt)
    if n == 0:
        return keys.reshape(0, keys.shape[1] if keys.ndim == 2 else 1), cnt
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = (keys[1:] != keys[:-1]).any(axis=1)
    starts = np.flatnonzero(new)
    totals = np.add.reduceat(cnt, starts)
    keep = totals > 0
    return keys[starts][keep], totals[keep]


# ---------------------------------------------------------------- host merge
def count_chunk_host(
    seqs, lengths, k: int, weights=None, canonical: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-facing counting: the unweighted hot path uses the run-length
    device pass + boolean-mask compaction here; the weighted path (contig
    re-injection, small volume) uses the exact compacted path. Returns
    (keys [U, W] uint32 sorted, counts [U])."""
    import jax.numpy as jnp

    if weights is not None:
        B, L = seqs.shape
        w = jnp.broadcast_to(
            jnp.asarray(weights, jnp.uint32).reshape(-1, 1), (B, L - k + 1)
        )
        uw, uc, nu = count_chunk(jnp.asarray(seqs), jnp.asarray(lengths), k, w)
        nu = int(nu)
        keys = words_to_np_keys([np.asarray(x)[:nu] for x in uw])
        return keys, np.asarray(uc)[:nu].astype(np.uint64)
    s_words, counts, is_start, is_end = count_chunk_runs(
        jnp.asarray(seqs), jnp.asarray(lengths), k, canonical
    )
    st = np.asarray(is_start)
    en = np.asarray(is_end)
    keys = np.stack([np.asarray(w)[st] for w in s_words], axis=1)
    cnt = np.asarray(counts)[en].astype(np.uint64)
    return keys, cnt


def count_chunk_numpy(
    seqs, lengths, k: int, canonical: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy chunk counting for k <= 32 (W <= 2): rolling 2-bit pack
    into uint64 (one columnwise pass per window position — O(B) work per
    step, no [B, n, k] blowup), validity via a bad-base cumsum window,
    value sort + run-length count. Same output contract as
    count_chunk_host (sorted left-aligned keys, uint64 counts).

    This is the host backend's hot path: XLA:CPU's variadic lax.sort runs
    ~4x slower than np.sort on packed values (and this sandbox's DRAM is
    heavily throttled, so pass count is what matters)."""
    seqs = np.asarray(seqs)
    lengths = np.asarray(lengths)
    B, L = seqs.shape
    n = L - k + 1
    W = num_words(k)
    assert W <= 2, "count_chunk_numpy requires k <= 32"
    empty = (np.zeros((0, W), np.uint32), np.zeros(0, np.uint64))
    if B == 0 or n <= 0:
        return empty
    bad = seqs >= 4
    cc = np.where(bad, 0, seqs).astype(np.uint64)
    badc = np.cumsum(bad, axis=1, dtype=np.int32)
    nb = badc[:, k - 1 :].copy()
    nb[:, 1:] -= badc[:, : n - 1]
    valid = (nb == 0) & ((np.arange(n)[None, :] + k) <= lengths[:, None])
    if not valid.any():
        return empty
    v = np.empty((B, n), np.uint64)
    acc = np.zeros(B, np.uint64)
    for i in range(k):
        acc = (acc << np.uint64(2)) | cc[:, i]
    v[:, 0] = acc
    mask = np.uint64((1 << (2 * k)) - 1) if k < 32 else np.uint64(0xFFFFFFFFFFFFFFFF)
    for j in range(1, n):
        acc = ((acc << np.uint64(2)) | cc[:, j + k - 1]) & mask
        v[:, j] = acc
    # reverse-complement windows (rolling from the high end)
    r = np.empty((B, n), np.uint64)
    racc = np.zeros(B, np.uint64)
    for i in range(k - 1, -1, -1):
        racc = (racc << np.uint64(2)) | (np.uint64(3) - cc[:, i])
    r[:, 0] = racc
    top = np.uint64(2 * (k - 1))
    for j in range(1, n):
        racc = (racc >> np.uint64(2)) | (
            (np.uint64(3) - cc[:, j + k - 1]) << top
        )
        r[:, j] = racc
    if canonical:
        # min of the two orientations, one entry per window
        np.minimum(v, r, out=v)
        vals = v[valid]
    else:
        # both-strand contract (matches count_chunk_runs canonical=False):
        # every window contributes its forward AND its RC k-mer
        vals = np.concatenate([v[valid], r[valid]])
    if k < 32:
        vals <<= np.uint64(2 * (32 - k))  # left-align like the device keys
    vals.sort()
    new = np.empty(len(vals), bool)
    new[0] = True
    np.not_equal(vals[1:], vals[:-1], out=new[1:])
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(vals))).astype(np.uint64)
    u = vals[starts]
    keys = np.empty((len(u), W), np.uint32)
    keys[:, 0] = (u >> np.uint64(32)).astype(np.uint32)
    if W == 2:
        keys[:, 1] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return keys, counts


def count_chunk_numpy2(
    seqs, lengths, k: int, canonical: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Pure-numpy chunk counting for 32 < k <= 64: the two-u64 mirror of
    :func:`count_chunk_numpy`. Windows pack right-aligned into (hi, lo)
    uint64 pairs via the same rolling update; ordering is one
    native-dtype ``np.lexsort((lo, hi))``.

    MEASURED DEAD END as a default (kept as the parity-tested host
    fallback): at the golden production shape (8192x160 reads, k=56,
    canonical) this runs 1.10 s/chunk vs 0.78 s for the warm XLA
    count_chunk_runs path on the same host — the 2n-step rolling loops
    plus lexsort's two argsort passes cost more than XLA's fused
    variadic sort, unlike the W <= 2 case where np.sort on one u64 wins
    4x. The XLA path stays the 32 < k production default.

    Output contract matches count_chunk_host: sorted LEFT-ALIGNED keys
    [U, W] uint32 (W = num_words(k)), uint64 counts."""
    seqs = np.asarray(seqs)
    lengths = np.asarray(lengths)
    B, L = seqs.shape
    n = L - k + 1
    W = num_words(k)
    assert 32 < k <= 64, "count_chunk_numpy2 requires 32 < k <= 64"
    empty = (np.zeros((0, W), np.uint32), np.zeros(0, np.uint64))
    if B == 0 or n <= 0:
        return empty
    bad = seqs >= 4
    cc = np.where(bad, 0, seqs).astype(np.uint64)
    badc = np.cumsum(bad, axis=1, dtype=np.int32)
    nb = badc[:, k - 1 :].copy()
    nb[:, 1:] -= badc[:, : n - 1]
    valid = (nb == 0) & ((np.arange(n)[None, :] + k) <= lengths[:, None])
    if not valid.any():
        return empty
    u2, u62 = np.uint64(2), np.uint64(62)
    himask = (np.uint64((1 << (2 * k - 64)) - 1) if k < 64
              else np.uint64(0xFFFFFFFFFFFFFFFF))
    # forward windows, rolling in at the low end
    vhi = np.empty((B, n), np.uint64)
    vlo = np.empty((B, n), np.uint64)
    ahi = np.zeros(B, np.uint64)
    alo = np.zeros(B, np.uint64)
    for i in range(k):
        ahi = ((ahi << u2) | (alo >> u62)) & himask
        alo = (alo << u2) | cc[:, i]
    vhi[:, 0], vlo[:, 0] = ahi, alo
    for j in range(1, n):
        ahi = ((ahi << u2) | (alo >> u62)) & himask
        alo = (alo << u2) | cc[:, j + k - 1]
        vhi[:, j], vlo[:, j] = ahi, alo
    # reverse-complement windows, rolling from the high end
    rhi = np.empty((B, n), np.uint64)
    rlo = np.empty((B, n), np.uint64)
    bhi = np.zeros(B, np.uint64)
    blo = np.zeros(B, np.uint64)
    top = np.uint64(2 * k - 2 - 64)  # top element's bit within hi (k > 32)
    u3 = np.uint64(3)
    # ascending insert-at-top: comp(base 0) sinks to bit 0,
    # comp(base k-1) ends at the top — the RC read order
    for i in range(k):
        blo = (blo >> u2) | (bhi << u62)
        bhi = (bhi >> u2) | ((u3 - cc[:, i]) << top)
    rhi[:, 0], rlo[:, 0] = bhi, blo
    for j in range(1, n):
        blo = (blo >> u2) | (bhi << u62)
        bhi = (bhi >> u2) | ((u3 - cc[:, j + k - 1]) << top)
        rhi[:, j], rlo[:, j] = bhi, blo
    if canonical:
        rless = (rhi < vhi) | ((rhi == vhi) & (rlo < vlo))
        np.copyto(vhi, rhi, where=rless)
        np.copyto(vlo, rlo, where=rless)
        his, los = vhi[valid], vlo[valid]
    else:
        his = np.concatenate([vhi[valid], rhi[valid]])
        los = np.concatenate([vlo[valid], rlo[valid]])
    order = np.lexsort((los, his))
    his, los = his[order], los[order]
    new = np.empty(len(his), bool)
    new[0] = True
    np.not_equal(his[1:], his[:-1], out=new[1:])
    new[1:] |= los[1:] != los[:-1]
    starts = np.flatnonzero(new)
    counts = np.diff(np.append(starts, len(his))).astype(np.uint64)
    uh, ul = his[starts], los[starts]
    # left-align the 2k bits across the 128-bit pair, then split to words
    s = np.uint64(128 - 2 * k)
    if int(s) == 0:
        hi_al, lo_al = uh, ul
    else:
        hi_al = (uh << s) | (ul >> (np.uint64(64) - s))
        lo_al = ul << s
    keys = np.zeros((len(uh), W), np.uint32)
    keys[:, 0] = (hi_al >> np.uint64(32)).astype(np.uint32)
    keys[:, 1] = (hi_al & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    keys[:, 2] = (lo_al >> np.uint64(32)).astype(np.uint32)
    if W == 4:
        keys[:, 3] = (lo_al & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return keys, counts


def np_revcomp_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed left-aligned k-mer keys [N, W] (host)."""
    N, W = keys.shape
    x = keys ^ np.uint32(0xFFFFFFFF)          # complement every base
    # reverse 2-bit groups within each word
    m2, m4, m8 = np.uint32(0x33333333), np.uint32(0x0F0F0F0F), np.uint32(0x00FF00FF)
    x = ((x & m2) << np.uint32(2)) | ((x >> np.uint32(2)) & m2)
    x = ((x & m4) << np.uint32(4)) | ((x >> np.uint32(4)) & m4)
    x = ((x & m8) << np.uint32(8)) | ((x >> np.uint32(8)) & m8)
    x = (x << np.uint32(16)) | (x >> np.uint32(16))
    x = x[:, ::-1]                            # reverse word order
    # re-left-align: shift the whole multiword left by (16W - k) bases
    s = 2 * (BASES_PER_WORD * W - k)
    ws, bs = divmod(s, 32)
    out = np.zeros_like(x)
    for i in range(W):
        src = i + ws
        if src < W:
            out[:, i] = x[:, src] << np.uint32(bs) if bs else x[:, src]
            if bs and src + 1 < W:
                out[:, i] |= x[:, src + 1] >> np.uint32(32 - bs)
    # zero pad bits beyond base k in the last word
    used = 2 * (k - BASES_PER_WORD * (W - 1))
    if used < 32:
        out[:, W - 1] &= np.uint32(0xFFFFFFFF) << np.uint32(32 - used)
    return out


def expand_canonical(
    keys: np.ndarray, counts: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a canonical (key, count) table to both orientations, SORTED.

    Palindromic k-mers (key == revcomp(key), possible for even k) get a
    single row with DOUBLED count, matching the both-strand scheme where
    each palindromic window contributed two identical entries."""
    if len(keys) == 0:
        return keys, counts
    rc = np_revcomp_keys(keys, k)
    palin = (keys == rc).all(axis=1)
    fwd_counts = np.where(palin, counts * 2, counts)
    if keys.shape[1] <= 2:
        # one native-dtype radix argsort of the doubled packed table.
    # (A sort-the-RC-half-then-native-merge variant was built and
    # measured 2x SLOWER at 50M keys: numpy's u64 radix sort runs
    # ~150M rows/s on this host while the native per-row merge scan
    # pays ~270 ns/row — any O(n) pointer walk loses to sort here.)
        p = np.concatenate([np_pack64(keys), np_pack64(rc[~palin])])
        out_counts = np.concatenate([fwd_counts, counts[~palin]])
        order = np.argsort(p, kind="stable")
        return np_unpack64(p[order], keys.shape[1]), out_counts[order]
    out_keys = np.concatenate([keys, rc[~palin]])
    out_counts = np.concatenate([fwd_counts, counts[~palin]])
    order = np.lexsort(
        tuple(out_keys[:, w] for w in range(out_keys.shape[1] - 1, -1, -1))
    )
    return out_keys[order], out_counts[order]


def words_to_np_keys(words: List[np.ndarray]) -> np.ndarray:
    """Stack W uint32 word arrays into an [N, W] big-endian-comparable
    uint32 matrix (host side)."""
    return np.stack([np.asarray(w) for w in words], axis=1)


def np_keys_view(keys: np.ndarray) -> np.ndarray:
    """View an [N, W] uint32 key matrix as void records for np.unique-style
    merging. Byte order is fixed to big-endian so bytewise compare equals
    word-wise lexicographic compare."""
    be = np.ascontiguousarray(keys.astype(">u4"))
    return be.view([("k", "V%d" % (keys.shape[1] * 4))]).reshape(-1)


def np_pack64(keys: np.ndarray) -> np.ndarray:
    """Leading 64 bits of each [N, W] key row as native uint64 (word 0 high;
    word 1 low, or zero when W == 1). Order-equivalent to the full key for
    W <= 2.

    Little-endian hosts take a column-swap + u64 view (one pass) — the
    shift/or formulation pays ~25x in u64 ufunc temporaries on this
    host (measured 7.5 s vs 0.3 s at 50M rows)."""
    import sys

    if keys.shape[1] > 1 and sys.byteorder == "little":
        sw = np.empty((len(keys), 2), np.uint32)
        sw[:, 0] = keys[:, 1]
        sw[:, 1] = keys[:, 0]
        return sw.view(np.uint64).reshape(-1)
    hi = keys[:, 0].astype(np.uint64) << np.uint64(32)
    if keys.shape[1] > 1:
        return hi | keys[:, 1].astype(np.uint64)
    return hi


def np_unpack64(p: np.ndarray, W: int) -> np.ndarray:
    """Inverse of np_pack64: uint64 -> [N, W] uint32 rows (W <= 2)."""
    import sys

    if W == 2 and sys.byteorder == "little":
        v = p.view(np.uint32).reshape(-1, 2)
        out = np.empty((len(p), 2), np.uint32)
        out[:, 0] = v[:, 1]
        out[:, 1] = v[:, 0]
        return out
    out = np.empty((len(p), W), np.uint32)
    out[:, 0] = (p >> np.uint64(32)).astype(np.uint32)
    if W == 2:
        out[:, 1] = (p & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def np_searchsorted_keys(
    sorted_keys: np.ndarray, queries: np.ndarray, side: str = "left"
) -> np.ndarray:
    """searchsorted for multiword uint32 keys using NATIVE uint64 compares.

    The void-record view (np_keys_view) makes numpy's searchsorted call a
    function-pointer memcmp per probe — ~100x slower than native ints; at
    tens of millions of nodes that was the strand-dedup wall. Here the
    leading 64 bits resolve almost every probe in one native search; the
    rare runs of equal leading bits (W > 2 only) are refined with a void
    search restricted to the tied queries."""
    N, W = sorted_keys.shape
    q = np.asarray(queries)
    if N == 0:
        return np.zeros(len(q), np.int64)
    a64 = np_pack64(sorted_keys)
    q64 = np_pack64(q)
    if len(q64) >= (1 << 20):
        # numpy's searchsorted gallops from the previous hit when queries
        # ascend — sorting queries turns 25 random probes/query into
        # near-sequential access (3-5x at tens of millions of keys)
        qo = np.argsort(q64, kind="stable")

        def _search(arr, qq, s):
            out = np.empty(len(qq), np.int64)
            out[qo] = np.searchsorted(arr, qq[qo], side=s)
            return out
    else:
        def _search(arr, qq, s):
            return np.searchsorted(arr, qq, side=s).astype(np.int64)
    if W <= 2:
        return _search(a64, q64, side)
    lo = _search(a64, q64, "left")
    hi = _search(a64, q64, "right")
    out = (lo if side == "left" else hi).astype(np.int64)
    # any query whose leading 64 bits match >= 1 table row needs the
    # remaining words to place it within (or at either end of) the run
    tie = hi > lo
    if tie.any():
        out[tie] = np.searchsorted(
            np_keys_view(sorted_keys), np_keys_view(np.ascontiguousarray(q[tie])),
            side=side,
        )
    return out


def merge_sorted_counts(
    a_keys: np.ndarray, a_counts: np.ndarray, b_keys: np.ndarray, b_counts: np.ndarray,
    op: str = "sum",
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two sorted (keys [N,W], counts) runs (host side; used across
    chunks and across hosts).

    op='sum' adds counts of equal keys (chunk accumulation); op='max' keeps
    the larger (used when overlaying re-injected contig depths over read
    counts so reads are not double-counted — see stages/assemble.py).

    Large merges route through the native O(n) scan (native/merge.cpp,
    ~2 orders of magnitude over the numpy argsort path — the host LSM
    spill tail at multi-Gbp scale); numpy is the always-available
    fallback and the semantics oracle (tests/test_native.py)."""
    if len(a_keys) == 0:
        return b_keys, b_counts
    if len(b_keys) == 0:
        return a_keys, a_counts
    # (A numpy u64-radix-argsort merge path was built and A/B'd here:
    # warm and interleaved it measures ~4 s vs the native scan's 0.65 s
    # at 2x20M rows — the native merge stays. Beware this sandbox's
    # cold-start throttling: unpaired single-shot timings invert the
    # comparison.)
    if op in ("sum", "max") and len(a_keys) + len(b_keys) >= 4096:
        from ..native import merge_native

        nat = merge_native.merge_counts(a_keys, a_counts, b_keys, b_counts, op)
        if nat is not None:
            return nat
    keys = np.concatenate([a_keys, b_keys])
    counts = np.concatenate([a_counts, b_counts]).astype(np.uint64)
    view = np_keys_view(keys)
    order = np.argsort(view, kind="stable")
    sk, sc = keys[order], counts[order]
    sv = view[order]
    new = np.empty(len(sv), dtype=bool)
    new[0] = True
    new[1:] = sv[1:] != sv[:-1]
    seg = np.cumsum(new) - 1
    if op == "sum":
        out_counts = np.zeros(seg[-1] + 1, dtype=np.uint64)
        np.add.at(out_counts, seg, sc)
    elif op == "max":
        out_counts = np.zeros(seg[-1] + 1, dtype=np.uint64)
        np.maximum.at(out_counts, seg, sc)
    else:
        raise ValueError(op)
    return sk[new], out_counts


@jax.jit
def unique_words_device(words: List[jax.Array], valid: jax.Array):
    """Gather-free sorted-unique of multiword keys: sentinel-fold + sort +
    run-start flags + stable compaction sort. Returns (unique_words padded
    with all-ones, n_unique)."""
    W = len(words)
    flat = [jnp.where(valid.reshape(-1), w.reshape(-1), jnp.uint32(0xFFFFFFFF))
            for w in words]
    v = valid.reshape(-1)
    n = v.shape[0]
    inv = jnp.where(v, jnp.uint32(0), jnp.uint32(1))
    s = jax.lax.sort(flat + [inv], num_keys=W + 1)
    s_words, s_inv = s[:W], s[W]
    s_valid = s_inv == 0
    diff = jnp.zeros((n,), jnp.bool_)
    for w in s_words:
        diff = jnp.logical_or(
            diff, jnp.concatenate([jnp.ones((1,), jnp.bool_), w[1:] != w[:-1]])
        )
    is_new = jnp.logical_and(diff, s_valid)
    flag = jnp.where(is_new, jnp.int32(0), jnp.int32(1))
    comp = jax.lax.sort([flag] + list(s_words), num_keys=1, is_stable=True)
    n_unique = jnp.sum(is_new.astype(jnp.int32))
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    out = [jnp.where(pos < n_unique, w, jnp.uint32(0xFFFFFFFF)) for w in comp[1:]]
    return out, n_unique


@jax.jit
def multiword_join_sorted(
    table: List[jax.Array], table_n: jax.Array, queries: List[jax.Array]
) -> jax.Array:
    """Sort-based join: for each query key, the rank (dense id) of the
    matching row in a SORTED-UNIQUE multiword table. Gather-free (two
    lax.sorts; payloads ride the sorts). Assumes every VALID query key is
    present in the table (graph-build invariant); rows smaller than every
    table key get -1.

    Returns [Q] int32 table ranks in the original query order."""
    W = len(table)
    Tn = table[0].shape[0]
    Qn = queries[0].shape[0]
    words = [jnp.concatenate([t, q]) for t, q in zip(table, queries)]
    tag = jnp.concatenate([
        jnp.zeros((Tn,), jnp.int32), jnp.ones((Qn,), jnp.int32)
    ])
    rank_t = jax.lax.broadcasted_iota(jnp.int32, (Tn, 1), 0).squeeze(-1)
    # table padding rows must never win the cummax
    rank_t = jnp.where(rank_t < table_n, rank_t, -1)
    orig_q = jax.lax.broadcasted_iota(jnp.int32, (Qn, 1), 0).squeeze(-1)
    payload = jnp.concatenate([rank_t, orig_q])
    # sort by (key words, tag): an equal-key table row precedes its queries
    s = jax.lax.sort(words + [tag, payload], num_keys=W + 1)
    s_tag, s_payload = s[W], s[W + 1]
    run_rank = jax.lax.cummax(jnp.where(s_tag == 0, s_payload, jnp.int32(-1)))
    qid = jnp.where(s_tag == 1, run_rank, jnp.int32(-1))
    # restore original query order: stable second sort by (tag, payload);
    # the last Qn rows are the queries, ordered
    s2 = jax.lax.sort([s_tag, s_payload, qid], num_keys=2)
    return s2[2][Tn:]


@jax.jit
def multiword_member_sorted(
    table: List[jax.Array], table_n: jax.Array, queries: List[jax.Array]
) -> jax.Array:
    """Gather-free membership: for each multiword query key, whether it
    appears among the first ``table_n`` rows of the sorted table. Unlike
    :func:`multiword_join_sorted`, absent queries are fine (returns False).

    Method: sort table+queries by (words, is_padding, tag) so that within
    one equal-key run real table rows come first, then queries, then table
    padding (all-ones rows beyond table_n — which can COLLIDE with a real
    all-T key when 2(k+1) is a multiple of 32, so padding must be ordered
    by the explicit flag, not by key). A query matches iff the FIRST row of
    its key-run is a real table row; that bit is propagated run-internally
    by a cummax over position-packed codes.

    Returns [Q] bool in the original query order."""
    W = len(table)
    Tn = table[0].shape[0]
    Qn = queries[0].shape[0]
    n = Tn + Qn
    words = [jnp.concatenate([t, q]) for t, q in zip(table, queries)]
    pos_t = jax.lax.broadcasted_iota(jnp.int32, (Tn, 1), 0).squeeze(-1)
    inv = jnp.concatenate([
        jnp.where(pos_t < table_n, jnp.int32(0), jnp.int32(1)),
        jnp.zeros((Qn,), jnp.int32),
    ])
    tag = jnp.concatenate([
        jnp.zeros((Tn,), jnp.int32), jnp.ones((Qn,), jnp.int32)
    ])
    orig_q = jax.lax.broadcasted_iota(jnp.int32, (Qn, 1), 0).squeeze(-1)
    payload = jnp.concatenate([jnp.zeros((Tn,), jnp.int32), orig_q])
    s = jax.lax.sort(words + [inv, tag, payload], num_keys=W + 2)
    s_words, s_inv, s_tag, s_pay = s[:W], s[W], s[W + 1], s[W + 2]
    diff = jnp.zeros((n,), jnp.bool_)
    for w in s_words:
        diff = jnp.logical_or(
            diff, jnp.concatenate([jnp.ones((1,), jnp.bool_), w[1:] != w[:-1]])
        )
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    start_is_table = jnp.logical_and(s_tag == 0, s_inv == 0)
    code = jnp.where(diff, pos * 2 + start_is_table.astype(jnp.int32), -1)
    filled = jax.lax.cummax(code)
    member = jnp.logical_and(s_tag == 1, (filled & 1) == 1)
    s2 = jax.lax.sort(
        [s_tag, s_pay, member.astype(jnp.int32)], num_keys=2
    )
    return s2[2][Tn:] == 1


# ------------------------------------------------------- multiword searching
def multiword_searchsorted(
    table: List[jax.Array], queries: List[jax.Array], table_size: jax.Array
) -> jax.Array:
    """Lower-bound binary search of multi-word queries in a lexicographically
    sorted multi-word table.

    table: list of W arrays [V] uint32 (sorted, padded with 0xFFFFFFFF).
    queries: list of W arrays [Q] uint32.
    table_size: scalar int32, number of real rows (padding excluded).
    Returns [Q] int32 insertion indices.
    """
    V = table[0].shape[0]
    Q = queries[0].shape[0]
    iters = max(1, math.ceil(math.log2(V + 1)))

    def lex_less(mid):
        """table[mid] < query, vectorized over Q."""
        lt = jnp.zeros((Q,), jnp.bool_)
        eq = jnp.ones((Q,), jnp.bool_)
        for tw, qw in zip(table, queries):
            t = tw[mid]
            lt = jnp.logical_or(lt, jnp.logical_and(eq, t < qw))
            eq = jnp.logical_and(eq, t == qw)
        return lt

    def body(_, lohi):
        lo, hi = lohi
        mid = (lo + hi) // 2
        go_right = lex_less(jnp.clip(mid, 0, V - 1))
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
        return lo, hi

    lo = jnp.zeros((Q,), jnp.int32)
    hi = jnp.broadcast_to(jnp.asarray(table_size, jnp.int32), (Q,))
    lo, _ = jax.lax.fori_loop(0, iters, body, (lo, hi))
    return lo


def multiword_equal_at(
    table: List[jax.Array], queries: List[jax.Array], idx: jax.Array, table_size: jax.Array
) -> jax.Array:
    """True where table[idx] == query (and idx < table_size)."""
    safe = jnp.clip(idx, 0, table[0].shape[0] - 1)
    eq = idx < table_size
    for tw, qw in zip(table, queries):
        eq = jnp.logical_and(eq, tw[safe] == qw)
    return eq
