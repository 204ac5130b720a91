"""Batched affine-gap local alignment (Smith-Waterman) on device.

One kernel serves every pairwise-alignment consumer of the pipeline, the
roles the reference delegates to external C tools:

- tblastn/blastn hit scoring (annotation_tookit.py:55-143) — protein mode
  with BLOSUM62 after six-frame translation, nucleotide mode with
  match/mismatch rewards;
- read remapping for depth (findmitoscaf.py:445-456, bwa mem | samtools) —
  nucleotide mode over candidate windows;
- contig overlap scoring for merging.

Formulation: lax.scan over target positions; H/E state vectors over
[batch, query_len]. The within-row F (query-axis gap)
dependency is closed exactly with an exclusive max-plus prefix scan
(valid when gap_open >= gap_extend — Farrar's lazy-F argument: an H cell
that is itself F-derived never seeds a better F). Alignment envelopes
(start/end in query and target) and identity counts are carried through
the forward pass, so no traceback is needed for hit tables.

Gap convention: a gap of length g costs gap_open + (g-1)*gap_extend (the
first gapped residue pays `open`). To emulate BLAST's open+g*ext scoring,
pass gap_open_blast + gap_extend as `gap_open`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

NEG = -1e30


class SwHits(NamedTuple):
    score: jax.Array    # [B] float32
    q_from: jax.Array   # [B] int32 0-based inclusive
    q_to: jax.Array
    t_from: jax.Array
    t_to: jax.Array
    n_ident: jax.Array  # [B] identical positions on the best path
    n_cols: jax.Array   # [B] aligned columns (match/mismatch+gaps)
    n_gapopen: jax.Array  # [B] gap openings on the best path (outfmt6 col 6)
    n_gapcols: jax.Array  # [B] gapped columns (so mismatch = cols-ident-gapcols)


def nucleotide_matrix(match: int = 2, mismatch: int = -3) -> np.ndarray:
    """5x5 (ACGTN) scoring matrix; N scores mismatch against everything."""
    m = np.full((5, 5), mismatch, dtype=np.int32)
    np.fill_diagonal(m, match)
    m[4, :] = mismatch
    m[:, 4] = mismatch
    return m


@functools.partial(jax.jit, static_argnames=("gap_open", "gap_extend"))
def sw_align(
    queries: jax.Array,   # [B, Lq] int8 symbol codes
    q_lens: jax.Array,    # [B]
    targets: jax.Array,   # [B, Lt] int8
    t_lens: jax.Array,    # [B]
    submat: jax.Array,    # [K, K] float32/int32 substitution scores
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
) -> SwHits:
    B, Lq = queries.shape
    _, Lt = targets.shape
    submat = submat.astype(jnp.float32)
    K = submat.shape[0]
    jcol = jax.lax.broadcasted_iota(jnp.int32, (B, Lq), 1)
    q_in = jcol < q_lens[:, None]
    qc = jnp.clip(queries, 0, K - 1).astype(jnp.int32)
    # pre-gather each query's substitution rows ONCE; per-step scores are
    # then a one-hot batched matvec, at HIGHEST precision so it stays an
    # exact select (a GPU may otherwise run float32 products in TF32)
    spre = submat[qc]  # [B, Lq, K]

    ext_ramp = gap_extend * jcol.astype(jnp.float32)

    def shift_right(x, fill):
        return jnp.concatenate(
            [jnp.full((B, 1), fill, x.dtype), x[:, :-1]], axis=1
        )

    zero_i = jnp.zeros((B, Lq), jnp.int32)
    init = dict(
        H=jnp.zeros((B, Lq)), E=jnp.full((B, Lq), NEG),
        H_qs=zero_i, H_ts=zero_i, H_id=zero_i, H_nc=zero_i,
        H_go=zero_i, H_gc=zero_i,
        E_qs=zero_i, E_ts=zero_i, E_id=zero_i, E_nc=zero_i,
        E_go=zero_i, E_gc=zero_i,
        bV=jnp.zeros((B, Lq)),
        bV_qs=zero_i, bV_ts=zero_i, bV_id=zero_i, bV_nc=zero_i,
        bV_go=zero_i, bV_gc=zero_i,
        bV_t=zero_i,
    )

    def step(st, t):
        x = targets[:, t].astype(jnp.int32)          # [B]
        t_valid = t < t_lens                          # [B]
        oh = jax.nn.one_hot(jnp.clip(x, 0, K - 1), K, dtype=jnp.float32)
        s = jnp.einsum("bk,bjk->bj", oh, spre, precision=jax.lax.Precision.HIGHEST)
        valid = jnp.logical_and(q_in, t_valid[:, None])
        s = jnp.where(valid, s, NEG)
        is_match = jnp.logical_and(valid, qc == x[:, None])

        # E: gap along target (consume target symbol, stay at q column)
        e_open = st["H"] - gap_open
        e_ext = st["E"] - gap_extend
        take_open = e_open >= e_ext
        E = jnp.where(take_open, e_open, e_ext)
        E_qs = jnp.where(take_open, st["H_qs"], st["E_qs"])
        E_ts = jnp.where(take_open, st["H_ts"], st["E_ts"])
        E_id = jnp.where(take_open, st["H_id"], st["E_id"])
        E_nc = jnp.where(take_open, st["H_nc"], st["E_nc"]) + 1
        E_go = jnp.where(take_open, st["H_go"] + 1, st["E_go"])
        E_gc = jnp.where(take_open, st["H_gc"], st["E_gc"]) + 1

        # diagonal
        dH = shift_right(st["H"], 0.0)
        d_qs = shift_right(st["H_qs"], 0)
        d_ts = shift_right(st["H_ts"], 0)
        d_id = shift_right(st["H_id"], 0)
        d_nc = shift_right(st["H_nc"], 0)
        d_go = shift_right(st["H_go"], 0)
        d_gc = shift_right(st["H_gc"], 0)
        first_col = jcol == 0
        # a fresh start is a diagonal move from score 0 at (t, j)
        fresh = jnp.logical_or(first_col, dH <= 0.0)
        diag = jnp.where(first_col, 0.0, dH)
        diag_qs = jnp.where(fresh, jcol, d_qs)
        diag_ts = jnp.where(fresh, jnp.int32(t), d_ts)
        diag_id = jnp.where(fresh, 0, d_id)
        diag_nc = jnp.where(fresh, 0, d_nc)
        diag_go = jnp.where(fresh, 0, d_go)
        diag_gc = jnp.where(fresh, 0, d_gc)
        diag = jnp.maximum(diag, 0.0)
        cand_d = diag + s
        cand_d_id = diag_id + is_match.astype(jnp.int32)
        cand_d_nc = diag_nc + 1

        use_d = cand_d >= E
        Hp = jnp.where(use_d, cand_d, E)
        Hp_qs = jnp.where(use_d, diag_qs, E_qs)
        Hp_ts = jnp.where(use_d, diag_ts, E_ts)
        Hp_id = jnp.where(use_d, cand_d_id, E_id)
        Hp_nc = jnp.where(use_d, cand_d_nc, E_nc)
        Hp_go = jnp.where(use_d, diag_go, E_go)
        Hp_gc = jnp.where(use_d, diag_gc, E_gc)

        # F: gap along query axis, exact lazy-F via exclusive prefix max of
        # a[j] = H'[j] + ext*j. The argmax payload carries the ORIGIN COLUMN,
        # so the gap length (j - origin) — and with it exact column/gap
        # counts — is recovered at the landing column.
        a = Hp + ext_ramp

        def comb(l, r):
            tl = l[0] >= r[0]
            return tuple(jnp.where(tl, x, y) for x, y in zip(l, r))

        cm, cm_qs, cm_ts, cm_id, cm_nc, cm_go, cm_gc, cm_col = (
            jax.lax.associative_scan(
                comb, (a, Hp_qs, Hp_ts, Hp_id, Hp_nc, Hp_go, Hp_gc, jcol),
                axis=1,
            )
        )
        cm = shift_right(cm, NEG)
        F_qs = shift_right(cm_qs, 0)
        F_ts = shift_right(cm_ts, 0)
        F_id = shift_right(cm_id, 0)
        F_nc = shift_right(cm_nc, 0)
        F_go = shift_right(cm_go, 0)
        F_gc = shift_right(cm_gc, 0)
        F_col = shift_right(cm_col, 0)
        F = cm - ext_ramp - (gap_open - gap_extend)
        gap_len = jcol - F_col                 # exact F-gap length
        F_nc = F_nc + gap_len
        F_gc = F_gc + gap_len
        F_go = F_go + 1

        use_f = F > Hp
        H = jnp.where(use_f, F, Hp)
        H_qs = jnp.where(use_f, F_qs, Hp_qs)
        H_ts = jnp.where(use_f, F_ts, Hp_ts)
        H_id = jnp.where(use_f, F_id, Hp_id)
        H_nc = jnp.where(use_f, F_nc, Hp_nc)
        H_go = jnp.where(use_f, F_go, Hp_go)
        H_gc = jnp.where(use_f, F_gc, Hp_gc)
        H = jnp.maximum(H, 0.0)
        H = jnp.where(valid, H, 0.0)

        # per-column best tracking (elementwise); final argmax after the scan
        better = H > st["bV"]
        new = dict(
            H=H, E=E, H_qs=H_qs, H_ts=H_ts, H_id=H_id, H_nc=H_nc,
            H_go=H_go, H_gc=H_gc,
            E_qs=E_qs, E_ts=E_ts, E_id=E_id, E_nc=E_nc, E_go=E_go, E_gc=E_gc,
            bV=jnp.where(better, H, st["bV"]),
            bV_qs=jnp.where(better, H_qs, st["bV_qs"]),
            bV_ts=jnp.where(better, H_ts, st["bV_ts"]),
            bV_id=jnp.where(better, H_id, st["bV_id"]),
            bV_nc=jnp.where(better, H_nc, st["bV_nc"]),
            bV_go=jnp.where(better, H_go, st["bV_go"]),
            bV_gc=jnp.where(better, H_gc, st["bV_gc"]),
            bV_t=jnp.where(better, jnp.int32(t), st["bV_t"]),
        )
        return new, None

    st, _ = jax.lax.scan(step, init, jnp.arange(Lt))
    endj = jnp.argmax(st["bV"], axis=1)
    pick = lambda a: jnp.take_along_axis(a, endj[:, None], 1)[:, 0]
    return SwHits(
        score=pick(st["bV"]),
        q_from=pick(st["bV_qs"]), q_to=endj.astype(jnp.int32),
        t_from=pick(st["bV_ts"]), t_to=pick(st["bV_t"]),
        n_ident=pick(st["bV_id"]), n_cols=pick(st["bV_nc"]),
        n_gapopen=pick(st["bV_go"]), n_gapcols=pick(st["bV_gc"]),
    )


def sw_align_numpy(query, target, submat, gap_open=11.0, gap_extend=1.0):
    """Reference implementation (full DP matrix) for tests: returns
    (score, q_from, q_to, t_from, t_to)."""
    Lq, Lt = len(query), len(target)
    H = np.zeros((Lt + 1, Lq + 1))
    E = np.full((Lt + 1, Lq + 1), NEG)
    F = np.full((Lt + 1, Lq + 1), NEG)
    best, at = 0.0, (0, 0)
    for t in range(1, Lt + 1):
        for j in range(1, Lq + 1):
            E[t][j] = max(H[t - 1][j] - gap_open, E[t - 1][j] - gap_extend)
            F[t][j] = max(H[t][j - 1] - gap_open, F[t][j - 1] - gap_extend)
            s = submat[query[j - 1], target[t - 1]]
            H[t][j] = max(0.0, H[t - 1][j - 1] + s, E[t][j], F[t][j])
            if H[t][j] > best:
                best, at = H[t][j], (t, j)
    # traceback for coordinates
    t, j = at
    state = "H"
    while t > 0 and j > 0 and H[t][j] > 0:
        if state == "H":
            s = submat[query[j - 1], target[t - 1]]
            if H[t][j] == H[t - 1][j - 1] + s:
                t, j = t - 1, j - 1
                if H[t][j] == 0:
                    break
            elif H[t][j] == E[t][j]:
                state = "E"
            elif H[t][j] == F[t][j]:
                state = "F"
            else:
                break
        elif state == "E":
            if E[t][j] == H[t - 1][j] - gap_open:
                state = "H"
            t = t - 1
        else:
            if F[t][j] == H[t][j - 1] - gap_open:
                state = "H"
            j = j - 1
    return best, j, at[1] - 1, t, at[0] - 1
