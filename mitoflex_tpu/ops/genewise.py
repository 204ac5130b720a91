"""Codon-aware protein-vs-DNA alignment with frameshifts (genewise
equivalent).

Replaces the reference's per-hit ``genewise`` subprocess loop (hot loop #6,
annotation_tookit.py:264-311: wise2 run serially on each washed blast hit's
±30 bp window with the invertebrate-mito codon table). Mito genes have no
introns, so what the pipeline actually uses genewise for is frameshift-
tolerant alignment refinement and the derived columns

    wise_cover      aligned fraction of the protein query
    wise_shift      number of frameshifts on the best path
    wise_min_start  leftmost DNA coordinate of the aligned cds blocks
    wise_max_end    rightmost DNA coordinate

This op computes exactly those, batched over ALL hits in one device call
(vs the reference's serial loop). DP over DNA positions t with state
vectors [hits, protein_len]:

    H[t,j] = s(q_j, aa(t-2..t)) + max(0,
             H[t-3,j-1],                      codon match
             H[t-dt,j-1] + fs_pen  (dt=1,2,4,5)  frameshift
             E[t,j], F[t,j])                  codon / residue gaps
    E[t,j] = max(H[t-3,j] - open, E[t-3,j] - ext)    gap in protein axis
    F      = lazy-F prefix scan along j               gap in DNA axis

Frameshift count and alignment envelopes are carried through the forward
pass; in-frame stops score ``stop_penalty``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models import codon

NEG = -1e30


class WiseHits(NamedTuple):
    score: jax.Array     # [B]
    q_from: jax.Array    # [B] 0-based aa coords
    q_to: jax.Array
    t_from: jax.Array    # [B] 0-based nt coords (start of first codon)
    t_to: jax.Array      # [B] (end of last codon, inclusive)
    n_shift: jax.Array   # [B] frameshifts on best path


def translate_windows(windows: np.ndarray, table_id: int) -> np.ndarray:
    """aa code of the codon ENDING at each position t (t >= 2), else X.
    windows: [B, T] base codes."""
    gc = codon.get_code(table_id)
    B, T = windows.shape
    out = np.full((B, T), codon.X_CODE, dtype=np.int8)
    if T < 3:
        return out
    c0 = windows[:, : T - 2].astype(np.int32)
    c1 = windows[:, 1 : T - 1].astype(np.int32)
    c2 = windows[:, 2:].astype(np.int32)
    bad = (c0 >= 4) | (c1 >= 4) | (c2 >= 4)
    idx = c0 * 16 + c1 * 4 + c2
    aa = gc.aa_lut[np.where(bad, 0, idx)]
    aa[bad] = codon.X_CODE
    out[:, 2:] = aa
    return out


@functools.partial(
    jax.jit, static_argnames=("gap_open", "gap_extend", "fs_penalty", "stop_penalty")
)
def genewise_align(
    queries: jax.Array,    # [B, Lq] aa codes
    q_lens: jax.Array,     # [B]
    target_aa: jax.Array,  # [B, T] aa-of-codon-ending-at-t (int8)
    t_lens: jax.Array,     # [B] nt lengths
    submat: jax.Array,     # [K, K]
    gap_open: float = 13.0,
    gap_extend: float = 3.0,
    fs_penalty: float = 15.0,
    stop_penalty: float = 20.0,
) -> WiseHits:
    B, Lq = queries.shape
    _, T = target_aa.shape
    submat = submat.astype(jnp.float32)
    K = submat.shape[0]
    jcol = jax.lax.broadcasted_iota(jnp.int32, (B, Lq), 1)
    q_in = jcol < q_lens[:, None]
    qc = jnp.clip(queries, 0, K - 1).astype(jnp.int32)
    # pre-gathered substitution rows; in-scan scores via one-hot matvec at
    # HIGHEST precision, an exact select (not TF32)
    spre = submat[qc]  # [B, Lq, K]
    ext_ramp = gap_extend * jcol.astype(jnp.float32)

    def shift_right(x, fill):
        return jnp.concatenate([jnp.full((B, 1), fill, x.dtype), x[:, :-1]], axis=1)

    zero_i = jnp.zeros((B, Lq), jnp.int32)
    negm = jnp.full((B, Lq), NEG)
    # rolling buffers of the last 5 rows: index 4 = t-1, 0 = t-5
    init = dict(
        Hs=jnp.stack([negm] * 5), E=jnp.stack([negm] * 3),
        qs=jnp.stack([zero_i] * 5), ts=jnp.stack([zero_i] * 5),
        sh=jnp.stack([zero_i] * 5),
        E_qs=jnp.stack([zero_i] * 3), E_ts=jnp.stack([zero_i] * 3),
        E_sh=jnp.stack([zero_i] * 3),
        bV=jnp.zeros((B, Lq)),
        bV_qs=zero_i, bV_ts=zero_i, bV_sh=zero_i, bV_t=zero_i,
    )

    def step(st, t):
        aa = target_aa[:, t].astype(jnp.int32)
        t_valid = t < t_lens
        oh = jax.nn.one_hot(jnp.clip(aa, 0, K - 1), K, dtype=jnp.float32)
        s = jnp.einsum("bk,bjk->bj", oh, spre, precision=jax.lax.Precision.HIGHEST)
        s = jnp.where(aa[:, None] == codon.STOP_CODE, -stop_penalty, s)
        valid = jnp.logical_and(q_in, t_valid[:, None])
        s = jnp.where(valid, s, NEG)

        # candidates from H[t-dt][j-1] (shifted right along j)
        def prev(dt):
            i = 5 - dt
            return (
                shift_right(st["Hs"][i], 0.0),
                shift_right(st["qs"][i], 0),
                shift_right(st["ts"][i], 0),
                shift_right(st["sh"][i], 0),
            )

        cands, pq, pt, psh = [], [], [], []
        # fresh start (score 0 at this codon: origin = (j, t-2))
        cands.append(jnp.zeros((B, Lq)))
        pq.append(jcol)
        pt.append(jnp.broadcast_to(jnp.maximum(t - 2, 0).astype(jnp.int32), (B, Lq)))
        psh.append(zero_i)
        for dt, pen in ((3, 0.0), (1, fs_penalty), (2, fs_penalty),
                        (4, fs_penalty), (5, fs_penalty)):
            # early steps are handled by the NEG-initialized rolling buffers
            h, q0, t0, sh0 = prev(dt)
            h = jnp.where(h <= 0.0, NEG, h)  # restarts handled by the 0 cand
            cands.append(h - pen)
            pq.append(q0)
            pt.append(t0)
            psh.append(sh0 + (0 if dt == 3 else 1))
        # E: codon gap along the DNA axis. E[t] (in-gap through t) is built
        # from t-3; a codon match at t resumes from E[t-3] (one query
        # residue consumed -> shift right along j).
        e_prev = st["E"][0]          # E[t-3]
        h3 = st["Hs"][2]             # H[t-3]
        e_open = h3 - gap_open
        e_ext = e_prev - gap_extend
        take_open = e_open >= e_ext
        E = jnp.where(take_open, e_open, e_ext)
        E_qs = jnp.where(take_open, st["qs"][2], st["E_qs"][0])
        E_ts = jnp.where(take_open, st["ts"][2], st["E_ts"][0])
        E_sh = jnp.where(take_open, st["sh"][2], st["E_sh"][0])
        cands.append(shift_right(e_prev, NEG))
        pq.append(shift_right(st["E_qs"][0], 0))
        pt.append(shift_right(st["E_ts"][0], 0))
        psh.append(shift_right(st["E_sh"][0], 0))

        # where-chain candidate selection (no stacked argmax+gather)
        arr = cands[0]
        H_qs, H_ts, H_sh = pq[0], pt[0], psh[0]
        for c in range(1, len(cands)):
            take = cands[c] > arr
            H_qs = jnp.where(take, pq[c], H_qs)
            H_ts = jnp.where(take, pt[c], H_ts)
            H_sh = jnp.where(take, psh[c], H_sh)
            arr = jnp.where(take, cands[c], arr)
        Hp = s + arr

        # F: protein gap (skip query residues, no DNA) — lazy-F prefix scan
        a = Hp + ext_ramp

        def comb(l, r):
            lv, l1, l2, l3 = l
            rv, r1, r2, r3 = r
            tl = lv >= rv
            w = lambda x, y: jnp.where(tl, x, y)
            return (w(lv, rv), w(l1, r1), w(l2, r2), w(l3, r3))

        cm, c_qs, c_ts, c_sh = jax.lax.associative_scan(
            comb, (a, H_qs, H_ts, H_sh), axis=1
        )
        F = shift_right(cm, NEG) - ext_ramp - (gap_open - gap_extend)
        use_f = F > Hp
        H = jnp.where(use_f, F, Hp)
        H_qs = jnp.where(use_f, shift_right(c_qs, 0), H_qs)
        H_ts = jnp.where(use_f, shift_right(c_ts, 0), H_ts)
        H_sh = jnp.where(use_f, shift_right(c_sh, 0), H_sh)
        H = jnp.where(valid, jnp.maximum(H, NEG), NEG)

        better = H > st["bV"]
        new = dict(
            Hs=jnp.concatenate([st["Hs"][1:], H[None]]),
            E=jnp.concatenate([st["E"][1:], E[None]]),
            qs=jnp.concatenate([st["qs"][1:], H_qs[None]]),
            ts=jnp.concatenate([st["ts"][1:], H_ts[None]]),
            sh=jnp.concatenate([st["sh"][1:], H_sh[None]]),
            E_qs=jnp.concatenate([st["E_qs"][1:], E_qs[None]]),
            E_ts=jnp.concatenate([st["E_ts"][1:], E_ts[None]]),
            E_sh=jnp.concatenate([st["E_sh"][1:], E_sh[None]]),
            bV=jnp.where(better, H, st["bV"]),
            bV_qs=jnp.where(better, H_qs, st["bV_qs"]),
            bV_ts=jnp.where(better, H_ts, st["bV_ts"]),
            bV_sh=jnp.where(better, H_sh, st["bV_sh"]),
            bV_t=jnp.where(better, jnp.int32(t), st["bV_t"]),
        )
        return new, None

    st, _ = jax.lax.scan(step, init, jnp.arange(T))
    endj = jnp.argmax(st["bV"], axis=1)
    pick = lambda a: jnp.take_along_axis(a, endj[:, None], 1)[:, 0]
    return WiseHits(
        score=pick(st["bV"]),
        q_from=pick(st["bV_qs"]), q_to=endj.astype(jnp.int32),
        t_from=pick(st["bV_ts"]), t_to=pick(st["bV_t"]),
        n_shift=pick(st["bV_sh"]),
    )
