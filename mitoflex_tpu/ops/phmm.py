"""Profile-HMM local Viterbi scan on device.

Device replacement for nhmmer's DNA profile search (reference hot loop
#4: annotation/annotation_tookit.py:510-548 shells out to ``nhmmer`` over
per-clade CDS models). One device call scores a batch of sequence windows
against one profile and returns per-window best local alignment score plus
its coordinates (sequence from/to and model from/to) — the information the
pipeline consumes from nhmmer's tblout (target/query from/to, score).

DP formulation (plan7 local, uniform entry, free exit):

    M[t,j] = msc[j, x_t] + max(entry + 0,                     (B -> M_j)
                               M[t-1,j-1] + tMM[j-1],
                               I[t-1,j-1] + tIM[j-1],
                               D[t-1,j-1] + tDM[j-1])
    I[t,j] = isc[j, x_t] + max(M[t-1,j] + tMI[j], I[t-1,j] + tII[j])
    D[t,j] = max_{i<j} (M[t,i] + tMD[i] + sum_{u=i+1..j-1} tDD[u])

The D row is a max-plus prefix reduction: with c[j] = cumsum(tDD),
D[t,j] = c[j-1] + cummax_{i<j}(M[t,i] + tMD[i] - c[i]) — computed with an
associative scan that also carries the argmax's (seq_start, model_start)
so alignment envelopes come out of the forward pass with no traceback.
The t loop is a lax.scan; everything inside is vectorized over
[batch, model_len].

Kernel scores are in bits (log2-odds vs flat background) for the aligned
region only; :func:`length_correction_bits` applies HMMER's NJC
length-model correction and :func:`null2_bias_bits` the composition-bias
(null2) discount host-side (callers apply both before thresholding —
models/nhmmer.py does). E-values use the model's STATS VITERBI gumbel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.hmm import ProfileHMM

NEG = -1e30


class HmmHits(NamedTuple):
    score: jax.Array     # [B] float32 best local score (bits)
    seq_from: jax.Array  # [B] int32 0-based inclusive
    seq_to: jax.Array    # [B] int32 0-based inclusive
    hmm_from: jax.Array  # [B] int32 1-based model node
    hmm_to: jax.Array    # [B] int32


class DeviceProfile(NamedTuple):
    """Model arrays staged for the kernel (padded model length Lp)."""

    msc: jax.Array     # [Lp, 4] match log2-odds
    isc: jax.Array     # [Lp, 4] insert log2-odds
    tmm: jax.Array     # [Lp] transition bits into M_{j} from M_{j-1} ... etc
    tim: jax.Array
    tdm: jax.Array
    tmi: jax.Array
    tii: jax.Array
    tmd: jax.Array
    cdd: jax.Array     # [Lp] cumulative tDD bits
    entry: jax.Array   # scalar B->M entry score (bits)
    length: int        # real model length L


def stage_profile(hmm: ProfileHMM, pad_to: int = 0) -> DeviceProfile:
    """Convert a parsed model into padded device arrays.

    Index convention: arrays are indexed by j-1 (model node j in 1..L at
    row j-1). Transition vectors are aligned so that row j-1 holds the
    transition INTO node j (i.e. t*(j-1) for M/I/D arrivals).

    With pad_to=0 (default) the padded length is the next power of two
    (>=128): shape bucketing keeps the number of distinct compiled kernels
    small across a model family."""
    L = hmm.length
    if pad_to:
        Lp = -(-L // pad_to) * pad_to
    else:
        Lp = 128
        while Lp < L:
            Lp <<= 1
    msc_full = hmm.match_scores_bits()      # [L+1, 4]
    isc_full = hmm.insert_scores_bits()
    tb = hmm.trans_bits()                   # [L+1, 7]

    def pad(v, fill):
        out = np.full((Lp,) + v.shape[1:], fill, np.float32)
        out[: v.shape[0]] = v
        return out

    msc = pad(msc_full[1:], NEG)
    isc = pad(isc_full[1:], NEG)
    # transitions into node j come from row j-1 of the file table
    tmm = pad(tb[0:L, ProfileHMM.MM], NEG)
    tim = pad(tb[0:L, ProfileHMM.IM], NEG)
    tdm = pad(tb[0:L, ProfileHMM.DM], NEG)
    # self transitions at node j (row j)
    tmi = pad(tb[1 : L + 1, ProfileHMM.MI], NEG)
    tii = pad(tb[1 : L + 1, ProfileHMM.II], NEG)
    tmd = pad(tb[1 : L + 1, ProfileHMM.MD], NEG)
    # clip "impossible" (-inf) transitions to -1e4 bits so cumulative sums
    # stay finite and differences of cdd remain meaningful
    tdd = np.clip(tb[1 : L + 1, ProfileHMM.DD], -1e4, 0)
    cdd = pad(np.cumsum(tdd), NEG)
    entry = np.float32(math.log2(2.0 / (L * (L + 1))))
    return DeviceProfile(
        jnp.asarray(msc), jnp.asarray(isc),
        jnp.asarray(tmm), jnp.asarray(tim), jnp.asarray(tdm),
        jnp.asarray(tmi), jnp.asarray(tii), jnp.asarray(tmd),
        jnp.asarray(cdd), jnp.asarray(entry), L,
    )


def _select(onehot, table):
    """Emission lookup as a one-hot product. HIGHEST precision keeps it an
    exact select: at default precision a GPU may run a float32 product in
    TF32, which would round the bit scores."""
    return jnp.matmul(onehot, table, precision=jax.lax.Precision.HIGHEST)


def _shift_right(x, fill):
    return jnp.concatenate([jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]], axis=-1)


def _pick4(vals, payloads):
    """Max over 4 candidate arrays with payload selection via where-chains
    (no gathers: take_along_axis/argmax-gather per step)."""
    best = vals[0]
    picked = [p[0] for p in payloads]
    for c in range(1, len(vals)):
        take = vals[c] > best
        for i, p in enumerate(payloads):
            picked[i] = jnp.where(take, p[c], picked[i])
        best = jnp.where(take, vals[c], best)
    return best, picked


@functools.partial(jax.jit, static_argnames=("delete_band",))
def viterbi_scan(
    prof: DeviceProfile,
    seqs: jax.Array,       # [B, T] int8 (4 = N/pad)
    lengths: jax.Array,    # [B] int32
    model_len,             # traced scalar: compile key stays shape-only
    delete_band: int = 16,
) -> HmmHits:
    """``delete_band`` bounds the within-row delete-chain closure: runs of
    consecutive deletes longer than the band are not considered (log2(band)
    shifted-max rounds instead of a full-width associative scan). In LOCAL
    alignment a longer delete chain always scores worse than re-entry, so
    a small band is exact in practice; pass 0 for the exact full scan."""
    B, T = seqs.shape
    Lp = prof.msc.shape[0]
    jcol = jax.lax.broadcasted_iota(jnp.int32, (B, Lp), 1)
    in_model = jcol < model_len
    msc_t = prof.msc.T  # [4, Lp]
    isc_t = prof.isc.T

    neg = jnp.float32(NEG)
    init = dict(
        M=jnp.full((B, Lp), neg), I=jnp.full((B, Lp), neg), D=jnp.full((B, Lp), neg),
        M_ts=jnp.zeros((B, Lp), jnp.int32), M_js=jnp.zeros((B, Lp), jnp.int32),
        I_ts=jnp.zeros((B, Lp), jnp.int32), I_js=jnp.zeros((B, Lp), jnp.int32),
        D_ts=jnp.zeros((B, Lp), jnp.int32), D_js=jnp.zeros((B, Lp), jnp.int32),
        # per-column best-M-ever (final reduction happens outside the scan)
        bV=jnp.full((B, Lp), neg),
        bV_ts=jnp.zeros((B, Lp), jnp.int32), bV_js=jnp.zeros((B, Lp), jnp.int32),
        bV_t=jnp.zeros((B, Lp), jnp.int32),
    )

    def step(state, t):
        x = seqs[:, t].astype(jnp.int32)                       # [B]
        x_valid = jnp.logical_and(x < 4, t < lengths)          # [B]
        oh = jax.nn.one_hot(jnp.clip(x, 0, 3), 4, dtype=jnp.float32)
        em = jnp.where(x_valid[:, None], _select(oh, msc_t), neg)
        ei = jnp.where(x_valid[:, None], _select(oh, isc_t), neg)

        Mp = _shift_right(state["M"], NEG)     # M[t-1, j-1]
        Ip = _shift_right(state["I"], NEG)
        Dp = _shift_right(state["D"], NEG)
        Mp_ts = _shift_right(state["M_ts"], 0)
        Mp_js = _shift_right(state["M_js"], 0)
        Ip_ts = _shift_right(state["I_ts"], 0)
        Ip_js = _shift_right(state["I_js"], 0)
        Dp_ts = _shift_right(state["D_ts"], 0)
        Dp_js = _shift_right(state["D_js"], 0)
        # prof.tmm/tim/tdm row i holds the transition INTO node i+1, aligned
        # with the arrival index — shift the STATE, not the table.
        entry_ts = jnp.broadcast_to(jnp.int32(t), (B, Lp))
        entry_js = jnp.broadcast_to(jcol + 1, (B, Lp))
        cand_vals = [
            jnp.broadcast_to(prof.entry, (B, Lp)),
            Mp + prof.tmm[None, :],
            Ip + prof.tim[None, :],
            Dp + prof.tdm[None, :],
        ]
        ts_cands = [entry_ts, Mp_ts, Ip_ts, Dp_ts]
        js_cands = [entry_js, Mp_js, Ip_js, Dp_js]
        bestM, (M_ts, M_js) = _pick4(cand_vals, [ts_cands, js_cands])
        M = jnp.where(in_model, em + bestM, neg)

        iv_m = state["M"] + prof.tmi[None, :]
        iv_i = state["I"] + prof.tii[None, :]
        take_m = iv_m >= iv_i
        bestI = jnp.where(take_m, iv_m, iv_i)
        I_ts = jnp.where(take_m, state["M_ts"], state["I_ts"])
        I_js = jnp.where(take_m, state["M_js"], state["I_js"])
        I = jnp.where(in_model, ei + bestI, neg)

        # D row: c[j-1] + max_{i<j}(M[t,i] + tMD[i] - c[i]) — closed either
        # exactly (associative scan) or over a bounded trailing window via
        # log2(band) shifted-max doubling rounds
        a = M + prof.tmd[None, :] - prof.cdd[None, :]
        a = jnp.where(in_model, a, neg)

        def comb(l, r):
            lv, lts, ljs = l
            rv, rts, rjs = r
            take_l = lv >= rv
            return (
                jnp.where(take_l, lv, rv),
                jnp.where(take_l, lts, rts),
                jnp.where(take_l, ljs, rjs),
            )

        if delete_band and delete_band > 0:
            cm, cm_ts, cm_js = a, M_ts, M_js
            shift = 1
            while shift < delete_band:
                sh = lambda x, fill: jnp.concatenate(
                    [jnp.full((x.shape[0], shift), fill, x.dtype), x[:, :-shift]],
                    axis=1,
                )
                cm, cm_ts, cm_js = comb(
                    (cm, cm_ts, cm_js), (sh(cm, NEG), sh(cm_ts, 0), sh(cm_js, 0))
                )
                shift *= 2
        else:
            cm, cm_ts, cm_js = jax.lax.associative_scan(
                comb, (a, M_ts, M_js), axis=1
            )
        cm = _shift_right(cm, NEG)
        D_ts = _shift_right(cm_ts, 0)
        D_js = _shift_right(cm_js, 0)
        cdd_prev = _shift_right(prof.cdd[None, :], 0.0)
        D = jnp.where(in_model, cm + cdd_prev, neg)

        # per-column best-M tracking — pure elementwise updates; the final
        # over-columns reduction happens once, after the scan
        better = M > state["bV"]
        bV = jnp.where(better, M, state["bV"])
        bV_ts = jnp.where(better, M_ts, state["bV_ts"])
        bV_js = jnp.where(better, M_js, state["bV_js"])
        bV_t = jnp.where(better, jnp.int32(t), state["bV_t"])

        new_state = dict(
            M=M, I=I, D=D, M_ts=M_ts, M_js=M_js, I_ts=I_ts, I_js=I_js,
            D_ts=D_ts, D_js=D_js, bV=bV, bV_ts=bV_ts, bV_js=bV_js, bV_t=bV_t,
        )
        return new_state, None

    state, _ = jax.lax.scan(step, init, jnp.arange(T))
    endj = jnp.argmax(state["bV"], axis=1)
    pick = lambda a: jnp.take_along_axis(a, endj[:, None], 1)[:, 0]
    return HmmHits(
        score=pick(state["bV"]),
        seq_from=pick(state["bV_ts"]),
        seq_to=pick(state["bV_t"]),
        hmm_from=pick(state["bV_js"]),
        hmm_to=endj.astype(jnp.int32) + 1,
    )


@functools.partial(jax.jit, static_argnames=("delete_band",))
def viterbi_scores(
    prof: DeviceProfile,
    seqs: jax.Array,
    lengths: jax.Array,
    model_len,             # traced scalar
    delete_band: int = 16,
) -> jax.Array:
    """Scores-only Viterbi sweep (no envelope carrying): ~3x fewer ops per
    cell than viterbi_scan. The driver uses it as a first pass over all
    windows and re-runs the full scan only on windows above threshold
    (models/nhmmer.py)."""
    B, T = seqs.shape
    Lp = prof.msc.shape[0]
    jcol = jax.lax.broadcasted_iota(jnp.int32, (B, Lp), 1)
    in_model = jcol < model_len
    neg = jnp.float32(NEG)
    msc_t = prof.msc.T
    isc_t = prof.isc.T

    def step(state, t):
        M0, I0, D0, best = state
        x = seqs[:, t].astype(jnp.int32)
        x_valid = jnp.logical_and(x < 4, t < lengths)
        oh = jax.nn.one_hot(jnp.clip(x, 0, 3), 4, dtype=jnp.float32)
        em = jnp.where(x_valid[:, None], _select(oh, msc_t), neg)
        ei = jnp.where(x_valid[:, None], _select(oh, isc_t), neg)
        Mp = _shift_right(M0, NEG)
        Ip = _shift_right(I0, NEG)
        Dp = _shift_right(D0, NEG)
        arr = jnp.maximum(
            jnp.maximum(prof.entry, Mp + prof.tmm[None, :]),
            jnp.maximum(Ip + prof.tim[None, :], Dp + prof.tdm[None, :]),
        )
        M = jnp.where(in_model, em + arr, neg)
        I = jnp.where(
            in_model,
            ei + jnp.maximum(M0 + prof.tmi[None, :], I0 + prof.tii[None, :]),
            neg,
        )
        a = jnp.where(in_model, M + prof.tmd[None, :] - prof.cdd[None, :], neg)
        cm = a
        shift = 1
        while shift < max(delete_band, 2):
            cm = jnp.maximum(
                cm,
                jnp.concatenate(
                    [jnp.full((B, shift), NEG), cm[:, :-shift]], axis=1
                ),
            )
            shift *= 2
        cm = _shift_right(cm, NEG)
        cdd_prev = _shift_right(prof.cdd[None, :], 0.0)
        D = jnp.where(in_model, cm + cdd_prev, neg)
        best = jnp.maximum(best, jnp.max(M, axis=1))
        return (M, I, D, best), None

    init = (
        jnp.full((B, Lp), neg), jnp.full((B, Lp), neg), jnp.full((B, Lp), neg),
        jnp.full((B,), neg),
    )
    (_, _, _, best), _ = jax.lax.scan(step, init, jnp.arange(T))
    return best


def stack_profiles(profs: "list[DeviceProfile]") -> DeviceProfile:
    """Stack same-shape staged profiles along a leading model axis for the
    vmapped multi-model scan (all tRNA filter models share the 128 bucket)."""
    assert len({p.msc.shape for p in profs}) == 1, "profiles must share a shape bucket"
    return DeviceProfile(
        *[jnp.stack([getattr(p, f) for p in profs]) for f in DeviceProfile._fields[:-1]],
        profs[0].length,
    )


@functools.partial(jax.jit, static_argnames=("delete_band",))
def viterbi_scores_multi(
    profs: DeviceProfile,     # arrays stacked on a leading model axis [M, ...]
    model_lens: jax.Array,    # [M]
    seqs: jax.Array,          # [B, T] shared windows
    lengths: jax.Array,       # [B]
    delete_band: int = 16,
) -> jax.Array:
    """[M, B] best scores: every model scans every window in one call —
    replaces M sequential scans (the 22-model tRNA filter sweep)."""

    def one(msc, isc, tmm, tim, tdm, tmi, tii, tmd, cdd, entry, mlen):
        # the .length metadata field is unused by the kernel (model_len is
        # the traced per-model argument)
        prof = DeviceProfile(msc, isc, tmm, tim, tdm, tmi, tii, tmd, cdd,
                             entry, 0)
        return viterbi_scores(prof, seqs, lengths, mlen, delete_band)

    return jax.vmap(one)(
        profs.msc, profs.isc, profs.tmm, profs.tim, profs.tdm,
        profs.tmi, profs.tii, profs.tmd, profs.cdd, profs.entry, model_lens,
    )


def evalue(score_bits: np.ndarray, mu: float, lam: float, n_targets: float) -> np.ndarray:
    """Gumbel tail: P(S >= x) ~= exp(-lambda * (x - mu)); E = n * P."""
    z = np.clip(-lam * (np.asarray(score_bits, dtype=np.float64) - mu), -700, 700)
    p = np.exp(z)
    return np.minimum(n_targets * p, n_targets)


def null2_bias_bits(
    seqs: np.ndarray, seq_from: np.ndarray, seq_to: np.ndarray,
    omega_bits: float = 3.0,
) -> np.ndarray:
    """Composition-bias (null2) score correction in bits, host-side.

    HMMER discounts alignments of biased-composition targets by scoring a
    second null hypothesis from the aligned region's residue composition
    and combining it with null1 under a prior ``omega`` (p7_null2 /
    p7_domaindef semantics; nhmmer applies it per envelope). This is the
    envelope-composition approximation of that correction:

        n2   = sum_b count_b * log2(f_b / 0.25),  f plus-one smoothed,
        corr = log2(1 + 2^(n2 - omega_bits))      (omega = 2^-omega_bits)

    ``n2`` is the log-odds of the envelope under its own composition vs
    the flat DNA background — zero for balanced composition, large for
    low-complexity runs (poly-A etc.). Subtract the returned value from
    the kernel score (models/nhmmer.py does). N/pad codes are excluded.

    seqs: [B, T] int8 codes; seq_from/seq_to: [B] 0-based inclusive
    envelope bounds. Returns [B] float64 bits (>= 0)."""
    seqs = np.asarray(seqs)
    B, T = seqs.shape
    sf = np.clip(np.asarray(seq_from, np.int64), 0, T - 1)
    st = np.clip(np.asarray(seq_to, np.int64), 0, T - 1)
    col = np.arange(T)[None, :]
    in_env = (col >= sf[:, None]) & (col <= st[:, None])
    counts = np.stack(
        [((seqs == b) & in_env).sum(axis=1) for b in range(4)], axis=1
    ).astype(np.float64)                                   # [B, 4]
    n = counts.sum(axis=1, keepdims=True)
    f = (counts + 1.0) / (n + 4.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        n2 = np.where(counts > 0, counts * np.log2(f / 0.25), 0.0).sum(axis=1)
    n2 = np.maximum(n2, 0.0)
    return np.log1p(np.exp2(np.minimum(n2 - omega_bits, 500.0))) / np.log(2.0)


def length_correction_bits(target_len, ali_len) -> np.ndarray:
    """HMMER's NJC length-model score correction, in bits (host-side).

    The core Viterbi kernel scores the ALIGNED region only (uniform local
    entry, free exit, flat background). HMMER's reported bit score
    additionally charges the special states and credits the null model,
    both parameterized by the target length L (p7_profile_SetLength /
    p7_bg_SetLength semantics, multihit mode):

    - each unaligned residue loops in N or C at probability L/(L+3)
      (emissions cancel against null1),
    - the N->B and C->T moves each cost log(3/(L+3)), the E->C move
      log(1/2),
    - the null1 length score L*log(L/(L+1)) + log(1/(L+1)) is subtracted.

    Single-hit assumption (no J-state passes), which is what the pipeline's
    per-window consumers see. Apply as ``score + length_correction_bits``.
    Vectorized over numpy inputs; target_len is the scanned window length,
    ali_len the alignment span (seq_to - seq_from + 1)."""
    Lw = np.maximum(np.asarray(target_len, np.float64), 1.0)
    d = np.clip(np.asarray(ali_len, np.float64), 0.0, Lw)
    ln = np.log
    special = (
        (Lw - d) * ln(Lw / (Lw + 3.0))
        + 2.0 * ln(3.0 / (Lw + 3.0))
        + ln(0.5)
    )
    null1 = Lw * ln(Lw / (Lw + 1.0)) + ln(1.0 / (Lw + 1.0))
    return (special - null1) / ln(2.0)
