"""Device (JAX) banded CYK — the rRNA rescore's hot loop.

The host-numpy banded CYK (ops/cyk.py cyk_banded) costs ~0.75 s per rRNA
window at CLEN ~1000 (2965 states x ~200 us of Python/numpy overhead per
state). This module is the same DP as ONE compiled XLA program: a
``lax.scan`` over states in decreasing index (children always have larger
indices in the Infernal numbering), carrying the whole banded deck
[S, W, W] and updating one state's block per step.

Device-shaped choices (vs a literal translation of the numpy loop):

- **Uniform band width** ``W = 2*slack + 2`` for every state. Band
  origins are clamped into ``[0, L+1-W]`` so each block always covers
  its numpy counterpart (which shrinks at window edges); banded scores
  are therefore >= the numpy kernel's and <= the exact CYK's, and equal
  to exact whenever the bands contain the optimal parse (tested).
- **Child fetch = roll + mask, no gather.** A child's block is aligned
  to its parent's band by a 2-D ``jnp.roll`` with the precomputed origin
  offset, wraparound masked to NEG. Offsets are tiny by construction:
  guide-tree subtrees are contiguous consensus intervals, so a child's
  band center differs from its parent's by at most a couple of consensus
  positions (bifurcation split points coincide exactly).
- **Emissions as one-hot matmuls** at HIGHEST precision (exact selects):
  em = onehot(window) @ emit_single, pair blocks = (oh_i @ P) @ oh_j^T.
- **IL/IR self-loops as reverse cummax**, not a sequential sweep: the
  recurrence blk[i] = max(blk[i], d[i] + blk[i+1]) unrolls to
  blk'[i] = max_{k>=i}(g[k] + blk[k]) - g[i] with g = prefix-sum(d),
  i.e. one ``lax.cummax``. Invalid-residue d is clipped at -3e4 so the
  prefix sums stay in float32 range (any such path is dead anyway).
- **Bifurcations via lax.cond**: the [W, W, W] max-plus join runs only
  on the ~1% of states that are B states.

Scores-only (like the numpy banded kernel): the rRNA consumers need
coordinates + bit score, never a traceback (models/cmsearch.py
_cyk_banded_refine). Reference replaced: Infernal cmsearch's HMM-banded
CYK stage (annotation_tookit.py:485-507 shells out to it per rRNA).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np

from ..models import cm as cm_models
from ..models.cm import B, D, E, IL, IR, ML, MP, MR, S
from .cyk import NEG, CykAlignment, node_subtree_spans

MAX_KIDS = 6
_DEAD = -3.0e4          # clipped self-loop step for invalid residues


def _kernel(n_scan: int, W: int, R: int):
    """Build the jitted scan kernel for (state count, band width, one-hot
    rows). Cached per shape — the one-hot row count R is bucketed to 512
    so window length only affects masks (traced scalar), not compiles."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    iota = jnp.arange(W, dtype=jnp.int32)

    def roll_fetch(deck, c, di, dj):
        """Child c's block aligned to the parent band: out[r, m] =
        deck[c, r + di, m + dj], NEG where that index leaves [0, W)."""
        child = lax.dynamic_slice(deck, (c, 0, 0), (1, W, W))[0]
        rolled = jnp.roll(child, (-di, -dj), axis=(0, 1))
        okr = (iota + di >= 0) & (iota + di < W)
        okc = (iota + dj >= 0) & (iota + dj < W)
        return jnp.where(okr[:, None] & okc[None, :], rolled, NEG)

    def step(carry, x):
        deck, OHV, L, el_selfsc, oij = carry
        o_i = oij[:, 0]
        o_j = oij[:, 1]
        # band origins are looked up in-kernel from the [S] origin arrays
        # so the per-state offset tables never cross the host link (one
        # transfer per call instead of ~20)
        oiv = o_i[x["v"]]
        ojv = o_j[x["v"]]

        def b_branch(_):
            lb = roll_fetch(deck, x["bl"], oiv - o_i[x["bl"]], 0)
            rb = roll_fetch(deck, x["br"], o_j[x["bl"]] - o_i[x["br"]],
                            ojv - o_j[x["br"]])
            return (lb[:, :, None] + rb[None, :, :]).max(axis=1)

        def reg_branch(_):
            kind = x["kind"]
            si = jnp.where((kind == 1) | (kind == 3), 1, 0)
            sj = jnp.where((kind == 2) | (kind == 3), 1, 0)
            blk = jnp.full((W, W), NEG, jnp.float32)
            for k in range(MAX_KIDS):
                c = x["kid"][k]
                cand = roll_fetch(
                    deck, c, oiv + si - o_i[c], ojv - sj - o_j[c]
                ) + x["kid_t"][k]
                blk = jnp.maximum(blk, cand)
            # local END pseudo-child: EL emits the remaining span at
            # el_selfsc bits per residue (end_sc = NEG disables)
            el_i = oiv + si + iota[:, None]
            el_j = ojv - sj + iota[None, :]
            el = jnp.where(
                (el_j >= el_i) & (el_i >= 0) & (el_j <= L),
                (el_j - el_i).astype(jnp.float32) * el_selfsc,
                NEG,
            )
            blk = jnp.maximum(blk, el + x["end_sc"])
            # emissions via one-hot matmuls (row i = o_i + r, col j-1 =
            # o_j + c - 1; OHV carries a leading zero row so starts
            # stay >= 0; column 4 is the residue-validity flag)
            ohvi = lax.dynamic_slice(OHV, (oiv + 1, 0), (W, 5))
            ohvj = lax.dynamic_slice(OHV, (ojv, 0), (W, 5))
            ohi, vai = ohvi[:, :4], ohvi[:, 4] > 0.5
            ohj, vaj = ohvj[:, :4], ohvj[:, 4] > 0.5
            # one-hot selects single f32 values: force full-precision
            # matmuls (a reduced-precision default would perturb bit scores)
            hp = partial(jnp.matmul, precision=lax.Precision.HIGHEST)
            em_i = jnp.where(vai, hp(ohi, x["emit_single"]), NEG)
            em_j = jnp.where(vaj, hp(ohj, x["emit_single"]), NEG)
            em_p = jnp.where(
                vai[:, None] & vaj[None, :],
                hp(hp(ohi, x["emit_pair"].reshape(4, 4)), ohj.T),
                NEG,
            )
            add = jnp.where(
                kind == 1, em_i[:, None] + jnp.zeros((W, W), jnp.float32),
                jnp.where(
                    kind == 2, em_j[None, :] + jnp.zeros((W, W), jnp.float32),
                    jnp.where(kind == 3, em_p, 0.0),
                ),
            )
            blk = blk + add
            # self-loops: reverse/forward cummax with prefix-sum offsets
            has_self = x["self_t"] > NEG / 2
            d_i = jnp.maximum(em_i + x["self_t"], _DEAD)
            g = jnp.concatenate([jnp.zeros(1, jnp.float32),
                                 jnp.cumsum(d_i)[:-1]])
            il_blk = lax.cummax(blk + g[:, None], axis=0, reverse=True) \
                - g[:, None]
            d_j = jnp.maximum(em_j + x["self_t"], _DEAD)
            G = jnp.cumsum(d_j)
            ir_blk = lax.cummax(blk - G[None, :], axis=1) + G[None, :]
            blk = jnp.where(
                (kind == 1) & has_self, il_blk,
                jnp.where((kind == 2) & has_self, ir_blk, blk),
            )
            return blk

        blk = lax.cond(x["is_b"], b_branch, reg_branch, None)
        # span validity: j >= i within the real window
        ii = oiv + iota[:, None]
        jj = ojv + iota[None, :]
        valid = (jj >= ii) & (ii <= L) & (jj <= L)
        blk = jnp.where(valid, jnp.maximum(blk, NEG), NEG)
        deck = lax.dynamic_update_slice(deck, blk[None], (x["v"], 0, 0))
        return (deck, OHV, L, el_selfsc, oij), None

    @partial(jax.jit, static_argnames=("Sn",))
    def run(Sn, oij, is_e, xs, OHV, L, el_selfsc):
        # build the E-initialized deck ON DEVICE rather than shipping a
        # [S, W, W] host deck through the host-to-device copy
        ii = oij[:, 0, None, None] + iota[None, :, None]
        jj = oij[:, 1, None, None] + iota[None, None, :]
        deck0 = jnp.where(
            is_e[:, None, None] & (ii == jj) & (jj <= L),
            0.0, NEG,
        ).astype(jnp.float32)
        (deck, *_), _ = lax.scan(
            step, (deck0, OHV, L, el_selfsc, oij), xs, length=n_scan,
        )
        flat = deck.reshape(Sn, W * W)
        return flat.max(axis=1), flat.argmax(axis=1)

    return run


_KERNELS: dict = {}


def _get_kernel(n_scan: int, W: int, R: int):
    key = (n_scan, W, R)
    if key not in _KERNELS:
        _KERNELS[key] = _kernel(n_scan, W, R)
    return _KERNELS[key]


_STATIC: dict = {}


def _model_static(model, local):
    """Anchor/window-independent scan tables, cached per (model, mode).
    Keyed by id() with a weakref guard: if the original model was
    collected and a new one reuses its id, the stale entry is rebuilt
    instead of silently mis-scoring."""
    import weakref

    key = (id(model), local)
    hit = _STATIC.get(key)
    if hit is not None and hit["ref"]() is model:
        return hit
    Sn = model.n_states
    stype, cfirst, cnum = model.stype, model.cfirst, model.cnum
    trans = model.trans.astype(np.float32)
    lc = cm_models.local_config(model) if local else None
    if local:
        trans = trans + lc.trans_adj[:, None]

    spans = node_subtree_spans(model)
    span_arr = np.asarray(spans, np.int64)            # [nodes, 2]
    cl = span_arr[model.node_of, 0].astype(np.float64)
    cr = span_arr[model.node_of, 1].astype(np.float64)
    is_e = (stype == E).astype(bool)

    kind_of = {S: 0, D: 0, ML: 1, IL: 1, MR: 2, IR: 2, MP: 3}

    order = np.asarray(
        [v for v in range(Sn - 1, -1, -1) if stype[v] != E], np.int32
    )
    n = len(order)
    xs = {
        "v": order.copy(),
        "kind": np.zeros(n, np.int32),
        "is_b": np.zeros(n, bool),
        "kid": np.zeros((n, MAX_KIDS), np.int32),
        "kid_t": np.full((n, MAX_KIDS), NEG, np.float32),
        "self_t": np.full(n, NEG, np.float32),
        "end_sc": np.full(n, NEG, np.float32),
        "emit_single": model.emit_single[order].astype(np.float32),
        "emit_pair": model.emit_pair[order].astype(np.float32),
        "bl": np.zeros(n, np.int32),
        "br": np.zeros(n, np.int32),
    }
    for t, v in enumerate(order):
        st = int(stype[v])
        if st == B:
            xs["is_b"][t] = True
            xs["bl"][t], xs["br"][t] = int(cfirst[v]), int(cnum[v])
            continue
        xs["kind"][t] = kind_of[st]
        slot = 0
        for ci_ in range(int(cnum[v])):
            c = int(cfirst[v]) + ci_
            if c == v:
                xs["self_t"][t] = float(trans[v, ci_])
                continue
            xs["kid"][t][slot] = c
            xs["kid_t"][t][slot] = float(trans[v, ci_])
            slot += 1
    if local:
        keep = lc.end_sc[order] > NEG / 2
        xs["end_sc"][keep] = lc.end_sc[order][keep]
    # park the scan tables on device ONCE — they are reused verbatim by
    # every call on this model, so they never cross the host link again
    import jax.numpy as jnp

    xs_dev = {k: jnp.asarray(v) for k, v in xs.items()}
    static = dict(xs=xs_dev, cl=cl, cr=cr, is_e=jnp.asarray(is_e),
                  lc=lc, spans=spans, order=order, n_scan=n,
                  ref=weakref.ref(model))
    # sweep entries whose model was collected (they pin device arrays)
    dead = [k for k, v in _STATIC.items() if v["ref"]() is None]
    for k in dead:
        del _STATIC[k]
    _STATIC[key] = static
    return static


def _precompute(model, window, anchor, slack, local):
    """Band geometry + scan inputs: cached device-resident model tables,
    vectorized per-call origin math. Only the [S] origin arrays and the
    window one-hot cross the host link per call — the in-kernel origin
    lookups reconstruct every alignment offset from them."""
    L = len(window)
    W = 2 * slack + 2
    st = _model_static(model, local)
    lc = st["lc"]

    w0, w1, p0, p1 = anchor
    rate = (w1 - w0) / max(p1 - p0, 1)
    omax = max(0, L + 1 - W)
    o_i = np.clip(np.floor(w0 + (st["cl"] - p0) * rate) - slack,
                  0, omax).astype(np.int32)
    o_j = np.clip(np.floor(w0 + (st["cr"] - p0) * rate) - slack,
                  0, omax).astype(np.int32)

    # bifurcation sanity: the roll alignment cannot bridge bands further
    # apart than the block width (contiguous splits keep offsets tiny;
    # this can only trip on a degenerate anchor)
    order = st["order"]
    xs = st["xs"]
    bb = np.asarray(xs["is_b"])
    if bb.any():
        bl = np.asarray(xs["bl"])[bb]
        br = np.asarray(xs["br"])[bb]
        vb = order[bb]
        worst = max(
            np.abs(o_i[vb] - o_i[bl]).max(),
            np.abs(o_j[bl] - o_i[br]).max(),
            np.abs(o_j[vb] - o_j[br]).max(),
        )
        if worst >= W:
            raise ValueError("bifurcation band offset exceeds width")

    # one-hot window with a leading zero row (so o_j - 1 + 1 >= 0), a
    # validity column, and rows padded to a 512 bucket — R is a SHAPE, so
    # without bucketing every distinct window length would recompile the
    # scan
    R = W + 2 + 512 * ((L + 511) // 512)
    OHV = np.zeros((R, 5), np.float32)
    okw = window < 4
    OHV[1 : L + 1, :4][okw] = np.eye(4, dtype=np.float32)[
        np.clip(window[okw], 0, 3)
    ]
    OHV[1 : L + 1, 4] = okw
    el = float(lc.el_selfsc) if local else 0.0
    return st, xs, OHV, o_i, o_j, el, lc


def cyk_banded_device(
    model: cm_models.CovarianceModel,
    window: np.ndarray,
    anchor: Tuple[int, int, int, int],
    slack: int = 48,
    local: bool = False,
) -> Optional[CykAlignment]:
    """Drop-in device counterpart of ops/cyk.py:cyk_banded (same anchor /
    slack / local semantics, scores + coords only). Bands are uniform
    width and clamped inside the window, so they always contain the numpy
    kernel's bands: score(numpy banded) <= score(device) <= score(exact).
    """
    window = np.asarray(window)
    L = len(window)
    st, xs, OHV, o_i, o_j, el, lc = _precompute(
        model, window, anchor, slack, local
    )
    spans = st["spans"]
    W = 2 * slack + 2
    run = _get_kernel(st["n_scan"], W, OHV.shape[0])
    import jax.numpy as jnp

    m, a = run(
        model.n_states,
        jnp.asarray(np.stack([o_i, o_j], axis=1)),
        st["is_e"], xs, jnp.asarray(OHV),
        jnp.int32(L), jnp.float32(el),
    )
    m = np.asarray(m)
    a = np.asarray(a)

    if local:
        begins = lc.begin_sc.copy()
    else:
        begins = np.full(model.n_states, NEG, np.float32)
        begins[0] = 0.0
    tot = m + begins
    bv = int(np.argmax(tot))
    best = float(tot[bv])
    ri, rj = divmod(int(a[bv]), W)
    bi = int(o_i[bv]) + ri
    bj = int(o_j[bv]) + rj
    if best < NEG / 2 or bj <= bi:
        return None
    if local:
        bspan = spans[int(model.node_of[bv])]
        mdl_from, mdl_to = bspan[0] + 1, bspan[1]
        # same truncation clamp as the numpy kernel: when the hit runs
        # into the window's right edge the EL state absorbed the model
        # suffix, so cap coverage at the p7 envelope's hmm_to
        if bj >= L and mdl_to > anchor[3] + 1:
            mdl_to = anchor[3] + 1
    else:
        mdl_from, mdl_to = 1, model.clen
    return CykAlignment(
        score=best, seq_from=bi, seq_to=bj - 1,
        aligned_seq="", aligned_fold="",
        mdl_from=mdl_from, mdl_to=mdl_to, residue_of_pos={},
    )
