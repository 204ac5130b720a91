"""De Bruijn graph construction and unitig extraction as XLA passes.

Device replacement for megahit_core's ``seq2sdbg`` + ``assemble`` stages
(reference assemble/assemble_wrapper.py:203-315): instead of a succinct
BWT-based sDBG built by C++/CUDA code, the graph is a pair of sorted edge
arrays over dense int32 node ids:

- edges are solid (k+1)-mers (multi-word packed keys from ops/kmer.py) with
  multiplicities, present in BOTH orientations (each read contributed its
  forward and reverse-complement k-mers), so the graph is explicitly
  bidirected and traversal needs no canonical-form branching;
- nodes are the unique k-mer prefixes/suffixes of edges, given dense ids by
  a multi-word sort-unique; edge endpoint resolution is a vectorized
  multi-word binary search (a sorted-array join in place of the
  sDBG's rank/select);
- unitigs (maximal unbranched paths) are extracted by parallel pointer
  doubling (list ranking) over predecessor links — O(log V) gather rounds —
  including cycle detection, which directly identifies circular contigs
  (the mitogenome case);
- tip clipping / low-depth pruning (megahit --prune-level analog) runs as a
  host-driven fixpoint over this pass (stages/assemble.py), each round a
  single device call.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import kmer as kmer_ops

BASES_PER_WORD = kmer_ops.BASES_PER_WORD


def edge_prefix_suffix(edge_words: List[jax.Array], k: int):
    """Split (k+1)-mer keys into k-mer prefix and suffix keys.

    Keys are left-aligned (ops/kmer.py), so the prefix is the same bit
    pattern with base index k zeroed, and the suffix is a 2-bit left shift
    across words (old base k lands at index k-1; higher positions were
    already zero).
    """
    W = len(edge_words)
    kw, kt = divmod(k, BASES_PER_WORD)
    shift = 2 * (BASES_PER_WORD - 1 - kt)
    mask = jnp.uint32(0xFFFFFFFF) ^ (jnp.uint32(0x3) << shift)
    prefix = [w if i != kw else (w & mask) for i, w in enumerate(edge_words)]
    suffix = []
    for i in range(W):
        hi = edge_words[i] << 2
        lo = (edge_words[i + 1] >> 30) if i + 1 < W else jnp.uint32(0)
        suffix.append(hi | lo)
    return prefix, suffix


class GraphPass(NamedTuple):
    """Result of one graph+unitig device pass (all fixed capacity).

    Node arrays have capacity Vcap = 2 * Ecap; valid rows < n_nodes.
    """

    node_words: List[jax.Array]   # [Vcap] x W — sorted unique k-mer per node
    n_nodes: jax.Array            # scalar int32
    out_deg: jax.Array            # [Vcap] int32
    in_deg: jax.Array             # [Vcap] int32
    root: jax.Array               # [Vcap] int32 — unitig id (start-node index)
    offset: jax.Array             # [Vcap] int32 — position within unitig
    link_count: jax.Array         # [Vcap] uint32 — multiplicity of edge prev->v (0 at starts)
    is_cycle: jax.Array           # [Vcap] bool — node is on a cyclic (circular) unitig
    prefix_id: jax.Array          # [Ecap] int32 — edge endpoint node ids
    suffix_id: jax.Array          # [Ecap] int32
    edge_valid: jax.Array         # [Ecap] bool
    # optional, host passes only: nodes pre-sorted by (root, offset) — the
    # chain order unitig_set_from_pass otherwise lexsorts for
    order: object = None          # Optional[np.ndarray [V] int32]


@functools.partial(jax.jit, static_argnames=("k",))
def graph_unitig_pass(
    edge_words: List[jax.Array], edge_counts: jax.Array, n_edges: jax.Array, k: int
) -> GraphPass:
    """Build the node table, degrees, and unitig labeling for an edge set.

    edge_words: W arrays [Ecap] uint32, first n_edges rows valid (rest
    arbitrary). edge_counts: [Ecap] uint32 multiplicities.
    """
    Ecap = edge_counts.shape[0]
    Vcap = 2 * Ecap
    eidx = jax.lax.broadcasted_iota(jnp.int32, (Ecap, 1), 0).squeeze(-1)
    evalid = eidx < n_edges

    prefix, suffix = edge_prefix_suffix(edge_words, k)
    cat = [jnp.concatenate([p, s]) for p, s in zip(prefix, suffix)]
    cat_valid = jnp.concatenate([evalid, evalid])
    # gather-free unique + sort-join (a binary-search join gathers once
    # per iteration)
    node_words, n_nodes = kmer_ops.unique_words_device(cat, cat_valid)

    both_id = kmer_ops.multiword_join_sorted(node_words, n_nodes, cat)
    prefix_id, suffix_id = both_id[:Ecap], both_id[Ecap:]
    prefix_id = jnp.where(evalid, prefix_id, Vcap - 1)
    suffix_id = jnp.where(evalid, suffix_id, Vcap - 1)

    ones = jnp.where(evalid, 1, 0)
    out_deg = jax.ops.segment_sum(ones, prefix_id, num_segments=Vcap)
    in_deg = jax.ops.segment_sum(ones, suffix_id, num_segments=Vcap)
    vidx = jax.lax.broadcasted_iota(jnp.int32, (Vcap, 1), 0).squeeze(-1)
    nvalid = vidx < n_nodes
    # padding rows got the dumped invalid edges — zero them
    out_deg = jnp.where(nvalid, out_deg, 0)
    in_deg = jnp.where(nvalid, in_deg, 0)

    # --- unique predecessor per node (when in_deg == 1) ------------------
    # sort edges by suffix (int32 key); the first edge of each suffix run is
    # the unique in-edge when in_deg == 1.
    s_suf, s_pre, s_cnt = jax.lax.sort(
        [suffix_id, prefix_id, edge_counts], num_keys=1
    )
    first_in = jnp.searchsorted(s_suf, vidx)  # [Vcap]
    safe = jnp.clip(first_in, 0, Ecap - 1)
    pred = jnp.where(in_deg == 1, s_pre[safe], vidx)
    pred_cnt = jnp.where(in_deg == 1, s_cnt[safe], 0)

    # linkable(p -> v): in_deg[v]==1, out_deg[p]==1, p != v
    p_safe = jnp.clip(pred, 0, Vcap - 1)
    linkable = jnp.logical_and(
        jnp.logical_and(in_deg == 1, out_deg[p_safe] == 1), pred != vidx
    )
    linkable = jnp.logical_and(linkable, nvalid)
    prev = jnp.where(linkable, pred, vidx)
    link_count = jnp.where(linkable, pred_cnt, 0).astype(jnp.uint32)

    iters = max(1, math.ceil(math.log2(Vcap + 1)))
    # dist clamp: keeps cycle distances (which double every round, 2^iters
    # >= Vcap+1) from overflowing int32 while staying >= any chain length
    dist_cap = jnp.int32(min(Vcap, 1 << 30))

    def rank(prev0):
        jump = prev0
        dist = jnp.where(jump != vidx, 1, 0)
        minid = vidx

        def body(_, state):
            jump, dist, minid = state
            dist = jnp.minimum(dist + dist[jump], dist_cap)
            minid = jnp.minimum(minid, minid[jump])
            jump = jump[jump]
            return jump, dist, minid

        return jax.lax.fori_loop(0, iters, body, (jump, dist, minid))

    jump, dist, minid = rank(prev)
    # cycle test by DISTANCE, not jump[jump] != jump: a chain node's dist
    # is its (< n_nodes) distance to the fixed-point root, while a cycle
    # node's dist doubles every round to >= Vcap+1 (clamped to dist_cap
    # >= n_nodes). The jump-fixed-point test is degenerate when the cycle
    # length divides 2^iters (e.g. a circular genome of exactly 2^m
    # distinct k-mers): jump converges to the identity, the cycle went
    # undetected, and the circular unitig shattered into singletons.
    on_cycle = dist >= n_nodes
    # break cycles at their minimum node, then re-rank
    is_break = jnp.logical_and(on_cycle, vidx == minid)
    prev2 = jnp.where(is_break, vidx, prev)
    link_count = jnp.where(is_break, 0, link_count)
    jump, dist, _ = rank(prev2)

    return GraphPass(
        node_words=node_words,
        n_nodes=n_nodes,
        out_deg=out_deg,
        in_deg=in_deg,
        root=jump,
        offset=dist,
        link_count=link_count,
        is_cycle=on_cycle,
        prefix_id=prefix_id,
        suffix_id=suffix_id,
        edge_valid=evalid,
    )


def graph_unitig_pass_host(
    keys: np.ndarray, counts: np.ndarray, k: int
) -> GraphPass:
    """Host graph pass for the CPU backend (k <= 32 so node k-mers pack
    into uint64): XLA:CPU's variadic sorts and 2Vcap-padded arrays run
    the device formulation ~10x slower than plain numpy on the same
    host. Output arrays satisfy the same GraphPass contract (dense ids
    over the SORTED unique node table, so ids — and everything derived
    from them — match the device pass exactly); capacities are exact
    (Ecap = E, Vcap = V) instead of padded.

    Dispatches to the native O(E+V) pass (native/graph.cpp: one radix
    sort + merge joins + a serial chain walk — each node's pointer chased
    once, vs the numpy mirror's O(V log V) gather rounds; ~20x at the
    10M-edge scale) and falls back to the numpy mirror below when the
    native library is unavailable (oracle parity in tests/test_native.py).

    keys: [E, W] uint32 valid rows only; counts: [E].
    """
    E, W = keys.shape
    assert W <= 2, "host graph pass requires k <= 32"
    from ..native import graph_native

    nat = graph_native.graph_pass(keys, counts, k)
    if nat is not None:
        (node_words, V, out_deg, in_deg, root, offset, link_count,
         is_cycle, prefix_id, suffix_id, order) = nat
        return GraphPass(
            node_words=[node_words[:, w] for w in range(W)],
            n_nodes=V, out_deg=out_deg, in_deg=in_deg, root=root,
            offset=offset, link_count=link_count, is_cycle=is_cycle,
            prefix_id=prefix_id, suffix_id=suffix_id,
            edge_valid=np.ones(E, bool), order=order,
        )
    return graph_unitig_pass_numpy(keys, counts, k)


def graph_unitig_pass_numpy(
    keys: np.ndarray, counts: np.ndarray, k: int
) -> GraphPass:
    """Pure-numpy fallback (and oracle for the native pass): pointer
    doubling over packed uint64 node keys. O(V log V) gather rounds —
    correct everywhere, ~20x slower than native/graph.cpp at 10M edges."""
    E, W = keys.shape
    assert W <= 2, "host graph pass requires k <= 32"
    # prefix = zero base k; suffix = 2-bit left shift (same layout rules
    # as edge_prefix_suffix, on packed uint64)
    p64 = kmer_ops.np_pack64(keys)
    kw, kt = divmod(k, BASES_PER_WORD)
    shift = np.uint64(2 * (BASES_PER_WORD - 1 - kt) + (32 if kw == 0 else 0))
    pref = p64 & ~(np.uint64(0x3) << shift)
    # left-shift across the pack; bases beyond k+1 are already zero
    suf = p64 << np.uint64(2)
    both = np.concatenate([pref, suf])
    nodes64 = np.unique(both)
    V = len(nodes64)
    prefix_id = np.searchsorted(nodes64, pref).astype(np.int32)
    suffix_id = np.searchsorted(nodes64, suf).astype(np.int32)
    out_deg = np.bincount(prefix_id, minlength=V).astype(np.int32)
    in_deg = np.bincount(suffix_id, minlength=V).astype(np.int32)

    # unique predecessor (exact where in_deg == 1: single write wins)
    vidx = np.arange(V, dtype=np.int32)
    in1 = np.full(V, -1, np.int32)
    in1[suffix_id] = prefix_id
    cnt1 = np.zeros(V, np.uint32)
    cnt1[suffix_id] = np.minimum(counts, 0xFFFFFFFF).astype(np.uint32)
    pred = np.where(in_deg == 1, in1, vidx)
    pred_cnt = np.where(in_deg == 1, cnt1, 0).astype(np.uint32)
    linkable = (in_deg == 1) & (out_deg[np.clip(pred, 0, V - 1)] == 1) \
        & (pred != vidx)
    prev = np.where(linkable, pred, vidx).astype(np.int64)
    link_count = np.where(linkable, pred_cnt, 0).astype(np.uint32)

    def rank(prev0):
        jump = prev0.copy()
        # int64 dist: cycle distances double every round to 2^it >= V+1
        dist = np.where(jump != vidx, 1, 0).astype(np.int64)
        minid = vidx.astype(np.int64).copy()
        it = max(1, math.ceil(math.log2(V + 1)))
        for _ in range(it):
            dist += dist[jump]
            np.minimum(minid, minid[jump], out=minid)
            jump = jump[jump]
        return jump, dist, minid

    jump, dist, minid = rank(prev)
    # distance-based cycle test (chain dist < V, cycle dist >= V+1) — the
    # jump-fixed-point test misses cycles whose length divides 2^it; see
    # the device pass for the full note (kept in lockstep for parity)
    on_cycle = dist >= V
    is_break = on_cycle & (vidx == minid)
    prev2 = np.where(is_break, vidx, prev)
    link_count = np.where(is_break, 0, link_count)
    jump, dist, _ = rank(prev2)
    dist = dist.astype(np.int32)

    node_words = [
        (nodes64 >> np.uint64(32)).astype(np.uint32),
        (nodes64 & np.uint64(0xFFFFFFFF)).astype(np.uint32),
    ][:kmer_ops.num_words(k)]
    return GraphPass(
        node_words=node_words,
        n_nodes=V,
        out_deg=out_deg,
        in_deg=in_deg,
        root=jump.astype(np.int32),
        offset=dist,
        link_count=link_count,
        is_cycle=on_cycle,
        prefix_id=prefix_id,
        suffix_id=suffix_id,
        edge_valid=np.ones(E, bool),
    )


# ------------------------------------------------------------ host decoding
def decode_node_kmers(node_words: np.ndarray, k: int) -> np.ndarray:
    """[V, W] uint32 → [V, k] int8 base codes (host, vectorized)."""
    V, W = node_words.shape
    out = np.empty((V, k), dtype=np.int8)
    for i in range(k):
        w, t = divmod(i, BASES_PER_WORD)
        out[:, i] = (node_words[:, w] >> (2 * (BASES_PER_WORD - 1 - t))) & 0x3
    return out


class Unitig(NamedTuple):
    seq: str                 # base string (k + len - 1 long)
    depth: float             # mean multiplicity of internal link edges
    circular: bool
    node_ids: np.ndarray     # node indices along the chain (graph order)


class UnitigSet(NamedTuple):
    """Struct-of-arrays unitig table — the production form (the reference's
    megahit_core keeps a UnitigGraph in C++; here the per-unitig layer is
    bulk numpy so a 10M-unitig graph analyzes in seconds, not minutes).

    Strings are decoded lazily (:meth:`seq_str`) — only for contigs that
    survive the depth/length gates and for bubble-candidate comparisons.
    """

    n: int
    seq_codes: np.ndarray    # [total_bases] uint8 base codes (0..3), concatenated
    seq_bounds: np.ndarray   # [n+1] int64 — unitig j's bases are codes[b[j]:b[j+1]]
    depth: np.ndarray        # [n] float64 — mean internal link multiplicity
    circular: np.ndarray     # [n] bool
    chain_nodes: np.ndarray  # [total_nodes] int32 node ids in chain order
    chain_bounds: np.ndarray # [n+1] int64
    node_keys: np.ndarray    # [n_nodes, W] uint32 — sorted node k-mer keys

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.seq_bounds)

    @property
    def chain_counts(self) -> np.ndarray:
        return np.diff(self.chain_bounds)

    @property
    def entry(self) -> np.ndarray:
        return self.chain_nodes[self.chain_bounds[:-1]]

    @property
    def exit(self) -> np.ndarray:
        return self.chain_nodes[self.chain_bounds[1:] - 1]

    def seq_str(self, j: int) -> str:
        codes = self.seq_codes[self.seq_bounds[j] : self.seq_bounds[j + 1]]
        return _DECODE_LUT[codes].tobytes().decode()

    def unitig(self, j: int) -> Unitig:
        return Unitig(
            self.seq_str(j), float(self.depth[j]), bool(self.circular[j]),
            self.chain_nodes[self.chain_bounds[j] : self.chain_bounds[j + 1]],
        )


_DECODE_LUT = np.frombuffer(b"ACGTN", dtype=np.uint8)


def unitig_set_from_pass(gp: GraphPass, k: int) -> UnitigSet:
    """Vectorized unitig extraction: group nodes by root, order by offset,
    assemble base codes in bulk (no per-unitig Python). Each unitig
    appears once per strand; :func:`dedup_strand_mask` picks one.

    When the pass carries a precomputed chain order (native host pass)
    the whole assembly runs as ONE sequential native walk
    (native/graph.cpp mfx_unitig_build) — the numpy bulk path below pays
    ~6 full array passes with fancy-index scatters (~38 s at 40M nodes
    on the throttled host vs seconds native)."""
    n = int(gp.n_nodes)
    node_keys = np.stack([np.asarray(w)[:n] for w in gp.node_words], axis=1)
    if n > 0 and gp.order is not None and node_keys.shape[1] <= 2 and k <= 31:
        from ..native import graph_native

        nat = graph_native.unitig_build(
            np.asarray(gp.order)[:n], np.asarray(gp.offset)[:n],
            np.asarray(gp.link_count)[:n], np.asarray(gp.is_cycle)[:n],
            node_keys, k,
        )
        if nat is not None:
            U, seq_codes, seq_bounds, chain_bounds, depth, circular = nat
            return UnitigSet(U, seq_codes, seq_bounds, depth, circular,
                             np.asarray(gp.order)[:n], chain_bounds,
                             node_keys)
    if n == 0:
        z64 = np.zeros(1, np.int64)
        return UnitigSet(0, np.zeros(0, np.uint8), z64, np.zeros(0),
                         np.zeros(0, bool), np.zeros(0, np.int32), z64,
                         node_keys)
    root = np.asarray(gp.root)[:n]
    offset = np.asarray(gp.offset)[:n]
    link = np.asarray(gp.link_count)[:n].astype(np.float64)
    cyc = np.asarray(gp.is_cycle)[:n]

    if gp.order is not None:
        order = np.asarray(gp.order)[:n]  # native pass pre-sorted the chains
    else:
        order = np.lexsort((offset, root)).astype(np.int32)
    r_sorted = root[order]
    starts = np.flatnonzero(
        np.concatenate([[True], r_sorted[1:] != r_sorted[:-1]])
    )
    counts = np.diff(np.append(starts, n)).astype(np.int64)
    U = len(starts)
    chain_bounds = np.concatenate([[0], np.cumsum(counts)])
    firsts = order[starts]

    # sequence assembly: unitig j spans k + counts[j] - 1 bases; node i>0
    # contributes its last base at position (k-1)+i, node 0 its full k-mer
    seq_lens = counts + (k - 1)
    seq_bounds = np.concatenate([[0], np.cumsum(seq_lens)])
    total = int(seq_bounds[-1])
    seq_codes = np.empty(total, np.uint8)
    w_last, t_last = divmod(k - 1, BASES_PER_WORD)
    last_base = (
        (node_keys[:, w_last] >> (2 * (BASES_PER_WORD - 1 - t_last))) & 0x3
    ).astype(np.uint8)
    # global sorted position g of a node in chain u sits at sequence
    # position g + (k-1)(u+1): one repeat instead of two
    u_of = np.repeat(np.arange(U, dtype=np.int64), counts)
    pos = np.arange(n, dtype=np.int64) + (k - 1) * (u_of + 1)
    seq_codes[pos] = last_base[order]
    # head k-mers: one U-sized scatter per base column (a single [U*k]
    # fancy index would allocate gigabytes of int64 at 10M+ unitigs)
    fk = node_keys[firsts]
    head_starts = seq_bounds[:-1]
    for c in range(k - 1):
        w, t = divmod(c, BASES_PER_WORD)
        seq_codes[head_starts + c] = (
            (fk[:, w] >> (2 * (BASES_PER_WORD - 1 - t))) & 0x3
        ).astype(np.uint8)

    # segment sums via cumsum difference (np.add.reduceat pays per-group
    # ufunc overhead — seconds at 10M groups)
    cs = np.concatenate([[0.0], np.cumsum(link[order])])
    link_sum = cs[chain_bounds[1:]] - cs[chain_bounds[:-1]]
    depth = np.where(counts > 1, link_sum / np.maximum(counts - 1, 1), 0.0)
    return UnitigSet(U, seq_codes, seq_bounds, depth, cyc[firsts],
                     order, chain_bounds, node_keys)


def rc_node_ids(node_keys: np.ndarray, k: int) -> np.ndarray:
    """For each node, the id of its reverse-complement node. The graph
    holds both strands (every edge was counted in both orientations), so
    the RC of every node k-mer is itself a node; the node table is sorted
    by key, so id = searchsorted."""
    n = len(node_keys)
    if n == 0:
        return np.zeros(0, np.int64)
    return _rc_ids_of(node_keys, np.arange(n, dtype=np.int64), k)


def _rc_ids_of(node_keys: np.ndarray, nodes: np.ndarray, k: int) -> np.ndarray:
    """RC node ids for a SUBSET of nodes (queries only that subset — the
    full-table variant is 3x the work when only unitig endpoints are
    needed). Missing RCs (impossible in a both-strand graph) map to the
    node itself, which degrades to keeping both strands, never dropping."""
    if len(nodes) == 0:
        return nodes.astype(np.int64)
    rc = kmer_ops.np_revcomp_keys(node_keys[nodes], k)
    ids = kmer_ops.np_searchsorted_keys(node_keys, rc)
    ids = np.clip(ids, 0, len(node_keys) - 1)
    miss = (node_keys[ids] != rc).any(axis=1)
    return np.where(miss, nodes, ids)


def dedup_strand_mask(uset: UnitigSet, k: int) -> np.ndarray:
    """Boolean keep-mask selecting one strand per unitig, vectorized.

    The RC twin of a linear unitig has entry' = rc(exit) — and entry
    uniquely identifies a unitig (nodes partition across unitigs), so
    canonical id = min(entry, rc_id[exit]) pairs the two strands exactly.
    Circular unitigs break their cycle at the minimum node id, so the
    canonical id is min over the chain of min(id, rc_id) on both strands.
    No string comparisons, no rotations (cf. the list-based
    :func:`dedup_strands` oracle); RC lookups touch only unitig endpoints
    (plus circular chains), not the full node table."""
    if uset.n == 0:
        return np.zeros(0, bool)
    entry = uset.entry.astype(np.int64)
    exit_ = uset.exit.astype(np.int64)
    canon = np.minimum(entry, _rc_ids_of(uset.node_keys, exit_, k))
    circ = uset.circular
    if circ.any():
        csel = np.repeat(circ, uset.chain_counts)
        cnodes = uset.chain_nodes[csel].astype(np.int64)
        both_min = np.minimum(cnodes, _rc_ids_of(uset.node_keys, cnodes, k))
        ccounts = uset.chain_counts[circ]
        cb = np.concatenate([[0], np.cumsum(ccounts)[:-1]])
        canon[circ] = np.minimum.reduceat(both_min, cb)
    _, first_idx = np.unique(canon, return_index=True)
    keep = np.zeros(uset.n, bool)
    keep[first_idx] = True
    return keep


def unitigs_from_pass(gp: GraphPass, k: int) -> list[Unitig]:
    """List-of-objects view (oracle/compat path; the production pipeline
    uses :func:`unitig_set_from_pass` + array analyses directly)."""
    uset = unitig_set_from_pass(gp, k)
    return [uset.unitig(j) for j in range(uset.n)]


def _revcomp_str(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def dedup_strands(unitigs: list[Unitig]) -> list[Unitig]:
    """Keep one strand per unitig (the graph carries both orientations).

    Representative = the orientation whose sequence is lexicographically
    smaller; circular twins may be rotations, so they are matched by their
    canonical rotation instead.
    """
    seen: dict[str, None] = {}
    out = []
    for u in unitigs:
        if u.circular:
            # the emitted string carries a k-1 bp terminal duplication;
            # the true cycle is the first len(node_ids) bases — canonical
            # rotation must be computed on that core or the strands of one
            # circle never match.
            core = u.seq[: len(u.node_ids)]
            key = min(_min_rotation(core), _min_rotation(_revcomp_str(core)))
        else:
            key = min(u.seq, _revcomp_str(u.seq))
        if key in seen:
            continue
        seen[key] = None
        out.append(u)
    return out


def _min_rotation(s: str) -> str:
    """Lexicographically least rotation (Booth's algorithm, O(n))."""
    d = s + s
    n = len(s)
    f = [-1] * len(d)
    best = 0
    for j in range(1, len(d)):
        c = d[j]
        i = f[j - best - 1]
        while i != -1 and c != d[best + i + 1]:
            if c < d[best + i + 1]:
                best = j - i - 1
            i = f[i]
        if c != d[best + i + 1]:
            if c < d[best]:
                best = j
            f[j - best] = -1
        else:
            f[j - best] = i + 1
    return d[best : best + n]
