"""Device mesh and sharded pipeline steps.

The reference is single-node: its concurrency is process pools and thread
flags (SURVEY.md §2 parallelism table). This engine's scale-out is pure
data parallelism over reads/contigs/windows on a ``jax.sharding.Mesh``
(axis "data"), with profile tables replicated; cross-device merges ride XLA
collectives (NCCL on GPUs):

- read filtering: batch sharded on axis 0, no communication;
- k-mer counting: each device sort-counts its shard, then the runs merge
  either replicated (``all_gather`` + re-sort; small tables) or
  PARTITIONED (range-bucket + ``all_to_all``; O(global/N) per chip —
  count_kmers_sharded_partitioned, the default pipeline_step path);
- read->contig mapping: reads sharded, the mito-scale seed index
  replicated (map_reads_sharded);
- profile-HMM scanning: windows sharded on axis 0, profiles replicated.

Multi-host runs initialize jax.distributed outside and pass the global
mesh; everything here is expressed with ``shard_map`` so it compiles the
same for 1 chip, 1 host, or N hosts.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import filter as filter_ops
from ..ops import kmer as kmer_ops
from ..ops import phmm as phmm_ops
from ..ops import sw as sw_ops


def make_mesh(
    shape: Optional[Sequence[int]] = None, axes: Sequence[str] = ("data",)
) -> Mesh:
    devices = np.array(jax.devices())
    if shape is None:
        shape = (len(devices),)
    n = int(np.prod(shape))
    return Mesh(devices[:n].reshape(tuple(shape)), tuple(axes))


def shard_batch(mesh: Mesh, *arrays: jax.Array) -> Tuple[jax.Array, ...]:
    """Place arrays with axis 0 sharded over the data axis."""
    out = []
    for a in arrays:
        spec = P("data", *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


@functools.partial(
    jax.jit, static_argnames=("ns_valve", "quality_valve", "percentage_valve", "mesh")
)
def filter_reads_sharded(
    mesh: Mesh,
    seqs: jax.Array,
    quals: jax.Array,
    lengths: jax.Array,
    ns_valve: int = 10,
    quality_valve: int = 55,
    percentage_valve: float = 0.2,
    cutoff_lengths: jax.Array | None = None,
):
    """Data-parallel read filter: embarrassingly parallel over reads."""
    if cutoff_lengths is None:
        cutoff_lengths = lengths

    def local(s, q, l, cl):
        return filter_ops.filter_reads_ref(
            s, q, l, ns_valve, quality_valve, percentage_valve, cl
        )

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data", None), P("data"), P("data")),
        out_specs=(P("data"), P("data"), P("data")),
    )(seqs, quals, lengths, cutoff_lengths)


def _local_count_both_strands(s: jax.Array, l: jax.Array, k: int):
    """Per-device sort-count of both-strand k-mers of a read shard:
    (unique words [M] x W ascending, counts [M], n_unique). Padding rows
    are all-ones keys with zero counts and sort last."""
    words, valid = kmer_ops.extract_kmers(s, l, k)
    rc = kmer_ops.revcomp_codes(s, l)
    words_r, valid_r = kmer_ops.extract_kmers(rc, l, k)
    cat = [jnp.concatenate([a, b]) for a, b in zip(words, words_r)]
    cat_v = jnp.concatenate([valid, valid_r])
    return kmer_ops.sort_count_unique(cat, cat_v)


@functools.partial(jax.jit, static_argnames=("k", "mesh"))
def count_kmers_sharded(
    mesh: Mesh, seqs: jax.Array, lengths: jax.Array, k: int
):
    """Distributed k-mer histogram: local sort-count per device shard, then
    an all_gather of the sorted runs and a weighted re-count so every
    device holds the merged (keys, counts) table.

    Returns (words list [N_total] x W, counts [N_total], n_unique) fully
    replicated — the multi-chip analog of the host-side
    merge_sorted_counts. Per-chip memory is O(global): use
    count_kmers_sharded_partitioned when the merged table must stay
    partitioned (large meshes)."""

    def local(s, l):
        uw, uc, _ = _local_count_both_strands(s, l, k)
        # gather every device's sorted run, then merge by re-counting with
        # the counts as weights
        gw = [jax.lax.all_gather(w, "data", tiled=True) for w in uw]
        gc = jax.lax.all_gather(uc, "data", tiled=True)
        mw, mc, mn = kmer_ops.sort_count_unique(
            gw, gc > 0, weights=gc
        )
        return (*mw, mc, mn)

    outs = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=(*([P(None)] * kmer_ops.num_words(k)), P(None), P()),
        # outputs are replicated by construction (post-all_gather), which
        # the varying-mesh-axes check cannot always infer
        check_vma=False,
    )(seqs, lengths)
    W = kmer_ops.num_words(k)
    return list(outs[:W]), outs[W], outs[W + 1]


def _u32_bitcast_i32(x: jax.Array) -> jax.Array:
    """Order-preserving uint32 -> int32 mapping (flip the sign bit and
    bitcast) so searchsorted can run without x64."""
    return jax.lax.bitcast_convert_type(x ^ jnp.uint32(0x80000000), jnp.int32)


def _partition_merge_local(uw, uc, nu, ndev: int, W: int, inner_i32, slack: float):
    """Per-device body of the all_to_all-partitioned merge: range-bucket a
    sorted unique run, route bucket j to device j, merge the received
    runs pairwise. Returns (*words, counts, n_unique[1], overflow)."""
    M = uc.shape[0]
    C = int(min(M, max(8, -(-int(M * slack) // ndev))))
    if C >= 64:
        # pow2 capacity (>=128) bounds the distinct merge shapes (tiny
        # inputs keep the exact cap)
        C = min(max(128, 1 << (C - 1).bit_length()), M)
    w0 = _u32_bitcast_i32(uw[0])
    lo = jnp.concatenate([
        jnp.zeros((1,), jnp.int32),
        jnp.searchsorted(w0, inner_i32).astype(jnp.int32),
        jnp.full((1,), M, jnp.int32),
    ])  # [ndev+1], ascending
    iota = jax.lax.broadcasted_iota(jnp.int32, (C, 1), 0).squeeze(-1)
    blocks = []
    overflow = jnp.int32(0)
    for j in range(ndev):
        start = jnp.clip(lo[j], 0, M - C)
        ridx = start + iota
        ok = jnp.logical_and(ridx >= lo[j], ridx < lo[j + 1])
        # keys stay the RAW sorted slice (out-of-bucket rows keep
        # their — possibly foreign-range — keys); only counts are
        # masked. Masking keys to all-ones would put pad rows at the
        # FRONT whenever start was clipped below lo[j], breaking the
        # ascending-run precondition of the scattered merge
        # downstream. Foreign keys ride with count 0 and vanish in
        # scattered_to_unique's totals>0 compaction.
        cols = [jax.lax.dynamic_slice_in_dim(w, start, C) for w in uw]
        cols.append(
            jnp.where(ok, jax.lax.dynamic_slice_in_dim(uc, start, C),
                      jnp.uint32(0))
        )
        blocks.append(jnp.stack(cols, axis=-1))  # [C, W+1]
        # overflow over REAL rows only (first nu rows are valid keys;
        # the padding tail rides in the last bucket with zero counts)
        hi_real = jnp.minimum(lo[j + 1], nu)
        lo_real = jnp.minimum(lo[j], nu)
        overflow += jnp.maximum(hi_real - lo_real - C, 0)
    x = jnp.stack(blocks, axis=0)  # [ndev, C, W+1]
    # route bucket j to device j; receive one block from every device
    x = jax.lax.all_to_all(x, "data", split_axis=0, concat_axis=0,
                           tiled=False)
    # each received bucket is a sorted scattered run (unique keys,
    # counts>0, all-ones/0 padding): merge them PAIRWISE with the
    # scattered merge and compact once at the end
    runs = [([x[j, :, i] for i in range(W)], x[j, :, W])
            for j in range(ndev)]
    while len(runs) > 1:
        nxt = []
        for a, b in zip(runs[::2], runs[1::2]):
            nxt.append(kmer_ops.merge_scattered(a[0], a[1], b[0], b[1]))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    mw, mc, mn = kmer_ops.scattered_to_unique(runs[0][0], runs[0][1])
    total_overflow = jax.lax.psum(overflow, "data")
    return (*mw, mc, mn.reshape(1), total_overflow)


def _to_i32(inner) -> jax.Array:
    """Map uint32 boundaries through the order-preserving u32->i32 bitcast."""
    flipped = [int(b) ^ (1 << 31) for b in inner]
    return jnp.asarray(
        [b - (1 << 32) if b >= (1 << 31) else b for b in flipped], jnp.int32
    )


def _inner_boundaries_i32(ndev: int) -> jax.Array:
    """The ndev-1 inner word0 range boundaries (uniform over uint32) for
    BOTH-STRAND tables, whose leading word is near-uniform."""
    return _to_i32([(j * (1 << 32)) // ndev for j in range(1, ndev)])


def _canonical_inner_boundaries_i32(ndev: int) -> jax.Array:
    """Boundaries for CANONICAL tables. A canonical key is min(x, rc(x)),
    so its leading-word fraction u has CDF F(u) = 1-(1-u)^2: uniform
    boundaries load shard 0 with ~2x the average — at slack=2 its expected
    load ~= its capacity and ordinary fluctuation trips the overflow
    fallback (round-4 ADVICE, medium). Quantiles of F equalize load:
    boundary_j = (1 - sqrt(1 - j/n)) * 2^32."""
    from ..ops.spill import canonical_inner_boundaries

    return _to_i32(canonical_inner_boundaries(ndev).tolist())


@functools.partial(jax.jit, static_argnames=("k", "mesh", "slack"))
def count_kmers_sharded_partitioned(
    mesh: Mesh, seqs: jax.Array, lengths: jax.Array, k: int, slack: float = 2.0
):
    """Distributed k-mer histogram with a PARTITIONED result: per-chip
    memory stays O(global / n_devices) instead of the all_gather merge's
    O(global) (the scale wall past ~8 chips).

    Each device sort-counts its read shard, range-partitions its sorted
    run by the first key word into n_dev contiguous buckets (uniform
    boundaries — both strands are counted, so keys are symmetric and
    near-uniform on random-ish data), and a single ``all_to_all`` routes
    bucket j of every device to device j. Each device then merges
    the n_dev sorted runs it received with one weighted sort-count — after
    which device j holds the exact global (keys, counts) table of key
    range j only.

    Buckets are fixed-capacity ``C = ceil(M / n_dev * slack)`` blocks
    (static shapes for XLA); keys beyond a bucket's capacity are dropped
    and counted in the returned ``overflow`` scalar (0 in practice at
    slack=2 — callers should treat nonzero overflow as a resize signal).

    Returns (words list [n_dev*C] x W sharded on "data", counts sharded,
    n_unique [n_dev] per-shard valid row counts, overflow replicated
    scalar). Row i of shard j is valid iff i < n_unique[j].
    """
    ndev = int(np.prod(mesh.devices.shape))
    W = kmer_ops.num_words(k)
    inner_i32 = _inner_boundaries_i32(ndev)

    def local(s, l):
        uw, uc, nu = _local_count_both_strands(s, l, k)
        return _partition_merge_local(uw, uc, nu, ndev, W, inner_i32, slack)

    outs = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=(*([P("data")] * W), P("data"), P("data"), P()),
        # the psum'd overflow is replicated by construction
        check_vma=False,
    )(seqs, lengths)
    return list(outs[:W]), outs[W], outs[W + 1], outs[W + 2]


# ------------------------------------------------- sharded k-mer LSM kernels
@functools.partial(jax.jit, static_argnames=("k", "canonical", "mesh"))
def count_chunk_scattered_sharded(
    mesh: Mesh, seqs: jax.Array, lengths: jax.Array, k: int,
    canonical: bool = True,
):
    """Per-device scattered chunk counting (the sharded analog of
    kmer.count_chunk_scattered): each device sort-counts its read shard;
    the result is a SHARDED scattered run — per-shard ascending, globally
    unordered. No communication."""

    def local(s, l):
        w, c = kmer_ops.count_chunk_scattered(s, l, k, canonical)
        return (*w, c)

    W = kmer_ops.num_words(k)
    outs = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=(P("data"),) * (W + 1),
        check_vma=False,
    )(seqs, lengths)
    return list(outs[:W]), outs[W]


@functools.partial(jax.jit, static_argnames=("mesh", "n_words"))
def merge_scattered_sharded(mesh: Mesh, n_words: int, *flat):
    """Pairwise merge of two SHARDED scattered runs, each device merging
    its local pair (no communication). ``flat`` is
    (*a_words, a_counts, *b_words, b_counts)."""
    W = n_words

    def local(*args):
        aw, ac = list(args[:W]), args[W]
        bw, bc = list(args[W + 1 : 2 * W + 1]), args[2 * W + 1]
        mw, mc = kmer_ops.merge_scattered(aw, ac, bw, bc)
        return (*mw, mc)

    outs = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"),) * (2 * W + 2),
        out_specs=(P("data"),) * (W + 1),
        check_vma=False,
    )(*flat)
    return list(outs[:W]), outs[W]


@functools.partial(jax.jit, static_argnames=("mesh", "slack", "canonical"))
def partition_scattered_sharded(mesh: Mesh, words, counts, slack: float = 2.0,
                                canonical: bool = False):
    """Final extraction of a sharded scattered LSM run: compact each
    device's run to sorted-unique, range-partition by key, ONE all_to_all
    so device j receives range j from everyone, merge. After this, shard j
    holds the exact global table of key range j (ascending across shards —
    host concat of the valid rows IS the global sorted table).

    ``canonical`` selects density-matched range boundaries (canonical
    tables concentrate on low leading words; see
    _canonical_inner_boundaries_i32) so per-shard load stays ~M/ndev and
    the overflow fallback only fires on genuinely pathological skew.

    Returns (words sharded, counts sharded, n_unique [ndev], overflow)."""
    ndev = int(np.prod(mesh.devices.shape))
    W = len(words)
    inner_i32 = (_canonical_inner_boundaries_i32(ndev) if canonical
                 else _inner_boundaries_i32(ndev))

    def local(*flat):
        ws, cs = list(flat[:W]), flat[W]
        uw, uc, nu = kmer_ops.scattered_to_unique(ws, cs)
        return _partition_merge_local(uw, uc, nu, ndev, W, inner_i32, slack)

    outs = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data"),) * (W + 1),
        out_specs=(*([P("data")] * W), P("data"), P("data"), P()),
        check_vma=False,
    )(*words, counts)
    return list(outs[:W]), outs[W], outs[W + 1], outs[W + 2]


@functools.partial(
    jax.jit, static_argnames=("min_votes", "step", "max_mult", "mesh")
)
def map_reads_sharded(
    mesh: Mesh,
    index_keys: jax.Array,
    contig_of: jax.Array,
    pos_of: jax.Array,
    seqs: jax.Array,
    lengths: jax.Array,
    min_votes: int = 2,
    step: int = 4,
    max_mult: int = 4,
):
    """Read->contig mapping fan-out: reads sharded on the data axis, the
    contig seed index replicated (it is mito-scale — tens of kb). The same
    sort-join mapper kernel (ops/mapper.py) the remap/visualize/bim
    consumers use, compiled once over the mesh."""
    from ..ops import mapper as mapper_ops

    def local(s, l):
        return mapper_ops._map_device(
            index_keys, contig_of, pos_of, s, l, min_votes, step, max_mult
        )

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=(P("data"),) * 5,
        # replicated index + sharded reads mix in the join sorts
        check_vma=False,
    )(seqs, lengths)


@functools.partial(jax.jit, static_argnames=("mesh",))
def viterbi_scores_multi_sharded(
    mesh: Mesh,
    profs: phmm_ops.DeviceProfile,
    model_lens: jax.Array,
    seqs: jax.Array,
    lengths: jax.Array,
) -> jax.Array:
    """The nhmmer pass-1 sweep over a mesh: windows sharded on the batch
    axis, the stacked profile bank replicated. [M, B] scores with B
    sharded — bit-identical per window to the single-device sweep."""

    def local(s, l):
        return phmm_ops.viterbi_scores_multi(profs, model_lens, s, l)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=P(None, "data"),
        check_vma=False,
    )(seqs, lengths)


@functools.partial(jax.jit, static_argnames=("model_len", "mesh"))
def viterbi_scan_sharded(
    mesh: Mesh,
    prof: phmm_ops.DeviceProfile,
    seqs: jax.Array,
    lengths: jax.Array,
    model_len: int,
):
    """Profile replicated, windows sharded."""

    def local(s, l):
        return phmm_ops.viterbi_scan(prof, s, l, model_len)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data")),
        out_specs=phmm_ops.HmmHits(P("data"), P("data"), P("data"), P("data"), P("data")),
        # the scan carry mixes device-varying (per-shard windows) and
        # replicated (profile) values; skip the inference check
        check_vma=False,
    )(seqs, lengths)


@functools.partial(jax.jit, static_argnames=("gap_open", "gap_extend", "mesh"))
def sw_align_sharded(
    mesh: Mesh,
    queries: jax.Array,
    q_lens: jax.Array,
    targets: jax.Array,
    t_lens: jax.Array,
    submat: jax.Array,
    gap_open: float = 11.0,
    gap_extend: float = 1.0,
) -> sw_ops.SwHits:
    """Annotation-stage alignment fan-out: the reference shards its
    tblastn/blastn query DB across a multiprocessing.Pool
    (annotation_tookit.py:74-97); here (query, target) pairs shard over
    the data axis with the substitution matrix replicated — the same
    kernel that scores blast hits, genewise windows and remaps reads."""

    def local(q, ql, t, tl, sm):
        return sw_ops.sw_align(q, ql, t, tl, sm, gap_open, gap_extend)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(
            P("data", None), P("data"), P("data", None), P("data"),
            P(None, None),
        ),
        out_specs=sw_ops.SwHits(*([P("data")] * len(sw_ops.SwHits._fields))),
        # the scan carry mixes device-varying rows with the replicated
        # substitution matrix; skip the varying-axes inference check
        check_vma=False,
    )(queries, q_lens, targets, t_lens, submat)


@functools.partial(
    jax.jit,
    static_argnames=("gap_open", "gap_extend", "fs_penalty", "stop_penalty",
                     "mesh"),
)
def genewise_align_sharded(
    mesh: Mesh,
    queries: jax.Array,
    q_lens: jax.Array,
    target_aa: jax.Array,
    t_lens: jax.Array,
    submat: jax.Array,
    gap_open: float = 13.0,
    gap_extend: float = 3.0,
    fs_penalty: float = 15.0,
    stop_penalty: float = 20.0,
):
    """Genewise windows sharded over the data axis (the reference refines
    hits SERIALLY through wise2, annotation_tookit.py:264-311; here every
    washed hit's window aligns in parallel across the mesh)."""
    from ..ops import genewise as genewise_ops

    def local(q, ql, t, tl, sm):
        return genewise_ops.genewise_align(
            q, ql, t, tl, sm, gap_open, gap_extend, fs_penalty, stop_penalty
        )

    from ..ops.genewise import WiseHits

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P("data", None), P("data"), P("data", None), P("data"),
                  P(None, None)),
        out_specs=WiseHits(*([P("data")] * len(WiseHits._fields))),
        check_vma=False,
    )(queries, q_lens, target_aa, t_lens, submat)


def pipeline_step(
    mesh: Mesh,
    seqs: jax.Array,
    quals: jax.Array,
    lengths: jax.Array,
    prof: phmm_ops.DeviceProfile,
    model_len: int,
    k: int = 21,
):
    """One fused device step of the production pipeline over a mesh:
    filter -> partitioned k-mer merge (all_to_all) -> profile scan. Used by
    the multi-chip dry run and as the unit the benchmark scales over."""
    keep, h1, h2 = filter_reads_sharded(mesh, seqs, quals, lengths)
    lengths_f = jnp.where(keep, lengths, 0)
    words, counts, n_per, overflow = count_kmers_sharded_partitioned(
        mesh, seqs, lengths_f, k
    )
    hits = viterbi_scan_sharded(mesh, prof, seqs, lengths_f, model_len)
    return dict(
        kept=jnp.sum(keep.astype(jnp.int32)),
        n_unique_kmers=jnp.sum(n_per),
        kmer_overflow=overflow,
        max_count=jnp.max(counts),
        best_score=jnp.max(hits.score),
    )
