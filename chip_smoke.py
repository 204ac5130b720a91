"""Smoke test of the whole pipeline on one NVIDIA GPU.

    python chip_smoke.py                # one card: phases 0, 1 and 2
    python chip_smoke.py --four-cards   # phase 2 on a 4-card data mesh vs one card
    python chip_smoke.py --kmer-list 31,141 ...   # phase 2 with another k-list

Phase 0 checks that JAX's first device is a GPU, prints the card's name and
power limit, and checks that the native FASTQ reader is in use.

Phase 1 runs each device operation of the main path on the card at the
widths the pipeline uses and compares it with its host route: k-mer
counting and the scattered LSM merge chain, the gate + strand expansion,
the de Bruijn graph pass, the read mapper, the read filter, and the
profile-HMM / Smith-Waterman / genewise DP scans.

Phase 2 generates a golden-volume sample from a fixed seed (a ~16.5 kb
circular mitogenome at ~400x bp coverage, PE-150 reads with 1% errors and
300 bp inserts, two 8 kb nuclear segments at 12x) and runs
``python -m mitoflex_tpu all`` on it through ``mitoflex_tpu.cli.main`` with
the shipped assembly defaults. The run must pass the golden contract
(circular, every fixture PCG annotated) and write the same contigs,
scaffolds and ``locs.json`` as the same command in a ``JAX_PLATFORMS=cpu``
child, which takes the host routes.

Host references that JAX computes run in that CPU child (started first, so
it overlaps the card's work); it never opens the card. Integer outputs must
match exactly; float scores too, since every one-hot product runs at
HIGHEST precision (an exact select) and the remaining float work is max and
add in the same order on both devices.

The last line of standard output is one JSON object, printed only when
every phase passed. The exit code is non-zero on any failure, and on a
machine where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 2026


@dataclasses.dataclass(frozen=True)
class Size:
    """Sample and operation widths. FULL is the golden volume; TINY keeps
    the same code paths small enough for the CPU tests."""

    spacer: int              # fixture spacer: genome = 5 * spacer + 1020 bp
    mito_cov: int            # bp coverage of the mitogenome
    read_len: int
    insert: int
    nuclear: tuple           # lengths of the nuclear segments
    nuclear_cov: int
    chunk_reads: int         # reads per counting chunk (= assemble.read_chunk)
    max_read_len: int        # read buffer width (= filter.max_read_len)
    ks: tuple                # graph k values of the count / graph checks
    windows: int             # DP batch rows
    filter_reads: int        # rows of the filter batch
    all_args: tuple = ()     # extra `all` flags


FULL = Size(spacer=3100, mito_cov=400, read_len=150, insert=300,
            nuclear=(8000, 8000), nuclear_cov=12, chunk_reads=16384,
            max_read_len=256, ks=(31, 141), windows=512, filter_reads=65536)
TINY = Size(spacer=2000, mito_cov=30, read_len=150, insert=300,
            nuclear=(1500,), nuclear_cov=6, chunk_reads=512,
            max_read_len=256, ks=(31, 141), windows=16, filter_reads=512,
            all_args=("--kmer-list", "31,59", "--depth-list", "3,3"))


class SmokeFailure(Exception):
    pass


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------- sample
def make_sample(workdir: str, size: Size, seed: int = SEED) -> dict:
    """Write the fixture profile set and the PE FASTQ pair; returns the
    paths and fixture facts both processes need."""
    import pathlib

    from tests import profile_fixture, synth

    rng = np.random.default_rng(seed)
    os.makedirs(workdir, exist_ok=True)
    fake = profile_fixture.build(pathlib.Path(workdir), rng, spacer=size.spacer)
    genome = fake.genome
    pairs = synth.shotgun_reads(
        rng, genome, len(genome) * size.mito_cov // (2 * size.read_len),
        read_len=size.read_len, insert=size.insert, circular=True,
        error_rate=0.01,
    )
    nuclear = [synth.random_genome(rng, n) for n in size.nuclear]
    for g in nuclear:
        pairs += synth.shotgun_reads(
            rng, g, len(g) * size.nuclear_cov // (2 * size.read_len),
            read_len=size.read_len, insert=size.insert, error_rate=0.01,
        )
    order = rng.permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    r1 = synth.write_fastq(os.path.join(workdir, "r1.fq"), [p[0] for p in pairs])
    r2 = synth.write_fastq(os.path.join(workdir, "r2.fq"), [p[1] for p in pairs])
    sample = {
        "workdir": workdir, "r1": r1, "r2": r2,
        "profile_dir": fake.profile_dir, "clade": fake.clade,
        "genome": genome, "nuclear": nuclear,
        "genes": list(profile_fixture.GENES),
        "gene_nt": fake.gene_nt, "pairs": len(pairs),
        "bases": sum(len(a[0]) + len(b[0]) for a, b in pairs),
        "size": dataclasses.asdict(size),
    }
    with open(os.path.join(workdir, "sample.json"), "w") as f:
        json.dump(sample, f)
    return sample


def _size_of(sample: dict) -> Size:
    d = dict(sample["size"])
    d["nuclear"], d["ks"], d["all_args"] = (
        tuple(d["nuclear"]), tuple(d["ks"]), tuple(d["all_args"]))
    return Size(**d)


def read_chunks(sample: dict):
    """The counting chunks the assemble stage sees: fixed-capacity batches
    of each mate file, as its read source yields them."""
    from mitoflex_tpu.io import fastq

    size = _size_of(sample)
    out = []
    for path in (sample["r1"], sample["r2"]):
        for b in fastq.read_batches(path, size.chunk_reads, size.max_read_len):
            out.append((b.seqs, b.lengths))
    return out


# ------------------------------------------------------------ DP inputs
def dp_inputs(sample: dict) -> dict:
    """Profile-HMM windows and protein/nucleotide alignment batches at the
    widths models/nhmmer.py, models/blast.py and stages/annotate.py use."""
    from mitoflex_tpu.io import encoding
    from mitoflex_tpu.models import codon
    from mitoflex_tpu.ops import genewise as genewise_ops

    size = _size_of(sample)
    rng = np.random.default_rng(SEED + 1)
    genome = sample["genome"]
    fwd = np.asarray(encoding.encode(genome + genome))
    rev = np.asarray(encoding.revcomp(fwd))
    # nhmmer: windows of 2 x model length bucketed to T = 1024 (models up
    # to 300 nt), all strands, some windows short
    T, B = 1024, size.windows
    seqs = np.full((B, T), encoding.N, np.int8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        src = fwd if i % 2 == 0 else rev
        off = int(rng.integers(0, len(genome)))
        n = T if i % 4 else int(rng.integers(T // 2, T))
        seqs[i, :n] = src[off : off + n]
        lens[i] = n
    # protein batches (tblastn SW and genewise): each row a fixture
    # peptide vs a window around its gene with random flanks, like the
    # genewise refinement and the translated-window SW of tblastn
    gc = codon.get_code(5)
    peps = {g: codon.aa_encode(gc.translate_str(nt).rstrip("*"))
            for g, nt in sample["gene_nt"].items()}
    genes = sorted(peps)
    nb = 64
    q_rows, nt_rows = [], []
    for i in range(nb):
        g = genes[i % len(genes)]
        nt = sample["gene_nt"][g]
        left = synth_dna(rng, int(rng.integers(30, 300)))
        right = synth_dna(rng, int(rng.integers(30, 300)))
        q = peps[g].copy()
        mut = rng.random(len(q)) < 0.15
        q[mut] = rng.integers(0, 20, int(mut.sum()))
        q_rows.append(q)
        nt_rows.append(np.asarray(encoding.encode(left + nt + right)))
    Lq = 1 << max(5, (max(len(q) for q in q_rows) - 1).bit_length())
    Lt = 1 << max(5, (max(len(t) for t in nt_rows) - 1).bit_length())
    qa = np.full((nb, Lq), codon.X_CODE, np.int8)
    ql = np.zeros(nb, np.int32)
    ta = np.full((nb, Lt), 4, np.int8)
    tl = np.zeros(nb, np.int32)
    for i, (q, t) in enumerate(zip(q_rows, nt_rows)):
        qa[i, : len(q)], ql[i] = q, len(q)
        ta[i, : len(t)], tl[i] = t, len(t)
    aa_ends = genewise_ops.translate_windows(ta, 5)
    # SW over translated frame-0 targets (one aa per codon)
    sw_t = np.full((nb, Lt // 2), codon.X_CODE, np.int8)
    sw_tl = np.zeros(nb, np.int32)
    for i, t in enumerate(nt_rows):
        aa = gc.translate_codes(t, 0)
        sw_t[i, : len(aa)], sw_tl[i] = aa, len(aa)
    return dict(seqs=seqs, lens=lens, qa=qa, ql=ql, aa_ends=aa_ends, tl=tl,
                sw_t=sw_t, sw_tl=sw_tl)


def synth_dna(rng, n: int) -> str:
    return "".join("ACGT"[i] for i in rng.integers(0, 4, n))


def _profiles(sample: dict):
    from mitoflex_tpu.models.profiles import ProfileSet
    from mitoflex_tpu.ops import phmm as phmm_ops

    hmms = ProfileSet(sample["profile_dir"]).cds_hmms(sample["clade"])
    pad = max(phmm_ops.stage_profile(h).msc.shape[0] for h in hmms)
    staged = [phmm_ops.stage_profile(h, pad_to=pad) for h in hmms]
    return hmms, staged


def dp_ops(sample: dict) -> dict:
    """The DP scans at pipeline widths; identical calls in both processes."""
    import jax.numpy as jnp

    from mitoflex_tpu.models import codon
    from mitoflex_tpu.ops import genewise as genewise_ops
    from mitoflex_tpu.ops import phmm as phmm_ops
    from mitoflex_tpu.ops import sw as sw_ops

    x = dp_inputs(sample)
    hmms, staged = _profiles(sample)
    out = {}
    seqs, lens = jnp.asarray(x["seqs"]), jnp.asarray(x["lens"])
    mlens = jnp.asarray([h.length for h in hmms], jnp.int32)
    out["viterbi_scores_multi"] = _timed(lambda: phmm_ops.viterbi_scores_multi(
        phmm_ops.stack_profiles(staged), mlens, seqs, lens))
    out["viterbi_scan"] = _timed(lambda: phmm_ops.viterbi_scan(
        staged[0], seqs, lens, hmms[0].length))
    sub = jnp.asarray(codon.blosum62())
    out["sw_align"] = _timed(lambda: sw_ops.sw_align(
        jnp.asarray(x["qa"]), jnp.asarray(x["ql"]), jnp.asarray(x["sw_t"]),
        jnp.asarray(x["sw_tl"]), sub, 12.0, 1.0))
    out["genewise_align"] = _timed(lambda: genewise_ops.genewise_align(
        jnp.asarray(x["qa"]), jnp.asarray(x["ql"]), jnp.asarray(x["aa_ends"]),
        jnp.asarray(x["tl"]), sub))
    return out


def _flat(name: str, res) -> dict:
    """Named numpy arrays of an op result (array, tuple or NamedTuple)."""
    if hasattr(res, "_fields"):
        return {f"{name}.{f}": np.asarray(getattr(res, f)) for f in res._fields}
    if isinstance(res, (list, tuple)):
        return {f"{name}.{i}": np.asarray(r) for i, r in enumerate(res)}
    return {name: np.asarray(res)}


def _timed(fn):
    """(result, first-call seconds, steady-call seconds): the first call
    includes compilation; every call ends with the result on the host."""
    import jax

    t0 = time.perf_counter()
    res = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = jax.block_until_ready(fn())
    return res, first, time.perf_counter() - t0


def _device_loop_seconds(step, args, iters: int = 20) -> float:
    """Device seconds per call of ``step(i, *args) -> int32 scalar``, run
    inside one jitted fori_loop so dispatch and transfers cancel: median
    over three (1-iteration, ``iters``-iteration) pairs. ``step`` must
    perturb its input with ``i`` so no iteration can be reused."""
    import jax
    import jax.numpy as jnp

    def make(n):
        @jax.jit
        def run(seed, *a):
            return jax.lax.fori_loop(
                0, n, lambda i, acc: acc + step(i + seed, *a), jnp.int32(0))
        return run

    one, many = make(1), make(iters)
    int(one(0, *args))
    int(many(0, *args))
    pairs = []
    for seed in (1, 2, 3):
        t0 = time.perf_counter()
        int(one(seed, *args))
        t1 = time.perf_counter()
        int(many(seed, *args))
        t2 = time.perf_counter()
        pairs.append(max((t2 - t1) - (t1 - t0), 0.0) / (iters - 1))
    return float(np.median(pairs))


def _merge_step(i, *flat):
    from mitoflex_tpu.ops import kmer as kmer_ops

    W = (len(flat) - 2) // 2
    a = [flat[0] ^ i.astype(flat[0].dtype)] + list(flat[1:W])
    w, c = kmer_ops.merge_scattered(a, flat[W], list(flat[W + 1:2 * W + 1]),
                                    flat[2 * W + 1])
    return w[0][0].astype("int32") + c[0].astype("int32")


def runs_b(run):
    """A second scattered run of the same capacity: the first with its
    counts halved (keys stay sorted)."""
    return (*run[0], run[1] // 2)


def _filter_step(i, seqs, quals, lengths):
    import jax.numpy as jnp

    from mitoflex_tpu.ops import filter as filter_ops

    keep, h1, _ = filter_ops.filter_reads_ref(
        seqs ^ (i & 3).astype(jnp.int8), quals, lengths, 10, 55, 0.2)
    return jnp.sum(keep.astype(jnp.int32)) + h1[0].astype(jnp.int32)


# ------------------------------------------------------------- phase 1
def count_device(chunks, kp1: int):
    """Device LSM route: count_chunk_scattered per chunk, then a chain of
    merge_scattered; totals re-summed once on the host."""
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.ops import kmer as kmer_ops

    t0 = time.perf_counter()
    runs = [kmer_ops.count_chunk_scattered(jnp.asarray(s), jnp.asarray(l),
                                           kp1, True) for s, l in chunks]
    merged = runs[0]
    for r in runs[1:]:
        merged = kmer_ops.merge_scattered(merged[0], merged[1], r[0], r[1])
    jax.block_until_ready(merged)
    wall = time.perf_counter() - t0
    keys, counts = kmer_ops.pull_scattered(*merged)
    return keys, counts, wall, runs[0]


def count_host(chunks, kp1: int):
    """Host route of the CPU backend (KmerCounter with prefer_host): numpy
    or host-compacted counting per chunk, native sorted merges."""
    from mitoflex_tpu.stages import assemble as asm

    c = asm.KmerCounter(kp1, canonical=True, prefer_host=True)
    for s, l in chunks:
        c.add_chunk(s, l)
    return c._merged()


def solid_edges(chunks, k: int):
    """count_edges (count + gate + strand expansion) over the chunks."""
    from mitoflex_tpu.stages import assemble as asm

    return asm.count_edges(lambda: iter(chunks), k, 3)


GRAPH_FIELDS = ("out_deg", "in_deg", "root", "offset", "link_count", "is_cycle")


def graph_arrays(gp, E: int) -> dict:
    V = int(gp.n_nodes)
    out = {"n_nodes": np.asarray([V])}
    for w, a in enumerate(gp.node_words):
        out[f"node_words{w}"] = np.asarray(a)[:V]
    for f in GRAPH_FIELDS:
        out[f] = np.asarray(getattr(gp, f))[:V]
    for f in ("prefix_id", "suffix_id", "edge_valid"):
        out[f] = np.asarray(getattr(gp, f))[:E]
    return out


def phase1_reference(sample: dict) -> dict:
    """Host routes (CPU child): returns flat named arrays."""
    size = _size_of(sample)
    chunks = read_chunks(sample)
    ref = {}
    for k in size.ks:
        keys, counts = count_host(chunks, k + 1)
        ref[f"count{k}.keys"], ref[f"count{k}.counts"] = keys, counts
        ek, ec = solid_edges(chunks, k)
        ref[f"edges{k}.keys"], ref[f"edges{k}.counts"] = ek, ec
        if k == max(size.ks):
            from mitoflex_tpu.stages import assemble as asm

            gp = asm._run_graph_pass(ek, ec, k)
            ref.update({f"graph{k}.{n}": a
                        for n, a in graph_arrays(gp, len(ek)).items()})
    b = filter_batch(sample)
    ref.update(_flat("filter", filter_op(b)))
    for name, (res, _, _) in dp_ops(sample).items():
        ref.update(_flat(name, res))
    return ref


def filter_batch(sample: dict):
    from mitoflex_tpu.io import fastq

    size = _size_of(sample)
    b = next(iter(fastq.read_batches(sample["r1"], size.filter_reads,
                                     size.max_read_len)))
    return b.seqs, b.quals, b.lengths


def filter_op(batch):
    from mitoflex_tpu.ops import filter as filter_ops

    return filter_ops.filter_reads(*batch, 10, 55, 0.2)


def _same(name: str, got: dict, want: dict, lines: list) -> None:
    """Exact equality of every array under ``name``."""
    keys = sorted(k for k in want if k == name or k.startswith(name + "."))
    _check(bool(keys), f"{name}: no reference arrays")
    for key in keys:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        _check(a.shape == b.shape and a.dtype == b.dtype,
               f"{key}: shape/dtype {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        bad = int(np.sum(a != b))
        _check(bad == 0, f"{key}: {bad} of {a.size} elements differ")
    lines.append(f"phase1 {name}: exact over {len(keys)} arrays "
                 f"({sum(np.asarray(want[k]).size for k in keys)} values)")


def phase1_device(sample: dict, lines: list) -> dict:
    """Device routes at pipeline widths. Checks that need no CPU child
    (mapper, k=31 graph pass) are compared here; the rest is returned for
    comparison with the child's reference."""
    import jax
    import jax.numpy as jnp

    from mitoflex_tpu.io.fasta import FastaRecord
    from mitoflex_tpu.ops import dbg as dbg_ops
    from mitoflex_tpu.ops import kmer as kmer_ops
    from mitoflex_tpu.ops import mapper as mapper_ops
    from mitoflex_tpu.stages import assemble as asm

    size = _size_of(sample)
    chunks = read_chunks(sample)
    got = {}
    for k in size.ks:
        keys, counts, wall, run0 = count_device(chunks, k + 1)
        got[f"count{k}.keys"], got[f"count{k}.counts"] = keys, counts
        W = kmer_ops.num_words(k + 1)
        rows = run0[1].shape[0]
        lines.append(f"phase1 count k={k} W={W}: {len(chunks)} chunks of "
                     f"{size.chunk_reads}x{size.max_read_len}, run capacity "
                     f"{rows}, {len(keys)} distinct, chain wall {wall:.3f} s")
        # one merge of two chunk runs, timed alone against the memory
        # roofline: 2 (W+1) 4-byte words per row, read and written
        flat = (*run0[0], run0[1], *runs_b(run0))
        t_dev = _device_loop_seconds(_merge_step, flat)
        nbytes = 2 * (W + 1) * 4 * (2 * rows)
        lines.append(f"phase1 merge_scattered k={k} W={W} rows={2 * rows}: "
                     f"device {t_dev * 1e3:.3f} ms per merge, "
                     f"{nbytes / 1e6:.1f} MB moved -> "
                     f"{nbytes / max(t_dev, 1e-12) / 1e12:.3f} TB/s")
        ek, ec = solid_edges(chunks, k)
        got[f"edges{k}.keys"], got[f"edges{k}.counts"] = ek, ec
        t0 = time.perf_counter()
        gp = jax.block_until_ready(asm._run_graph_pass(ek, ec, k))
        lines.append(f"phase1 graph_unitig_pass k={k}: {len(ek)} edges, "
                     f"{int(gp.n_nodes)} nodes, {time.perf_counter() - t0:.3f} s "
                     "(incl. compile)")
        arrs = graph_arrays(gp, len(ek))
        if kmer_ops.num_words(k + 1) <= 2:
            host = graph_arrays(dbg_ops.graph_unitig_pass_host(ek, ec, k), len(ek))
            _same(f"graph{k}", {f"graph{k}.{n}": a for n, a in arrs.items()},
                  {f"graph{k}.{n}": a for n, a in host.items()}, lines)
            lines[-1] += " vs graph_unitig_pass_host"
        else:
            got.update({f"graph{k}.{n}": a for n, a in arrs.items()})

    # read mapper: device sort-join vs the numpy mirror
    recs = [FastaRecord("mito", sample["genome"])] + [
        FastaRecord(f"nuc{i}", g) for i, g in enumerate(sample["nuclear"])]
    index = mapper_ops.ContigIndex.build(recs)
    seqs, lengths = chunks[0]
    args = (2, mapper_ops.SEED_STEP, mapper_ops.MAX_MULT)
    dev, t_first, t_steady = _timed(lambda: mapper_ops._map_device(
        index.keys, index.contig_of, index.pos_of, jnp.asarray(seqs),
        jnp.asarray(lengths), *args))
    host = mapper_ops._map_host(index, seqs, lengths, *args)
    _same("map", _flat("map", dev), _flat("map", host), lines)
    mapped = int(np.sum(np.asarray(dev[0]) >= 0))
    lines[-1] += (f" _map_device vs _map_host, {len(seqs)} reads "
                  f"({mapped} mapped), first {t_first:.3f} s, steady "
                  f"{t_steady * 1e3:.2f} ms")

    b = filter_batch(sample)
    got.update(_flat("filter", filter_op(b)))
    B, L = b[0].shape
    t_dev = _device_loop_seconds(_filter_step, tuple(jnp.asarray(x) for x in b))
    nbytes = 2 * B * L + 12 * B
    lines.append(f"phase1 filter_reads_ref {B}x{L}: device {t_dev * 1e6:.1f} us "
                 f"per batch, {nbytes / 1e6:.1f} MB -> "
                 f"{nbytes / max(t_dev, 1e-12) / 1e12:.3f} TB/s, "
                 f"{B * L / max(t_dev, 1e-12) / 1e9:.1f} Gbase/s")
    for name, (res, t_first, t_steady) in dp_ops(sample).items():
        got.update(_flat(name, res))
        lines.append(f"phase1 {name}: first {t_first:.3f} s, steady "
                     f"{t_steady * 1e3:.2f} ms")
    return got


def compare_phase1(got: dict, ref: dict, sample: dict, lines: list) -> None:
    size = _size_of(sample)
    for k in size.ks:
        _same(f"count{k}", got, ref, lines)
        lines[-1] += " (count_chunk_scattered + merge_scattered vs host merge)"
        _same(f"edges{k}", got, ref, lines)
    k = max(size.ks)
    _same(f"graph{k}", got, ref, lines)
    lines[-1] += " vs CPU-child graph_unitig_pass"
    for name in ("filter", "viterbi_scores_multi", "viterbi_scan", "sw_align",
                 "genewise_align"):
        _same(name, got, ref, lines)
        lines[-1] += " (one-hot products at HIGHEST precision)" if name not in (
            "filter",) else ""


# ------------------------------------------------------------- phase 2
def run_all(sample: dict, basedir: str, extra: tuple = ()) -> dict:
    """``all`` through the CLI entry point; returns walls per stage."""
    from mitoflex_tpu import cli, pipeline

    size = _size_of(sample)
    walls = {}
    originals = {}
    for stage in ("run_filter", "run_assemble", "run_findmitoscaf",
                  "run_annotate", "run_visualize"):
        fn = originals[stage] = getattr(pipeline, stage)

        def wrapped(*a, _fn=fn, _name=stage[4:], **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                walls[_name] = round(time.perf_counter() - t0, 3)

        setattr(pipeline, stage, wrapped)
    argv = ["all", "--fastq1", sample["r1"], "--fastq2", sample["r2"],
            "--workname", "smoke", "--basedir", basedir,
            "--profile-dir", sample["profile_dir"], "--clade", sample["clade"],
            "--genetic-code", "5", "--disable-taxa", "--keep-temp",
            "--level", "warn", *size.all_args, *extra]
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        for stage, fn in originals.items():
            setattr(pipeline, stage, fn)
    walls["total"] = round(time.perf_counter() - t0, 3)
    _check(rc == 0, f"`all` in {basedir} exited {rc}")
    return walls


PHASE2_FILES = ("smoke/smoke.temp/assemble/contigs.fa",
                "smoke/smoke.temp/assemble/scaffolds.fa",
                "smoke/smoke.result/locs.json")


def golden_contract(sample: dict, basedir: str) -> str:
    from mitoflex_tpu.utils.workdir import WorkDir

    wd = WorkDir(basedir, "smoke")
    circular = bool(wd.read_manifest("annotation")["circular"])
    with open(wd.result_file("locs.json")) as f:
        locs = json.load(f)
    missing = [g for g in sample["genes"] if g not in locs]
    _check(circular and not missing,
           f"golden contract failed in {basedir}: circular={circular}, "
           f"missing PCGs {missing}")
    with open(os.path.join(basedir, PHASE2_FILES[0])) as f:
        n_contigs = sum(1 for line in f if line.startswith(">"))
    return f"circular, all {len(sample['genes'])} PCGs, {n_contigs} contigs"


def compare_phase2(a: str, b: str, lines: list, what: str) -> None:
    for rel in PHASE2_FILES:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            da, db = fa.read(), fb.read()
        _check(da == db, f"{what}: {rel} differs ({len(da)} vs {len(db)} bytes)")
        lines.append(f"phase2 {what}: {os.path.basename(rel)} byte-identical "
                     f"({len(da)} bytes)")


# ----------------------------------------------------------- processes
class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, and persistent
    cache hits, from JAX's own monitoring events."""

    def __init__(self):
        from jax import monitoring

        self.seconds = 0.0
        self.compiles = 0
        self.cache_hits = 0

        def on_duration(name, secs, **_):
            if name.startswith("/jax/core/compile/"):
                self.seconds += secs
                self.compiles += name.endswith("backend_compile_duration")

        def on_event(name, **_):
            self.cache_hits += name == "/jax/compilation_cache/cache_hits"

        monitoring.register_event_duration_secs_listener(on_duration)
        monitoring.register_event_listener(on_event)

    def snapshot(self):
        return self.seconds, self.compiles, self.cache_hits


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    _check(r.returncode == 0 and r.stdout.strip(), "nvidia-smi failed")
    return r.stdout.strip().splitlines()[0].strip()


def cpu_child_main(workdir: str) -> int:
    """Host references and the host-route `all` run; never opens the card."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mitoflex_tpu.utils import compile_cache

    compile_cache.enable()
    with open(os.path.join(workdir, "sample.json")) as f:
        sample = json.load(f)
    t0 = time.perf_counter()
    np.savez(os.path.join(workdir, "phase1_ref.npz"), **phase1_reference(sample))
    t_ref = time.perf_counter() - t0
    walls = run_all(sample, os.path.join(workdir, "cpu"))
    with open(os.path.join(workdir, "cpu_child.json"), "w") as f:
        json.dump({"phase1_ref_s": round(t_ref, 3), "walls": walls}, f)
    return 0


def spawn_cpu_child(workdir: str) -> subprocess.Popen:
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    log = open(os.path.join(workdir, "cpu_child.log"), "w")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-child", workdir],
        stdout=log, stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def smoke_one_card(sample: dict, clock: "CompileClock", tag: str) -> list:
    """Phases 1 and 2 on the default device, checked against the CPU
    child; returns the report lines (phase-1 timings are printed as they
    come). Raises SmokeFailure on any mismatch."""
    workdir = sample["workdir"]
    lines: list = []
    child = spawn_cpu_child(workdir)
    try:
        c0 = clock.snapshot()
        t0 = time.perf_counter()
        got = phase1_device(sample, lines)
        c1 = clock.snapshot()
        print(f"phase1 device {tag}: {time.perf_counter() - t0:.1f} s, "
              f"compile {c1[0] - c0[0]:.1f} s ({c1[1] - c0[1]} compiles, "
              f"{c1[2] - c0[2]} cache hits)", flush=True)
        for line in lines:
            print(line, flush=True)
        lines.clear()
        walls = run_all(sample, os.path.join(workdir, "gpu"))
        c2 = clock.snapshot()
        print(f"phase2 device {tag}: walls {json.dumps(walls)}, compile "
              f"{c2[0] - c1[0]:.1f} s ({c2[1] - c1[1]} compiles, "
              f"{c2[2] - c1[2]} cache hits)", flush=True)
        lines.append("phase2 golden contract (device): "
                     + golden_contract(sample, os.path.join(workdir, "gpu")))
        rc = child.wait(timeout=1500)
        _check(rc == 0, f"CPU child exited {rc} (see {workdir}/cpu_child.log)")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(os.path.join(workdir, "cpu_child.json")) as f:
        cj = json.load(f)
    print(f"phase2 cpu child (host routes, CPU): walls "
          f"{json.dumps(cj['walls'])}, phase-1 references "
          f"{cj['phase1_ref_s']} s", flush=True)
    ref = dict(np.load(os.path.join(workdir, "phase1_ref.npz")))
    compare_phase1(got, ref, sample, lines)
    lines.append("phase2 golden contract (cpu): "
                 + golden_contract(sample, os.path.join(workdir, "cpu")))
    compare_phase2(os.path.join(workdir, "gpu"), os.path.join(workdir, "cpu"),
                   lines, "device vs cpu")
    return lines


def smoke_four_cards(sample: dict, clock: "CompileClock", tag: str) -> list:
    """Phase 2 on one device (mesh_shape [1]) and on the data mesh over
    every visible device, in this process; outputs must be byte-identical."""
    workdir = sample["workdir"]
    lines: list = []
    c0 = clock.snapshot()
    one = run_all(sample, os.path.join(workdir, "one"),
                  ("--config", _mesh_config(workdir, [1])))
    c1 = clock.snapshot()
    print(f"phase2 one card {tag}: walls {json.dumps(one)}, compile "
          f"{c1[0] - c0[0]:.1f} s ({c1[2] - c0[2]} cache hits)", flush=True)
    mesh = run_all(sample, os.path.join(workdir, "mesh"))
    c2 = clock.snapshot()
    print(f"phase2 mesh {tag}: walls {json.dumps(mesh)}, compile "
          f"{c2[0] - c1[0]:.1f} s ({c2[2] - c1[2]} cache hits)", flush=True)
    for d in ("one", "mesh"):
        lines.append(f"phase2 golden contract ({d}): "
                     + golden_contract(sample, os.path.join(workdir, d)))
    compare_phase2(os.path.join(workdir, "one"), os.path.join(workdir, "mesh"),
                   lines, "mesh vs one card")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="phase 2 on a 4-card data mesh vs one card")
    ap.add_argument("--kmer-list", default=None,
                    help="k-list of the phase-2 runs (default: the shipped one)")
    ap.add_argument("--cpu-child", metavar="WORKDIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_child:
        return cpu_child_main(args.cpu_child)

    import jax

    dev0 = jax.devices()[0]
    if dev0.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX's first device is {dev0.platform}",
              file=sys.stderr)
        return 1
    n_cards = 4 if args.four_cards else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, JAX sees {len(jax.devices())}",
              file=sys.stderr)
        return 1
    from mitoflex_tpu.native import fastq_native
    from mitoflex_tpu.utils import compile_cache

    compile_cache.enable()
    clock = CompileClock()
    card = card_line()
    tag = f"[{card}]"
    print(f"card: {card}", flush=True)
    native = fastq_native.available()
    print(f"native FASTQ reader in use: {native}", flush=True)
    if not native:
        print("chip_smoke: the native FASTQ reader did not build or load",
              file=sys.stderr)
        return 1
    print(f"compile cache: {compile_cache.cache_dir()}", flush=True)

    root = os.path.dirname(os.path.abspath(__file__))
    workdir = os.path.join(root, "smoke_work")
    if os.path.isdir(workdir):
        import shutil

        shutil.rmtree(workdir)
    t0 = time.perf_counter()
    size = FULL
    if args.kmer_list:
        size = dataclasses.replace(size, all_args=("--kmer-list", args.kmer_list))
    sample = make_sample(workdir, size)
    print(f"sample: {sample['pairs']} pairs, {sample['bases']} bases, genome "
          f"{len(sample['genome'])} bp ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    try:
        if args.four_cards:
            lines = smoke_four_cards(sample, clock, tag)
        else:
            lines = smoke_one_card(sample, clock, tag)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    for line in lines:
        print(line, flush=True)
    total = clock.snapshot()
    peak = [d.memory_stats().get("peak_bytes_in_use", 0)
            for d in jax.devices()[:n_cards]]
    print(f"compile total {tag}: {total[0]:.1f} s, {total[1]} compiles, "
          f"{total[2]} persistent-cache hits", flush=True)
    print(f"peak_bytes_in_use {tag}: {peak}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev0.platform, "kind": dev0.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


def _mesh_config(workdir: str, shape) -> str:
    path = os.path.join(workdir, f"mesh_{'x'.join(map(str, shape))}.py")
    with open(path, "w") as f:
        f.write(f"config = {{'run': {{'mesh_shape': {list(shape)}}}}}\n")
    return path


if __name__ == "__main__":
    raise SystemExit(main())
