"""Pipeline orchestrator: wires the stages through the work directory.

The equivalent of the reference's subcommand bodies in MitoFlex.py
(filter:76-113, assemble:119-135, findmitoscaf:142-175, annotate:181-227,
visualize:235-257, all:266-312, bim:322-375): each stage reads/writes files
under ``<workname>.temp/<stage>/`` so any stage can be re-run standalone —
the de-facto checkpoint/resume contract (SURVEY.md §5). Stage manifests
record inputs/outputs for staleness checks.
"""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import PipelineConfig
from .io import fasta, fastq
from .models.profiles import ProfileSet, get_profiles
from .models.taxonomy import Taxonomy, load_taxonomy
from .utils.helper import timed
from .utils.logger import logger
from .utils.workdir import WorkDir


@dataclass
class PipelineContext:
    cfg: PipelineConfig
    workdir: WorkDir
    profiles: Optional[ProfileSet] = None
    taxonomy: Optional[Taxonomy] = None
    mesh: object = None

    @classmethod
    def create(cls, cfg: PipelineConfig) -> "PipelineContext":
        wd = WorkDir(cfg.run.basedir, cfg.run.workname).create()
        logger.init(wd.log_path, cfg.run.log_level)
        # persistent XLA compilation cache: the pipeline is many mid-size
        # programs compiled per shape bucket; pay that once per cache
        # directory, not per run (utils/compile_cache).
        from .utils import compile_cache

        compile_cache.enable()
        profiles = None
        try:
            profiles = get_profiles(cfg.run.profile_dir)
        except FileNotFoundError as e:
            logger.warn(f"profiles unavailable ({e}); search/annotate stages will fail")
        taxonomy = None
        if not cfg.search.disable_taxa:
            taxonomy = load_taxonomy(cfg.run.taxonomy_dump)
        # a data mesh over every visible device, or over run.mesh_shape;
        # one device (mesh_shape [1]) runs the single-device routes. A mesh
        # that cannot be built is an error, not a silent single-device run.
        import jax

        shape = cfg.run.mesh_shape or [len(jax.devices())]
        mesh = None
        if int(np.prod(shape)) > 1:
            from .parallel.mesh import make_mesh

            mesh = make_mesh(shape, tuple(cfg.run.mesh_axes))
            logger.info(f"pipeline: data mesh over {np.prod(mesh.devices.shape)} devices")
        return cls(cfg, wd, profiles, taxonomy, mesh)

    @property
    def gene_code(self) -> int:
        cfg = self.cfg.annotate
        if cfg.genetic_code:
            return cfg.genetic_code
        if self.profiles is not None:
            try:
                return self.profiles.genetic_code(cfg.clade)
            except (FileNotFoundError, KeyError):
                pass
        return 5


def run_filter(ctx: PipelineContext, fastq1: str, fastq2: Optional[str] = None,
               cleanq1: Optional[str] = None, cleanq2: Optional[str] = None):
    from .stages.filter import filter_reads

    wd = ctx.workdir
    # --cleanq1/--cleanq2 override the default names (MitoFlex.py:81-88;
    # names resolve inside the cleandata dir, absolute paths win the join);
    # gzipped output carries the .gz suffix (MitoFlex.py:280-282)
    from .parallel.distributed import shard_info

    pid, n_hosts = shard_info()

    def gz(name: str) -> str:
        if n_hosts > 1:
            # per-host output shard (multi-host ingestion splits the input;
            # downstream stages on this host consume this host's shard)
            root, dot, ext = name.rpartition(".")
            name = f"{root}.p{pid}{dot}{ext}" if dot else f"{name}.p{pid}"
        if ctx.cfg.filter.compress_output and not name.endswith(".gz"):
            return name + ".gz"
        return name

    clean1 = wd.stage_file("cleandata", gz(cleanq1 or "clean.1.fq"))
    clean2 = (
        wd.stage_file("cleandata", gz(cleanq2 or "clean.2.fq"))
        if fastq2 else None
    )
    res = filter_reads(ctx.cfg.filter, fastq1, clean1, fastq2, clean2,
                       mesh=ctx.mesh, host_shard=(pid, n_hosts))
    wd.write_manifest("cleandata", {
        "inputs": [fastq1] + ([fastq2] if fastq2 else []),
        "outputs": [res.clean1] + ([res.clean2] if res.clean2 else []),
        "reads_in": res.reads_in, "reads_kept": res.reads_kept,
        "bases_kept": res.bases_kept,
    })
    return res


def run_assemble(ctx: PipelineContext, clean1: str, clean2: Optional[str] = None,
                 inputs_sharded: bool = False) -> str:
    """``inputs_sharded``: the clean files are already this host's shard
    (multi-host `all` flow) — don't split them again."""
    from .stages.assemble import assemble
    from .stages.scaffold import scaffold_contigs

    wd = ctx.workdir
    out = wd.stage_file("assemble", "contigs.fa")
    assemble(ctx.cfg.assemble, clean1, clean2, out,
             max_read_len=ctx.cfg.filter.max_read_len,
             host_shard=(0, 1) if inputs_sharded else None,
             mesh=ctx.mesh, spill_dir=wd.stage_dir("assemble"))
    if not ctx.cfg.assemble.disable_scaffolding and clean2:
        out2 = wd.stage_file("assemble", "scaffolds.fa")
        scaffold_contigs(ctx.cfg.assemble, out, clean1, clean2, out2)
        out = out2
    wd.write_manifest("assemble", {"inputs": [clean1, clean2], "outputs": [out]})
    return out


def run_findmitoscaf(
    ctx: PipelineContext,
    contigs_path: str,
    clean1: Optional[str] = None,
    clean2: Optional[str] = None,
    from_megahit: bool = True,
) -> str:
    from .ops import mapper
    from .stages.findmitoscaf import findmitoscaf

    wd = ctx.workdir
    records = fasta.load_fasta(contigs_path)
    if not from_megahit and not clean1 and clean2:
        clean1, clean2 = clean2, clean1  # reference swaps (MitoFlex.py:155-157)
    if not from_megahit and not clean1:
        raise RuntimeError("At least one fastq file should be specified!")
    if not from_megahit and clean1:
        # standalone entry: contigs lack depth tags; apply fastfilter's
        # min/max-length gate BEFORE remapping (the reference shells to
        # `fastfilter -l min,max -d 0` first, MitoFlex.py:146-152), then
        # remap reads for multi (remap_sequence path, MitoFlex.py:153-160)
        lo, hi = ctx.cfg.assemble.min_length, ctx.cfg.assemble.max_length
        records = [r for r in records if lo <= len(r.seq) <= hi]
        def batches():
            for b in fastq.read_batches(clean1, 8192, ctx.cfg.filter.max_read_len):
                yield b
            if clean2:
                for b in fastq.read_batches(clean2, 8192, ctx.cfg.filter.max_read_len):
                    yield b

        _, means, _, _ = mapper.coverage_of_reads(records, batches(),
                                                  mesh=ctx.mesh)
        records = [r.with_attrs(flag=1, multi=round(means.get(r.id, 0.0), 2))
                   for r in records]
    res = findmitoscaf(
        ctx.cfg.search, records, ctx.profiles, ctx.cfg.annotate.clade,
        taxonomy=ctx.taxonomy, gene_code=ctx.gene_code,
        max_contig_len=ctx.cfg.annotate.max_contig_length,
        basedir=wd.stage_dir("findmitoscaf"), prefix=ctx.cfg.run.workname,
        mesh=ctx.mesh,
    )
    # reference naming: {workname}.picked.fa (findmitoscaf.py:348)
    name = f"{ctx.cfg.run.workname}.picked.fa"
    out = wd.stage_file("findmitoscaf", name)
    fasta.write_fasta(res.picked, out)
    shutil.copy(out, wd.result_file(name))
    wd.write_manifest("findmitoscaf", {
        "inputs": [contigs_path], "outputs": [out],
        "found_pcgs": res.found_pcgs, "missing_pcgs": res.missing_pcgs,
    })
    return out


def run_annotate(ctx: PipelineContext, picked_path: str) -> Tuple[Dict, str, bool]:
    from .stages.annotate import annotate

    wd = ctx.workdir
    records = fasta.load_fasta(picked_path)
    basedir = wd.stage_dir("annotation")
    res = annotate(
        ctx.cfg.annotate, records, ctx.profiles, ctx.cfg.annotate.clade,
        gene_code=ctx.gene_code, basedir=basedir, prefix=ctx.cfg.run.workname,
        mesh=ctx.mesh,
    )
    for name in ("locs.json", f"{ctx.cfg.run.workname}.annotated.cds.fa",
                 f"{ctx.cfg.run.workname}.annotated.rna.fa"):
        src = os.path.join(basedir, name)
        if os.path.exists(src):
            shutil.copy(src, wd.result_file(name))
    wd.write_manifest("annotation", {
        "inputs": [picked_path],
        "outputs": [os.path.join(basedir, "locs.json")],
        "species": res.species,
        "circular": res.circular,
    })
    return res.locs, os.path.join(basedir, "locs.json"), res.circular


def run_visualize(
    ctx: PipelineContext, picked_path: str, locs: Dict,
    clean1: Optional[str] = None, clean2: Optional[str] = None,
    circular: bool = False,
) -> List[str]:
    from .stages.visualize import visualize

    wd = ctx.workdir
    records = fasta.load_fasta(picked_path)
    prefix = os.path.join(wd.stage_dir("visualize"), ctx.cfg.run.workname)
    outs = visualize(ctx.cfg.visualize, records, locs, prefix,
                     fastq1=clean1, fastq2=clean2, circular=circular,
                     max_depth_reads=ctx.cfg.visualize.max_depth_reads or None)
    for o in outs:
        if o.endswith((".png", ".svg")):
            shutil.copy(o, wd.result_file(os.path.basename(o)))
    wd.write_manifest("visualize", {"inputs": [picked_path], "outputs": outs})
    return outs


@timed()
def run_all(
    ctx: PipelineContext, fastq1: str, fastq2: Optional[str] = None,
    resume: bool = False,
) -> Dict:
    """The flagship end-to-end path (reference `all`, MitoFlex.py:266-312).

    ``resume`` skips stages whose manifest records existing outputs — the
    explicit form of the reference's de-facto file-based resumability
    (SURVEY.md §5 checkpoint/resume)."""

    def cached(stage: str) -> Optional[list]:
        if not resume or not ctx.workdir.stage_complete(stage):
            return None
        outs = ctx.workdir.read_manifest(stage)["outputs"]
        logger.info(f"resume: skipping {stage} (outputs present: {outs})")
        return outs

    c = cached("cleandata")
    if c:
        clean1, clean2 = c[0], (c[1] if len(c) > 1 else None)
    else:
        res = run_filter(ctx, fastq1, fastq2)
        clean1, clean2 = res.clean1, res.clean2
    c = cached("assemble")
    contigs = c[0] if c else run_assemble(ctx, clean1, clean2, inputs_sharded=True)
    c = cached("findmitoscaf")
    picked = c[0] if c else run_findmitoscaf(ctx, contigs)
    summary: Dict = {"picked": picked}
    if not ctx.cfg.annotate.disable_annotation:
        locs, locs_path, circular = run_annotate(ctx, picked)
        summary["locs"] = locs_path
        summary["circular"] = circular
        if not ctx.cfg.visualize.disable_visualization:
            # circular genomes render as a closed ring (MitoFlex.py:291-296)
            outs = run_visualize(ctx, picked, locs, clean1, clean2,
                                 circular=circular)
            summary["plots"] = [o for o in outs if o.endswith(".png")]
    if not ctx.cfg.run.keep_temp:
        pass  # temp retained until post hook; caller decides
    return summary


@timed()
def run_bim(ctx: PipelineContext, fastq1: str, fastq2: Optional[str] = None) -> str:
    """Iterative bait-map-assemble loop (reference bim, MitoFlex.py:322-375
    + bim/bim.py:43-78), starting from an initial assembly as bait."""
    from .ops import mapper
    from .stages.assemble import assemble

    cfg = ctx.cfg
    wd = ctx.workdir
    res = run_filter(ctx, fastq1, fastq2)
    bait = run_assemble(ctx, res.clean1, res.clean2, inputs_sharded=True)
    picked = bait
    for i in range(cfg.bim.max_iteration):
        logger.info(f"bim: generation {i}")
        records = fasta.load_fasta(bait)
        if not records:
            logger.warn("bim: empty bait; stopping")
            break
        index = mapper.ContigIndex.build(records)
        b1 = wd.stage_file("assemble", f"bim.{i}.1.fq")
        b2 = wd.stage_file("assemble", f"bim.{i}.2.fq") if res.clean2 else None
        n_out = 0
        inserts = []
        with fastq.FastqWriter(b1) as w1, (
            fastq.FastqWriter(b2) if b2 else _NullWriter()
        ) as w2:
            if res.clean2:
                pair_iter = fastq.read_pair_batches(
                    res.clean1, res.clean2, 8192, cfg.filter.max_read_len, keep_names=True
                )
                for p1, p2 in pair_iter:
                    m1 = mapper.map_batch(index, p1.seqs[: p1.count],
                                          p1.lengths[: p1.count], mesh=ctx.mesh)
                    m2 = mapper.map_batch(index, p2.seqs[: p2.count],
                                          p2.lengths[: p2.count], mesh=ctx.mesh)
                    keep = np.zeros(p1.capacity, bool)
                    keep[: p1.count] = (m1.contig >= 0) | (m2.contig >= 0)
                    n_out += w1.write_batch(p1, keep)
                    w2.write_batch(p2, keep)
                    if not cfg.bim.insert_size_auto:
                        continue
                    both = (m1.contig >= 0) & (m2.contig >= 0) & (m1.contig == m2.contig)
                    if both.any():
                        ins = np.abs(m2.pos[both] - m1.pos[both]) + p1.lengths[: p1.count][both]
                        inserts.append(ins)
            else:
                for b in fastq.read_batches(res.clean1, 8192, cfg.filter.max_read_len,
                                            keep_names=True):
                    m = mapper.map_batch(index, b.seqs[: b.count],
                                         b.lengths[: b.count], mesh=ctx.mesh)
                    keep = np.zeros(b.capacity, bool)
                    keep[: b.count] = m.contig >= 0
                    n_out += w1.write_batch(b, keep)
        logger.info(f"bim: {n_out} baited read(-pair)s")
        if n_out == 0:
            break
        if inserts and cfg.bim.insert_size_auto:
            # reference gates the estimate behind --insert-size-auto
            # (MitoFlex.py:354-355)
            est = int(np.median(np.concatenate(inserts)))
            logger.info(f"bim: estimated insert size {est}")
            cfg.assemble.insert_size = est
        out = wd.stage_file("assemble", f"bim.{i}.contigs.fa")
        old_noscaf = cfg.assemble.disable_scaffolding
        cfg.assemble.disable_scaffolding = (
            old_noscaf or (i % max(cfg.bim.scaffolding_spare, 1) != 0)
        )
        try:
            assemble(cfg.assemble, b1, b2, out,
                     max_read_len=cfg.filter.max_read_len, mesh=ctx.mesh,
                     spill_dir=wd.stage_dir("assemble"))
        finally:
            cfg.assemble.disable_scaffolding = old_noscaf
        if i > cfg.bim.iteration_ignore:
            picked = run_findmitoscaf(ctx, out)
            bait = picked
        else:
            bait = out
    return picked


class _NullWriter:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def write_batch(self, *a, **k):
        return 0
