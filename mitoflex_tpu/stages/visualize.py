"""Visualize stage: circular genome map.

Capability parity with the reference's circos pipeline
(visualize/visualize.py:42-186 + circos_config.py): contigs renamed to
mt1.., gene/feature tracks, GC content in 50 bp windows, read-depth track —
but rendered natively with matplotlib (polar axes) to PNG+SVG instead of
generating circos input files and shelling out to Perl circos. The same
track data is also written as TSV files plus a circos.conf (bio/circos.py
DSL) so users can re-render with circos proper if they want.

Track semantics preserved (visualize.py:72-168):
- karyotype ring: one arc per sequence, renamed ``mt{i}``;
- gene arcs colored by type (CDS/tRNA/rRNA, configurations.py colors);
- gene name labels;
- GC-content histogram over ``gc_window`` bp windows;
- depth line from remapped reads (ops/mapper.py replaces bwa/samtools).
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import VisualizeConfig
from ..io import encoding, fastq
from ..io.fasta import FastaRecord
from ..ops import mapper
from ..utils.helper import timed
from ..utils.logger import logger


def gc_windows(codes: np.ndarray, window: int) -> np.ndarray:
    """GC fraction per window (visualize.py GC track, 50 bp default)."""
    n = len(codes) // window
    if n == 0:
        n, window = 1, len(codes)
    trimmed = codes[: n * window].reshape(n, window)
    gc = np.logical_or(trimmed == encoding.C, trimmed == encoding.G).sum(axis=1)
    valid = (trimmed < 4).sum(axis=1)
    return gc / np.maximum(valid, 1)


@timed()
def visualize(
    cfg: VisualizeConfig,
    records: Sequence[FastaRecord],
    locs: Dict[str, tuple],
    out_prefix: str,
    fastq1: Optional[str] = None,
    fastq2: Optional[str] = None,
    max_depth_reads: Optional[int] = None,
    circular: bool = False,
) -> List[str]:
    """Render the circular map; returns the list of files written. The
    PNG/SVG map needs matplotlib; without it only the track files and
    circos.conf are written (with a warning)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None
        logger.warn("visualize: matplotlib is not installed; writing the "
                    "tracks and circos.conf without the PNG/SVG map")

    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    outputs: List[str] = []

    # rename sequences mt1.. like the reference (visualize.py:58-66)
    renamed: Dict[str, str] = {}
    seqs: List[FastaRecord] = []
    for i, rec in enumerate(records):
        newid = f"mt{i + 1}"
        renamed[rec.id] = newid
        seqs.append(FastaRecord(newid, rec.seq, dict(rec.attrs)))
    total = sum(len(r.seq) for r in seqs)
    if total == 0:
        raise RuntimeError("Nothing to visualize.")

    # depth track via remapping — ALL reads by default, matching the
    # reference's full bwa remap (visualize.py:97-113); max_depth_reads
    # caps it for previews
    depth_per_contig: Optional[List[np.ndarray]] = None
    if fastq1:
        def batches():
            n = 0
            cap = max_depth_reads if max_depth_reads else float("inf")
            for b in fastq.read_batches(fastq1, 8192, 256):
                yield b
                n += b.count
                if n >= cap:
                    return
            if fastq2:
                for b in fastq.read_batches(fastq2, 8192, 256):
                    yield b
                    n += b.count
                    if n >= 2 * cap:
                        return

        originals = [FastaRecord(r.id, r.seq) for r in seqs]
        depth_per_contig, means, n_mapped, n_total = mapper.coverage_of_reads(
            originals, batches()
        )
        logger.info(f"visualize: depth from {n_mapped}/{n_total} mapped reads")

    # angular layout: proportional arcs with small gaps; a single
    # NON-circular genome keeps a visible break (the reference widens the
    # circos ideogram spacing unless --circular, visualize.py:156)
    if len(seqs) > 1:
        gap = 0.02 * 2 * math.pi
    else:
        gap = 0.0 if circular else 0.05 * 2 * math.pi
    usable = 2 * math.pi - gap * len(seqs)
    starts: Dict[str, float] = {}
    scales: Dict[str, float] = {}
    theta = 0.0
    for rec in seqs:
        starts[rec.id] = theta
        scales[rec.id] = usable * len(rec.seq) / total
        theta += scales[rec.id] + gap

    def angle(contig: str, pos: int) -> float:
        rec = next(r for r in seqs if r.id == contig)
        return starts[contig] + scales[contig] * pos / max(len(rec.seq), 1)

    if plt is not None:
        fig = plt.figure(figsize=(10, 10))
        ax = fig.add_subplot(projection="polar")
        ax.set_theta_zero_location("N")
        ax.set_theta_direction(-1)
        ax.set_ylim(0, 1.25)
        ax.axis("off")

        # karyotype ring
        for rec in seqs:
            th = np.linspace(starts[rec.id], starts[rec.id] + scales[rec.id], 256)
            ax.plot(th, np.full_like(th, 1.0), lw=10, color="#CCCCCC", solid_capstyle="butt")
            mid = starts[rec.id] + scales[rec.id] / 2
            ax.text(mid, 1.18, rec.id, ha="center", va="center", fontsize=12)

        colors = {0: cfg.color_cds, 1: cfg.color_trna, 2: cfg.color_rrna}
        for gene, (start, end, kind, contig, strand) in locs.items():
            cid = renamed.get(contig, contig)
            if cid not in starts:
                continue
            t0, t1 = angle(cid, start), angle(cid, end)
            th = np.linspace(t0, t1, max(int((t1 - t0) * 60), 2))
            r = 1.0 if strand == "+" else 0.94
            ax.plot(th, np.full_like(th, r), lw=8, color=colors.get(kind, "#888888"),
                    solid_capstyle="butt")
            ax.text((t0 + t1) / 2, 1.09, gene, ha="center", va="center", fontsize=7,
                    rotation=0)

        # GC histogram ring (0.62 .. 0.80)
        for rec in seqs:
            gc = gc_windows(rec.codes, cfg.gc_window)
            th = starts[rec.id] + scales[rec.id] * (np.arange(len(gc)) + 0.5) / len(gc)
            base, span = 0.62, 0.18
            ax.vlines(th, base, base + span * gc, color="#7896C2", lw=0.6)
        ax.text(0, 0.66, "GC", ha="center", fontsize=8, color="#7896C2")

        # depth ring (0.38 .. 0.58)
        if depth_per_contig is not None:
            all_max = max((d.max() if len(d) else 1) for d in depth_per_contig) or 1
            for i, rec in enumerate(seqs):
                d = depth_per_contig[i]
                if not len(d):
                    continue
                step = max(len(d) // 512, 1)
                dd = d[::step]
                th = starts[rec.id] + scales[rec.id] * np.arange(len(dd)) * step / len(d)
                ax.plot(th, 0.38 + 0.20 * dd / all_max, lw=0.8, color="#C27878")
            ax.text(0, 0.42, "depth", ha="center", fontsize=8, color="#C27878")

        ax.text(0, 0, f"{total:,} bp", ha="center", va="center", fontsize=14)

        png = f"{out_prefix}.png"
        svg = f"{out_prefix}.svg"
        fig.savefig(png, dpi=150, bbox_inches="tight")
        fig.savefig(svg, bbox_inches="tight")
        plt.close(fig)
        outputs += [png, svg]

    # machine-readable tracks + circos.conf for external re-rendering
    track_file = f"{out_prefix}.tracks.json"
    tracks = {
        "karyotype": [
            {"id": r.id, "length": len(r.seq)} for r in seqs
        ],
        "genes": [
            {"gene": g, "start": v[0], "end": v[1], "type": v[2],
             "contig": renamed.get(v[3], v[3]), "strand": v[4]}
            for g, v in locs.items()
        ],
        "gc": {r.id: gc_windows(r.codes, cfg.gc_window).round(4).tolist() for r in seqs},
    }
    if depth_per_contig is not None:
        tracks["depth_mean"] = {
            seqs[i].id: float(d.mean()) if len(d) else 0.0
            for i, d in enumerate(depth_per_contig)
        }
    with open(track_file, "w") as f:
        json.dump(tracks, f, indent=2)
    outputs.append(track_file)

    outputs += _export_circos_files(
        cfg, out_prefix, seqs, [r.id for r in records], locs, renamed,
        depth_per_contig, circular,
    )
    logger.info(f"visualize: wrote {', '.join(os.path.basename(o) for o in outputs)}")
    return outputs


def _export_circos_files(
    cfg: VisualizeConfig,
    out_prefix: str,
    seqs: List[FastaRecord],
    old_ids: List[str],
    locs: Dict[str, tuple],
    renamed: Dict[str, str],
    depth_per_contig: Optional[List[np.ndarray]],
    circular: bool,
) -> List[str]:
    """Write the circos input files the reference generates
    (visualize/visualize.py:72-168) so the exported circos.conf actually
    renders with circos proper: gene-name text track, feature highlight
    track, per-base depth track, GC histogram, karyotype, plus marker and
    the full circos.conf (circos_config.py structure)."""
    outputs: List[str] = []

    def track(name: str) -> str:
        return f"{out_prefix}.{name}"

    # gene name track (visualize.py:71-78): contig start end basename
    gene_file = track("gene.txt")
    with open(gene_file, "w") as f:
        for key, (start, end, _kind, contig, _strand) in locs.items():
            cid = renamed.get(contig, contig)
            base = key.split("_")[0] if "_" in key else key
            print(cid, start, end, base, sep="\t", file=f)
    outputs.append(gene_file)

    # feature highlight track (visualize.py:80-95): black end caps + a
    # type-colored body, radius band picked by strand
    fill_colors = [cfg.color_cds, cfg.color_trna, cfg.color_rrna]
    feat_file = track("features.txt")
    with open(feat_file, "w") as f:
        for key, (start, end, kind, contig, strand) in locs.items():
            cid = renamed.get(contig, contig)
            plus = strand == "+"
            r0 = 0.965 if plus else 1
            r1 = 1 if plus else 1.035
            color = fill_colors[int(kind)] if 0 <= int(kind) < 3 else "black"
            print(cid, start, start, f"fill_color=black,r0={r0}r,r1={r1}r",
                  sep="\t", file=f)
            print(cid, start, end, f"fill_color={color},r0={r0}r,r1={r1}r",
                  sep="\t", file=f)
            print(cid, end, end, f"fill_color=black,r0={r0}r,r1={r1}r",
                  sep="\t", file=f)
    outputs.append(feat_file)

    # per-base depth track (visualize.py:115-124 `samtools depth -aa` form:
    # contig pos pos depth); the depth comes from the device mapper remap
    max_gene_depth = 1
    depth_file = None
    if depth_per_contig is not None:
        depth_file = track("depth.txt")
        with open(depth_file, "w") as f:
            for rec, d in zip(seqs, depth_per_contig):
                n = min(len(rec.seq), len(d))
                if n:
                    max_gene_depth = max(max_gene_depth, int(d[:n].max()))
                for pos in range(n):
                    print(rec.id, pos + 1, pos + 1, int(d[pos]), file=f)
        outputs.append(depth_file)

    # GC content histogram (visualize.py:126-137): contig s s+len frac
    gc_file = track("gc.txt")
    with open(gc_file, "w") as f:
        for rec in seqs:
            codes = rec.codes
            for s in range(0, len(codes), cfg.gc_window):
                sl = codes[s : s + cfg.gc_window]
                gc = int(np.logical_or(sl == encoding.C, sl == encoding.G).sum())
                print(rec.id, s, s + len(sl), gc / len(sl), file=f)
    outputs.append(gc_file)

    # karyotype (visualize.py:139-146): chrN - mtN old_id 0 len grey
    kar_file = track("karyotype.txt")
    with open(kar_file, "w") as f:
        for rec, old in zip(seqs, old_ids):
            chr_name = rec.id.replace("mt", "chr")
            print(f"{chr_name} - {rec.id}\t{old}\t0\t{len(rec.seq)}\tgrey", file=f)
    outputs.append(kar_file)

    # plus-strand marker (visualize.py:148-152)
    plus_file = track("plus.txt")
    with open(plus_file, "w") as f:
        print("mt1\t0\t300\t+\tr0=1r-150p,r1=1r-100p", file=f)
    outputs.append(plus_file)

    conf_path = f"{out_prefix}.circos.conf"
    with open(conf_path, "w") as f:
        f.write("<<include etc/colors_fonts_patterns.conf>>\n")
        f.write(_circos_conf_text(
            basedir=os.path.dirname(os.path.abspath(out_prefix)),
            karyotype=kar_file, gene_file=gene_file, plus_file=plus_file,
            gc_file=gc_file, depth_file=depth_file, feat_file=feat_file,
            max_depth=max_gene_depth, circular=circular,
        ) + "\n")
        f.write("<<include etc/housekeeping.conf>>")
    outputs.append(conf_path)
    return outputs


def _circos_conf_text(
    basedir: str, karyotype: str, gene_file: str, plus_file: str,
    gc_file: str, depth_file: Optional[str], feat_file: str,
    max_depth: int, circular: bool,
) -> str:
    """The reference's circos.conf tree (visualize/circos_config.py:40-226
    with the run-specific values visualize.py:154-168 fills in), rebuilt
    with the bio.circos DSL."""
    from ..bio import circos as circos_dsl

    conf = circos_dsl.Circos()
    image = conf.image
    image.dir = basedir
    image.file = "Circos.png"
    image.png = "yes"
    image.svg = "yes"
    image.radius = "1500p"
    image.angle_offset = -90
    image.auto_alpha_colors = "yes"
    image.auto_alpha_steps = 5
    image.background = "white"

    ideo = conf.ideogram
    ideo.spacing.default = "0.01r"
    ideo.spacing.break_ = "0.01r" if circular else "0.5r"
    ideo.radius = "0.82r"
    ideo.thickness = "20p"
    ideo.fill = "yes"
    ideo.fill_color = "grey"
    ideo.stroke_thickness = 3
    ideo.stroke_color = "black"
    ideo.show_label = "yes"
    ideo.label_font = "bolditalic"
    ideo.label_radius = "dims(ideogram,radius_outer) - 0.1r"
    ideo.label_size = 28
    ideo.label_parallel = "yes"
    ideo.label_case = "lower"
    ideo.show_bands = "yes"
    ideo.fill_bands = "yes"
    ideo.band_stroke_thickness = 2
    ideo.band_stroke_color = "white"
    ideo.band_transparency = 0

    conf.show_ticks = "yes"
    conf.show_tick_labels = "yes"
    ticks = conf.ticks
    ticks.radius = "dims(ideogram,radius_outer)"
    ticks.orientation = "out"
    ticks.label_multiplier = 1e-3
    ticks.color = "black"
    ticks.thickness = "2p"
    ticks.font = "bold"
    for i, (spacing, size) in enumerate([("1u", "25p"), ("5u", "30p"), ("10u", "30p")]):
        tick = getattr(ticks, "tick" + "_" * i)
        tick.spacing = spacing
        tick.show_label = "yes"
        tick.label_size = size
        tick.size = size
        tick.format = "%d"
        if spacing != "1u":
            tick.suffix = '" kb"'
        tick.label_offset = "2p"

    conf.karyotype = karyotype
    conf.chromosomes_units = 1000
    conf.chromosomes_display_default = "yes"

    plots = conf.plots
    p0 = plots.plot  # gene-name text ring
    p0.type = "text"
    p0.color = "black"
    p0.label_font = "default"
    p0.label_size = "28p"
    p0.file = gene_file
    p0.r1 = "1r+300p"
    p0.r0 = "1r+10p"
    p0.show_links = "yes"
    p0.link_dims = "0p,0p,70p,0p,10p"
    p0.link_thickness = "2p"
    p0.link_color = "red"
    p0.label_snuggle = "yes"
    p0.max_snuggle_distance = "1r"
    p0.snuggle_tolerance = "0.25r"
    p0.sunggle_sampling = 2

    p1 = plots.plot_  # plus marker
    p1.type = "text"
    p1.color = "black"
    p1.label_font = "bold"
    p1.label_size = "40p"
    p1.file = plus_file
    p1.show_links = "no"

    p2 = plots.plot__  # GC histogram
    p2.type = "histogram"
    p2.file = gc_file
    p2.r1 = "0.615r"
    p2.r0 = "0.45r"
    p2.max = 1
    p2.min = 0
    p2.stroke_type = "line"
    p2.thickness = 2
    p2.color = "128,177,211"
    p2.extend_bin = "no"
    p2.fill_color = "128,177,211"
    ax = p2.axes.axis
    ax.spacing = "0.05r"
    ax.color = "lgrey"
    ax.thickness = 1
    ax2 = p2.axes.axis_
    ax2.position = "0.5r"
    ax2.color = "dred"
    ax2.thickness = 2

    if depth_file is not None:
        p3 = plots.plot___  # depth line
        p3.type = "line"
        p3.thickness = 2
        p3.max_gap = "1u"
        p3.skip_run = "yes"
        p3.file = depth_file
        p3.color = "dgreen"
        p3.min = 0
        p3.max = max_depth
        p3.r0 = "0.618r"
        p3.r1 = "0.768r"
        p3.fill_color = "190,186,218"
        dax = p3.axes.axis
        dax.color = "lgrey_a2"
        dax.thickness = 1
        dax.spacing = "0.06r"
        hi = p3.rules.rule
        hi.condition = f"var(value) > {int(max_depth * 0.9)}"
        hi.color = "20,227,117"
        hi.fill_color = "20,227,117"
        lo = p3.rules.rule_
        lo.condition = f"var(value) < {int(max_depth * 0.1)}"
        lo.color = "dred"
        lo.fill_color = "dred_a1"

    conf.highlights.highlight.file = feat_file
    return circos_dsl.circos_text(conf)
