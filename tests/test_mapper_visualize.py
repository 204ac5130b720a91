import os

import numpy as np
import pytest

from mitoflex_tpu.bio import circos as circos_dsl
from mitoflex_tpu.config import VisualizeConfig
from mitoflex_tpu.io import encoding
from mitoflex_tpu.io.fasta import FastaRecord
from mitoflex_tpu.ops import mapper
from mitoflex_tpu.stages import visualize as vis
from tests import synth


def _batchify(reads, max_len=128):
    from mitoflex_tpu.io.fastq import ReadBatch

    n = len(reads)
    seqs = np.full((n, max_len), 4, np.int8)
    lens = np.zeros(n, np.int32)
    for i, r in enumerate(reads):
        seqs[i, : len(r)] = encoding.encode(r)
        lens[i] = len(r)
    return ReadBatch(seqs, np.zeros_like(seqs), lens, n)


def test_mapper_places_reads(rng):
    g = synth.random_genome(rng, 3000)
    contig = FastaRecord("c1", g)
    reads = [g[i : i + 100] for i in range(0, 2000, 50)]
    rc_reads = [encoding.revcomp_str(g[i : i + 100]) for i in range(2000, 2800, 50)]
    junk = [synth.random_genome(rng, 100) for _ in range(10)]
    batch = _batchify(reads + rc_reads + junk)
    idx = mapper.ContigIndex.build([contig])
    m = mapper.map_batch(idx, batch.seqs, batch.lengths)
    n_fwd = len(reads)
    assert (m.contig[:n_fwd] == 0).all()
    np.testing.assert_array_equal(m.pos[:n_fwd], np.arange(0, 2000, 50))
    assert (m.strand[:n_fwd] == 1).all()
    n_rc = len(rc_reads)
    assert (m.contig[n_fwd : n_fwd + n_rc] == 0).all()
    assert (m.strand[n_fwd : n_fwd + n_rc] == -1).all()
    # random junk should not map
    assert (m.contig[n_fwd + n_rc :] == -1).all()


def test_mapper_batch_canonicalization(rng):
    """map_batch slices wide read buffers to the real max length and pads
    odd row counts to pow2 — results must be invariant to both, and odd-B
    batches must reuse the bucketed jit signature (no per-shape retrace)."""
    g = synth.random_genome(rng, 3000)
    idx = mapper.ContigIndex.build([FastaRecord("c1", g)])
    reads = [g[i : i + 100] for i in range(0, 1500, 50)]
    junk = [synth.random_genome(rng, 100) for _ in range(3)]
    narrow = _batchify(reads + junk, max_len=128)
    wide = _batchify(reads + junk, max_len=512)
    m_n = mapper.map_batch(idx, narrow.seqs, narrow.lengths)
    m_w = mapper.map_batch(idx, wide.seqs, wide.lengths)
    for f in ("contig", "pos", "strand", "votes", "raw_pos"):
        np.testing.assert_array_equal(getattr(m_n, f), getattr(m_w, f))
    assert m_n.contig.shape == (len(reads) + 3,)  # padding rows sliced off
    # odd B values inside one pow2 bucket share a compiled signature
    misses0 = mapper._map_device._cache_size()
    mapper.map_batch(idx, narrow.seqs[:31], narrow.lengths[:31])
    mapper.map_batch(idx, narrow.seqs[:17], narrow.lengths[:17])
    first = mapper._map_device._cache_size()
    mapper.map_batch(idx, narrow.seqs[:29], narrow.lengths[:29])
    assert mapper._map_device._cache_size() == first
    assert first <= misses0 + 1


def test_coverage_means(rng):
    g = synth.random_genome(rng, 1000)
    contig = FastaRecord("c1", g)
    reads = [g[i : i + 100] for i in range(0, 900, 10)]  # ~10x over most
    batch = _batchify(reads)
    depth, means, n_mapped, n_total = mapper.coverage_of_reads([contig], [batch])
    assert n_mapped == len(reads)
    assert 7 < means["c1"] < 11
    assert depth[0][500] >= 9


def test_circos_dsl():
    c = circos_dsl.Circos()
    c.ideogram.spacing.default = "0.01r"
    c.image.radius = "1500p"
    c.plot_.type = "histogram"
    c.plot__.type = "line"
    text = circos_dsl.circos_text(c)
    assert "<ideogram>" in text and "default = 0.01r" in text
    assert text.count("<plot>") == 2
    d = c.collapse()
    assert d["ideogram"]["spacing"]["default"] == "0.01r"
    # auto-vivified but unset nodes don't appear
    _ = c.some.deep.node
    assert "some" not in c.collapse()


def test_visualize_renders(tmp_path, rng):
    g = synth.random_genome(rng, 2000)
    rec = FastaRecord("scaffold1", g, {"flag": 1, "multi": 100, "len": 2000})
    locs = {
        "COX1": (100, 500, 0, "scaffold1", "+"),
        "ND1": (600, 900, 0, "scaffold1", "-"),
        "trnK": (950, 1020, 1, "scaffold1", "+"),
        "rrnS": (1100, 1700, 2, "scaffold1", "+"),
    }
    reads = [(g[i : i + 100], "I" * 100) for i in range(0, 1900, 40)]
    fq = synth.write_fastq(tmp_path / "r.fq", reads)
    outs = vis.visualize(
        VisualizeConfig(), [rec], locs, str(tmp_path / "plot"), fastq1=fq
    )
    assert os.path.exists(tmp_path / "plot.png")
    assert os.path.exists(tmp_path / "plot.svg")
    assert os.path.exists(tmp_path / "plot.tracks.json")
    assert os.path.exists(tmp_path / "plot.circos.conf")
    import json

    tracks = json.load(open(tmp_path / "plot.tracks.json"))
    assert tracks["karyotype"][0]["id"] == "mt1"
    assert len(tracks["genes"]) == 4
    assert tracks["depth_mean"]["mt1"] > 1.5

    # the circos track FILES the reference writes (visualize.py:72-168)
    # all exist and the conf references them, so `circos` can re-render
    conf_text = open(tmp_path / "plot.circos.conf").read()
    for name in ("gene.txt", "features.txt", "gc.txt", "depth.txt",
                 "karyotype.txt", "plus.txt"):
        p = tmp_path / f"plot.{name}"
        assert p.exists(), name
        assert str(p) in conf_text or name in conf_text, name
    assert "<<include etc/housekeeping.conf>>" in conf_text
    assert conf_text.count("<plot>") == 4
    assert "<highlight>" in conf_text and "<rules>" in conf_text
    # gene track rows: contig start end basename, tab separated
    gene_rows = [l.split("\t") for l in
                 open(tmp_path / "plot.gene.txt").read().splitlines()]
    assert ["mt1", "100", "500", "COX1"] in gene_rows
    # feature track: 3 rows per gene, body row carries the type color
    feat_lines = open(tmp_path / "plot.features.txt").read().splitlines()
    assert len(feat_lines) == 3 * 4
    assert any("r1=1.035r" in l for l in feat_lines)  # minus-strand band
    # depth file is per-base samtools-depth style: contig pos pos depth
    dline = open(tmp_path / "plot.depth.txt").readline().split()
    assert dline[0] == "mt1" and dline[1] == dline[2] == "1"


def test_gc_windows():
    codes = encoding.encode("GGGG" + "AAAA" + "GGCC" + "ATAT")
    gc = vis.gc_windows(codes, 4)
    np.testing.assert_allclose(gc, [1.0, 0.0, 1.0, 0.0])


def test_host_mapper_matches_device(rng):
    """_map_host must be bit-identical to _map_device: same winners, same
    tie handling (ambiguous best -> unmapped), same raw/clamped positions
    and strand preference — incl. reads with Ns, short rows, repeats and
    end overhangs (the CPU backend routes map_batch through it)."""
    import jax.numpy as jnp

    from mitoflex_tpu.io import encoding
    from mitoflex_tpu.io.fasta import FastaRecord
    from mitoflex_tpu.ops import mapper as M

    genome = synth.random_genome(rng, 3000)
    # a repeated segment so some reads are ambiguous
    genome = genome[:1200] + genome[200:500] + genome[1200:]
    contigs = [FastaRecord("a", genome[:1800]), FastaRecord("b", genome[1500:])]
    index = M.ContigIndex.build(contigs)

    B, L = 257, 128
    seqs = np.full((B, L), 4, np.int8)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        mode = i % 5
        if mode == 0:  # clean read inside a contig
            s = int(rng.integers(0, len(genome) - 100))
            frag = genome[s : s + 100]
        elif mode == 1:  # revcomp read
            s = int(rng.integers(0, len(genome) - 90))
            frag = encoding.revcomp_str(genome[s : s + 90])
        elif mode == 2:  # read overhanging a contig end
            frag = synth.random_genome(rng, 40) + genome[:60]
        elif mode == 3:  # junk
            frag = synth.random_genome(rng, 80)
        else:          # read with Ns + short
            s = int(rng.integers(0, len(genome) - 70))
            frag = genome[s : s + 35] + "N" + genome[s + 36 : s + 70]
        codes = encoding.encode(frag)
        seqs[i, : len(codes)] = codes
        lens[i] = len(codes)
    lens[7] = 0
    lens[11] = 9  # shorter than K

    host = M._map_host(index, seqs, lens, 2, M.SEED_STEP, M.MAX_MULT)
    dev = M._map_device(
        index.keys, index.contig_of, index.pos_of,
        jnp.asarray(seqs), jnp.asarray(lens), 2, M.SEED_STEP, M.MAX_MULT,
    )
    names = ("contig", "pos", "strand", "votes", "raw")
    for name, h, d in zip(names, host, dev):
        np.testing.assert_array_equal(h, np.asarray(d), err_msg=name)
    # sanity: a decent share actually mapped
    assert (host[0] >= 0).sum() > B // 2


def test_visualize_max_depth_reads_cap(tmp_path, rng):
    """visualize.max_depth_reads samples the depth-track remap (the
    depth ring is relative; bigrun caps at 400k reads instead of
    remapping 6.8M): capped run still renders a positive depth track."""
    g = synth.random_genome(rng, 2000)
    rec = FastaRecord("s1", g, {"flag": 1, "multi": 50, "len": 2000})
    locs = {"COX1": (100, 500, 0, "s1", "+")}
    reads = [(g[i : i + 100], "I" * 100) for i in range(0, 1900, 10)]
    fq = synth.write_fastq(tmp_path / "r.fq", reads)
    vis.visualize(VisualizeConfig(), [rec], locs, str(tmp_path / "cap"),
                  fastq1=fq, max_depth_reads=40)
    import json

    tracks = json.load(open(tmp_path / "cap.tracks.json"))
    assert tracks["depth_mean"]["mt1"] > 0
    # cap only SAMPLES the remap — gene/feature tracks are unaffected
    assert len(tracks["genes"]) == 1


def test_visualize_without_matplotlib(tmp_path, rng, monkeypatch):
    """Without matplotlib the stage still writes the tracks and the
    circos.conf (only the PNG/SVG map is skipped)."""
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    g = synth.random_genome(rng, 1500)
    rec = FastaRecord("scaffold1", g, {"flag": 1, "multi": 100, "len": 1500})
    locs = {"COX1": (100, 500, 0, "scaffold1", "+")}
    outs = vis.visualize(VisualizeConfig(), [rec], locs, str(tmp_path / "p"))
    assert not any(o.endswith((".png", ".svg")) for o in outs)
    assert os.path.exists(tmp_path / "p.tracks.json")
    assert os.path.exists(tmp_path / "p.circos.conf")
