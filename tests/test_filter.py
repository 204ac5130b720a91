import numpy as np
import pytest

from mitoflex_tpu.config import FilterConfig
from mitoflex_tpu.io import fastq
from mitoflex_tpu.ops import filter as filter_ops
from mitoflex_tpu.stages import filter as filter_stage
from tests import synth


def _batch_from(seq_quals, max_len=64):
    n = len(seq_quals)
    cap = ((n + 127) // 128) * 128
    seqs = np.full((cap, max_len), 4, dtype=np.int8)
    quals = np.zeros((cap, max_len), dtype=np.int8)
    lengths = np.zeros(cap, dtype=np.int32)
    from mitoflex_tpu.io import encoding

    for i, (s, q) in enumerate(seq_quals):
        seqs[i, : len(s)] = encoding.encode(s)
        quals[i, : len(q)] = np.frombuffer(q.encode(), dtype=np.uint8)
        lengths[i] = len(s)
    return seqs, quals, lengths


def test_filter_rules():
    good = ("ACGT" * 10, "I" * 40)
    too_many_ns = ("N" * 11 + "A" * 29, "I" * 40)
    few_ns = ("N" * 10 + "A" * 30, "I" * 40)          # exactly at valve -> kept
    low_qual = ("ACGT" * 10, "#" * 40)                 # '#'=35 <= 55 -> all bad
    borderline_qual = ("ACGT" * 10, "#" * 7 + "I" * 33)  # 7/40 < 0.2 -> kept
    at_threshold = ("ACGT" * 10, "#" * 8 + "I" * 32)     # 8/40 = 0.2 -> dropped
    seqs, quals, lengths = _batch_from(
        [good, too_many_ns, few_ns, low_qual, borderline_qual, at_threshold]
    )
    keep, h1, h2 = filter_ops.filter_reads(seqs, quals, lengths, 10, 55, 0.2)
    keep = np.asarray(keep)
    assert keep[:6].tolist() == [True, False, True, False, True, False]
    # padding rows (length 0) never kept
    assert not keep[6:].any()


def test_filter_hash_distinguishes_reads():
    a = ("ACGTACGT", "IIIIIIII")
    b = ("ACGTACGA", "IIIIIIII")
    seqs, quals, lengths = _batch_from([a, b, a])
    _, h1, h2 = filter_ops.filter_reads(seqs, quals, lengths, 10, 55, 0.2)
    h1, h2 = np.asarray(h1), np.asarray(h2)
    assert h1[0] == h1[2] and h2[0] == h2[2]
    assert (h1[0], h2[0]) != (h1[1], h2[1])


def test_filter_stage_se(tmp_path, rng):
    genome = synth.random_genome(rng, 2000)
    reads = synth.shotgun_reads(rng, genome, 200, read_len=100)
    # corrupt some reads
    bad = [("N" * 50 + "A" * 50, "I" * 100), ("ACGT" * 25, "#" * 100)]
    all_reads = reads + bad * 5
    p = synth.write_fastq(tmp_path / "in.fq", all_reads)
    cfg = FilterConfig(batch_reads=128, max_read_len=128)
    res = filter_stage.filter_reads(cfg, p, str(tmp_path / "clean.fq"))
    assert res.reads_in == 210
    assert res.reads_kept == 200
    back = list(fastq.FastqStream(str(tmp_path / "clean.fq")))
    assert len(back) == 200


def test_filter_stage_gzip_output(tmp_path, rng):
    """compress_output writes valid gzip (configurations.py:45-48); the
    CLI path also carries the .gz suffix (MitoFlex.py:280-282)."""
    import gzip
    import json
    import os
    import subprocess
    import sys

    genome = synth.random_genome(rng, 1500)
    reads = synth.shotgun_reads(rng, genome, 80, read_len=100)
    p = synth.write_fastq(tmp_path / "in.fq", reads)
    conf = tmp_path / "c.py"
    conf.write_text("config = {'filter': {'compress_output': True}}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="/root/repo")
    r = subprocess.run(
        [sys.executable, "-m", "mitoflex_tpu", "filter", "--fastq1", p,
         "--workname", "gz", "--config", str(conf)],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=600,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(next(
        l for l in r.stdout.splitlines() if l.startswith("{")
    ))
    assert out["clean1"].endswith(".gz")
    path = tmp_path / out["clean1"]
    with gzip.open(path, "rt") as f:
        assert sum(1 for _ in f) == 4 * out["reads_kept"]


def test_filter_stage_pe_dedup(tmp_path, rng):
    genome = synth.random_genome(rng, 3000)
    pairs = synth.shotgun_reads(rng, genome, 80, read_len=90, insert=250)
    pairs = pairs + pairs[:10]  # exact duplicates
    p1 = synth.write_fastq(tmp_path / "r1.fq", [p[0] for p in pairs])
    p2 = synth.write_fastq(tmp_path / "r2.fq", [p[1] for p in pairs])
    cfg = FilterConfig(batch_reads=128, max_read_len=128, deduplication=True)
    res = filter_stage.filter_reads(
        cfg, p1, str(tmp_path / "c1.fq"), p2, str(tmp_path / "c2.fq")
    )
    assert res.reads_in == 90
    assert res.duplicates >= 10
    assert res.reads_kept == 90 - res.duplicates
    c1 = list(fastq.FastqStream(str(tmp_path / "c1.fq")))
    c2 = list(fastq.FastqStream(str(tmp_path / "c2.fq")))
    assert len(c1) == len(c2) == res.reads_kept


def test_filter_stage_truncate_only(tmp_path, rng):
    reads = [("N" * 100, "#" * 100)] * 20  # all would fail filters
    p = synth.write_fastq(tmp_path / "in.fq", reads)
    cfg = FilterConfig(batch_reads=128, max_read_len=128, truncate_only=True)
    res = filter_stage.filter_reads(cfg, p, str(tmp_path / "clean.fq"))
    assert res.reads_kept == 20


def test_keep_region_trim(tmp_path, rng):
    reads = [("A" * 10 + "C" * 80 + "G" * 10, "I" * 100)] * 3
    p = synth.write_fastq(tmp_path / "in.fq", reads)
    cfg = FilterConfig(batch_reads=128, max_read_len=128, keep_region=(10, 90))
    res = filter_stage.filter_reads(cfg, p, str(tmp_path / "clean.fq"))
    back = list(fastq.FastqStream(str(tmp_path / "clean.fq")))
    assert back[0][1].decode() == "C" * 80
