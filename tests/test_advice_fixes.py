"""Regression tests for the round-1 advisor findings (ADVICE.md) and
VERDICT.md weak #1 (logger.warning AttributeError)."""

import math
import os
import types

import numpy as np
import pandas as pd
import pytest

from mitoflex_tpu.utils.logger import RunLogger


def test_logger_warning_alias(capsys):
    """RunLogger exposes stdlib-style .warning (VERDICT weak #1: the
    duplicate-filter-HMM path in models/cmsearch.py calls it)."""
    lg = RunLogger()
    lg.warning("heads up")
    out = capsys.readouterr().out
    assert "WARN" in out and "heads up" in out


def test_duplicate_filter_hmm_name_warns(monkeypatch, capsys):
    """Two CMs whose embedded p7 filters share a NAME must warn and keep
    the first mapping, not crash (models/cmsearch.py:80-88)."""
    from mitoflex_tpu.models import cmsearch, nhmmer

    hmm = types.SimpleNamespace(name="dup")
    m1 = types.SimpleNamespace(filter_hmm=hmm)
    m2 = types.SimpleNamespace(filter_hmm=hmm)
    monkeypatch.setattr(
        nhmmer, "nhmmer_search",
        lambda *a, **kw: pd.DataFrame(
            columns=["query", "target", "score", "e", "alifrom", "alito",
                     "strand", "hmmfrom", "hmmto"]),
    )
    out = cmsearch._filter_scan_multi({"a": m1, "b": m2}, [], 1e-3)
    assert out == {"a": [], "b": []}
    assert "duplicate filter-HMM name dup" in capsys.readouterr().out


def test_cm_evalue_survival_clamped():
    """E-values never exceed the effective search-space size: the
    exponential-tail survival term clamps at 1.0 for scores below
    mu_extrap (Infernal esl_exp_surv semantics)."""
    from mitoflex_tpu.models.cm import cm_evalue

    # (lambda, mu_extrap, mu_orig, dbsize, nhits, tailp)
    model = types.SimpleNamespace(
        stats={"ECMLC": (0.65, 5.0, 5.0, 1_000_000.0, 100.0, 0.01)})
    eff = 100.0 * 2_000.0 / 1_000_000.0
    e_low = cm_evalue(model, -50.0, 2_000.0)   # far below mu: surv == 1
    assert e_low == pytest.approx(eff)
    e_hi = cm_evalue(model, 30.0, 2_000.0)
    assert e_hi == pytest.approx(eff * math.exp(-0.65 * 25.0))
    assert e_hi < e_low


@pytest.mark.skipif(
    not os.path.isfile("/root/reference/profile/tRNA_CM/Metazoa_K.cm"),
    reason="reference CMs not mounted")
def test_local_config_begin_mass_sums_to_one():
    """local_config begin scores form a probability distribution even for
    degenerate guide trees (ADVICE: node 1 not a begin candidate)."""
    from mitoflex_tpu.models import cm as cm_models

    model = cm_models.load_cm_file(
        "/root/reference/profile/tRNA_CM/Metazoa_K.cm")[0]
    lc = cm_models.local_config(model)
    mass = float(np.sum(np.exp2(lc.begin_sc[np.isfinite(lc.begin_sc)])))
    assert mass == pytest.approx(1.0, rel=1e-6)


def test_cli_fractional_trimming(tmp_path):
    """--trimming 0.5 (fractional Gbp, reference arguments.py:215) parses
    instead of crashing on int('0.5') (ADVICE #1)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="/root/repo")
    r = subprocess.run(
        [sys.executable, "-m", "mitoflex_tpu", "filter", "--fastq1", "x.fq",
         "--trimming", "0.5", "--generate-config", "conf.py"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "'trimming': 0.5" in open(tmp_path / "conf.py").read()
    # garbage still exits through the config-error path, not a traceback
    r2 = subprocess.run(
        [sys.executable, "-m", "mitoflex_tpu", "filter", "--fastq1", "x.fq",
         "--trimming", "lots"],
        capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=300,
    )
    assert r2.returncode == 2
    assert "config error" in r2.stderr
    assert "Traceback" not in r2.stderr


# --- Round-2 advisor findings ---


def test_mapped_batch_raw_pos_required():
    """MappedBatch.raw_pos is a required field (round-2 advice #1): a
    construction omitting it must fail instead of producing a batch that
    crashes _extend_ends later."""
    from mitoflex_tpu.ops.mapper import MappedBatch

    with pytest.raises(TypeError):
        MappedBatch(
            np.full(2, -1, np.int32), np.zeros(2, np.int32),
            np.ones(2, np.int8), np.zeros(2, np.int32),
        )


def test_read_batch_shrink_copies():
    """shrink() must not alias the full-capacity buffers (round-2 advice
    #2): the shrunk arrays own their memory."""
    from mitoflex_tpu.io.fastq import ReadBatch

    cap, L = 1024, 8
    rb = ReadBatch(
        np.zeros((cap, L), np.int8), np.zeros((cap, L), np.int8),
        np.zeros(cap, np.int32), 10, ["r%d" % i for i in range(10)],
    )
    small = rb.shrink(floor=16)
    assert small.seqs.shape[0] == 16
    for arr in (small.seqs, small.quals, small.lengths):
        assert arr.base is None, "shrunk batch aliases the parent buffer"


# --- Round-3 advisor findings + VERDICT round-3 weak items ---


def test_local_extend_empty_contigs():
    """local_extend([]) is a no-op, not an IndexError (round-3 advice #1:
    clens[...] on a size-0 array)."""
    from mitoflex_tpu.stages import assemble as asm

    def src():
        seqs = np.zeros((4, 64), np.int8)
        lens = np.full(4, 64, np.int32)
        yield seqs, lens

    assert asm.local_extend([], src) == []


def test_map_batch_empty_rows():
    """map_batch with B == 0 short-circuits instead of padding to 256 rows
    and tracing the device kernel (round-3 advice #2)."""
    from mitoflex_tpu.io.fasta import FastaRecord
    from mitoflex_tpu.ops import mapper

    index = mapper.ContigIndex.build([FastaRecord("c", "ACGT" * 40)])
    m = mapper.map_batch(index, np.zeros((0, 100), np.int8),
                         np.zeros(0, np.int32))
    assert m.contig.shape == (0,)


def test_kmer_counter_merged_memoized(rng):
    """.keys/.counts/solid() share ONE merge; add_chunk invalidates
    (round-3 VERDICT weak #5)."""
    from mitoflex_tpu.stages.assemble import KmerCounter

    seqs = rng.integers(0, 4, (8, 64)).astype(np.int8)
    lens = np.full(8, 64, np.int32)
    c = KmerCounter(21)
    c.add_chunk(seqs, lens)
    m1 = c._merged()
    assert c._merged() is m1, "second access re-ran the merge"
    k1 = c.keys
    assert k1 is m1[0]
    c.add_chunk(seqs, lens)
    m2 = c._merged()
    assert m2 is not m1
    np.testing.assert_array_equal(m2[0], m1[0])
    np.testing.assert_array_equal(m2[1], m1[1] * 2)


def test_final_clean_round_masks_applied(rng):
    """When the cleaning fixpoint exhausts max_clean_rounds, the last
    round's kill masks still apply: a long low-depth unitig flagged by
    prune_depth in the final round cannot leak into the output contigs
    (round-3 VERDICT weak #3). Tips never hit this (they are shorter than
    the min_standalone gate); the leak case is depth-pruned unitigs."""
    from mitoflex_tpu.io import encoding
    from mitoflex_tpu.stages import assemble as asm
    from mitoflex_tpu.stages import graph_clean
    from tests import synth

    genome = synth.random_genome(rng, 600)
    contam = synth.random_genome(rng, 220)
    k = 21
    reads = [genome[i : i + 80] for i in range(0, 521, 4)] * 2
    # contaminant at depth ~2.7 — below prune_depth, above min_multi;
    # stride < read_len - k so its k-mer coverage is gap-free (one unitig)
    reads += [contam[i : i + 80] for i in range(0, 141, 29)]

    def src():
        seqs = np.full((len(reads), 96), 4, np.int8)
        lens = np.zeros(len(reads), np.int32)
        for i, r in enumerate(reads):
            seqs[i, : len(r)] = encoding.encode(r)
            lens[i] = len(r)
        yield seqs, lens

    keys, counts = asm.count_edges(src, k, 2)
    clean = graph_clean.CleanParams(prune_depth=3, prune_level=0,
                                    bubble_level=0, disconnect_ratio=0,
                                    low_local_ratio=0)
    # only ONE cleaning round: the contaminant is flagged in it, and the
    # loop exhausts without converging — the mask must still take effect
    contigs, _ = asm.assemble_k(keys, counts, k, clean, min_standalone=100,
                                max_clean_rounds=1)
    assert contigs
    probe = contam[60:120]
    rc = encoding.revcomp_str(probe)
    for c in contigs:
        assert probe not in c.seq and rc not in c.seq, \
            "final round's low-depth mask was discarded"
