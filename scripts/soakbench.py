"""kmin-path soak at 1-2 orders above the test-suite scale (round-3
VERDICT directive #3): a synthetic nuclear background + deep mitogenome,
streamed through the REAL production counting/graph path —
KmerCounter (device LSM + disk spill) -> palindrome-aware gate ->
expand -> graph fixpoint (assemble_k) -> depth gate -> mito recovery —
with per-phase wall clocks and peak RSS measured, not projected.

Default fixture: 4 Mbp nuclear at ~15x + 16 kb mito at ~800x with 1%
errors (~0.07 Gbp of reads — sized to this sandbox's ~200 MB/s DRAM;
MITOFLEX_SOAK_MBP scales the nuclear side, MITOFLEX_SOAK_DEPTH the
background depth, MITOFLEX_SOAK_SKIP_GRAPH=1 measures counting alone at
north-star read volumes). Reads are generated in-memory
chunk by chunk (no multi-GB files): the soak measures the count/LSM/
graph terms PERF.md previously only projected — ingestion is bounded
separately by the filter bench.

Prints ONE JSON line. Run standalone or via ``bench.py`` (--child-soak).
"""

from __future__ import annotations

import json
import os
import resource
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def main() -> int:
    import jax

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        # the soak measures host terms (LSM spill, gate, graph fixpoint);
        # bench.py runs it on the CPU backend. Device-side rates are
        # measured by bench.py's device child.
        jax.config.update("jax_platforms", "cpu")

    from mitoflex_tpu.io import encoding
    from mitoflex_tpu.ops import kmer as kmer_ops
    from mitoflex_tpu.stages import assemble as asm
    from mitoflex_tpu.stages import graph_clean

    backend = jax.default_backend()
    nuclear_mbp = float(os.environ.get("MITOFLEX_SOAK_MBP", "4"))
    depth = float(os.environ.get("MITOFLEX_SOAK_DEPTH", "15"))
    mito_depth = float(os.environ.get("MITOFLEX_SOAK_MITO_DEPTH", "800"))
    err = 0.01
    L = 150
    k = 21
    min_multi = 3
    chunk_reads = int(os.environ.get("MITOFLEX_SOAK_CHUNK", str(1 << 16)))

    rng = np.random.default_rng(2024)
    nuc = rng.integers(0, 4, int(nuclear_mbp * 1e6)).astype(np.int8)
    mito_len = 16000
    mito = rng.integers(0, 4, mito_len).astype(np.int8)
    # circular mito: double it so windows wrap
    mito2 = np.concatenate([mito, mito[:L]])

    n_nuc_reads = int(len(nuc) * depth / L)
    n_mito_reads = int(mito_len * mito_depth / L)
    total_reads = n_nuc_reads + n_mito_reads
    total_bases = total_reads * L
    print(f"# soak: backend={backend} {total_bases/1e9:.2f} Gbp "
          f"({n_nuc_reads} nuclear + {n_mito_reads} mito reads)",
          file=sys.stderr, flush=True)

    col = np.arange(L)

    def gen_chunk(r, n):
        """n reads sampled from both sources at their global ratio."""
        n_m = max(int(n * n_mito_reads / total_reads), 1)
        n_n = n - n_m
        s_n = r.integers(0, len(nuc) - L, n_n)
        s_m = r.integers(0, mito_len, n_m)
        rows = np.concatenate([
            nuc[s_n[:, None] + col[None, :]],
            mito2[s_m[:, None] + col[None, :]],
        ])
        e = r.random(rows.shape) < err
        rows[e] = (rows[e] + r.integers(1, 4, int(e.sum()))) % 4
        return rows, np.full(len(rows), L, np.int32)

    spill_dir = os.environ.get("MITOFLEX_SOAK_SPILL_DIR") or None
    # CPU default spill threshold is LOW (8.4M rows) so even the default
    # driver-sized soak exercises the disk-bucketed LSM — round-4 VERDICT
    # weak #1: the at-scale spill claims must be reproducible from
    # bench.py, not PERF.md prose. Override with MITOFLEX_SOAK_SPILL_ROWS.
    spill_rows = int(os.environ.get(
        "MITOFLEX_SOAK_SPILL_ROWS",
        str(1 << 27 if backend != "cpu" else 1 << 23),
    ))
    counter = asm.KmerCounter(
        k + 1, canonical=True,
        max_device_rows=1 << 26 if backend != "cpu" else 1 << 24,
        spill_rows=spill_rows,
        spill_dir=spill_dir,
    )
    gen_rng = np.random.default_rng(7)
    t0 = time.perf_counter()
    t_gen = 0.0
    done = 0
    while done < total_reads:
        n = min(chunk_reads, total_reads - done)
        g0 = time.perf_counter()
        # fixed chunk shape (zero-length pad rows) — one compile, not one
        # per trailing-chunk size
        rows, lens = gen_chunk(gen_rng, chunk_reads)
        lens[n:] = 0
        t_gen += time.perf_counter() - g0
        counter.add_chunk(rows, lens)
        done += n
    # count wall excludes the (host-side, overlappable) generation term
    t_count = time.perf_counter() - t0 - t_gen
    print(f"# soak: count {t_count:.1f}s (+{t_gen:.1f}s synth) "
          f"rss {_rss_gb():.2f} GB", file=sys.stderr, flush=True)

    from mitoflex_tpu.io.prefetch import prefetch

    t0 = time.perf_counter()
    sk, sc = [], []
    n_distinct = 0
    # same bucket pipelining as the production gate (count_edges)
    with prefetch(counter.merged_iter(), 1) as gate_src:
        for keys, counts in gate_src:
            n_distinct += len(counts)
            rc = kmer_ops.np_revcomp_keys(keys, k + 1)
            palin = (keys == rc).all(axis=1)
            eff = np.where(palin, counts * 2, counts)
            mask = eff >= min_multi
            if mask.any():
                sk.append(keys[mask])
                sc.append(counts[mask])
    if sk:
        keys, counts = kmer_ops.expand_canonical(
            np.concatenate(sk), np.concatenate(sc), k + 1
        )
    else:
        keys = np.zeros((0, kmer_ops.num_words(k + 1)), np.uint32)
        counts = np.zeros(0, np.uint64)
    t_gate = time.perf_counter() - t0
    print(f"# soak: gate+expand {t_gate:.1f}s "
          f"({n_distinct/1e6:.1f}M distinct -> {len(counts)/1e6:.1f}M solid "
          f"edges) rss {_rss_gb():.2f} GB peak_host_rows "
          f"{counter.peak_host_rows/1e6:.1f}M", file=sys.stderr, flush=True)

    skip_graph = os.environ.get("MITOFLEX_SOAK_SKIP_GRAPH") == "1"
    t_graph = None
    mito_ok = None
    if not skip_graph:
        t0 = time.perf_counter()
        clean = graph_clean.CleanParams(prune_depth=2, prune_level=2,
                                        bubble_level=2)
        contigs, _ = asm.assemble_k(keys, counts, k, clean, min_standalone=200,
                                    max_clean_rounds=3)
        t_graph = time.perf_counter() - t0
        print(f"# soak: graph+clean+unitig {t_graph:.1f}s "
              f"({len(contigs)} contigs) rss {_rss_gb():.2f} GB",
              file=sys.stderr, flush=True)

        # the MitoFlex twist: the depth gate isolates the mitogenome
        gated = asm.filter_contigs(contigs, mito_depth / 8, 200, 30000)
        best = max(gated, key=lambda c: len(c.seq), default=None)
        mito_ok = False
        if best is not None and len(best.seq) >= mito_len:
            mito_str = "".join("ACGT"[b] for b in mito2)
            probe = best.seq[:200]
            mito_ok = (probe in mito_str
                       or encoding.revcomp_str(probe) in mito_str)
    spill_bytes = (
        int(counter._spill.bytes_written) if counter._spill is not None else 0
    )
    from mitoflex_tpu.native import graph_native

    print(json.dumps({
        "soak_gbp": round(total_bases / 1e9, 3),
        "soak_count_wall_s": round(t_count, 1),
        "soak_gate_wall_s": round(t_gate, 1),
        "soak_graph_wall_s": round(t_graph, 1) if t_graph is not None else None,
        "soak_distinct_m": round(n_distinct / 1e6, 1),
        "soak_solid_edges_m": round(len(counts) / 1e6, 1),
        "soak_peak_rss_gb": round(_rss_gb(), 2),
        "soak_peak_host_rows_m": round(counter.peak_host_rows / 1e6, 1),
        "soak_spilled": counter._spill is not None,
        "soak_spill_bytes_gb": round(spill_bytes / 1e9, 3),
        "soak_graph_native": graph_native._lib() is not None,
        "soak_mito_recovered": (bool(mito_ok) if mito_ok is not None else None),
        "backend": backend,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
