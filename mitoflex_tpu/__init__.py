"""mitoflex_tpu — a JAX mitogenome analysis engine.

A from-scratch reimplementation of the capabilities of MitoFlex
(reference: /root/reference, an "almost all-in-one pipeline for Mitogenome
analysis from de novo NGS data", MitoFlex.py:59-71), redesigned for
JAX/XLA on an accelerator (one NVIDIA H100 is the reference device):

- read quality filtering runs as one fused XLA pass over batched reads
  instead of a Rust stream filter (reference filter/filter_bin);
- assembly is a sort-based de Bruijn graph engine built from XLA primitives
  (lax.sort / searchsorted / segment_sum / while_loop) over device-resident
  k-mer tables instead of shelling out to megahit_core;
- mito-candidate picking uses an on-device profile-HMM Viterbi scan
  (reference: nhmmer, annotation/annotation_tookit.py:510-548);
- annotation uses on-device six-frame translated search + codon-aware DP +
  covariance-model search (reference: tblastn/genewise/cmsearch);
- visualization renders the circular map with matplotlib (reference: circos).

Scale-out is data-parallel over reads/contigs via jax.sharding.Mesh with
psum/all_gather merges of k-mer histograms and hit tables.
"""

__version__ = "0.1.0"
