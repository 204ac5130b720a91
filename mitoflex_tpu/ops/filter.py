"""Read quality-filter kernel.

Device replacement of the reference's Rust stream filter
(filter/filter_bin/src/main.rs:188-323): per read, over the valid length —

- count Ns (code 4); drop the read if the count exceeds ``ns_valve``;
- count "bad" bases whose raw phred+33 byte is <= ``quality_valve``;
  drop if bad_count >= floor(f32(cutoff_len) * f32(percentage_valve)) —
  the float32 truncation mirrors the reference's `(len as f32 * limit) as
  usize` exactly, and ``cutoff_len`` is read 1's length for BOTH mates of
  a pair (main.rs:236-241 computes one cutoff from seq1);
- emit a 64-bit rolling hash of the base codes (two independent 32-bit
  polynomial hashes) used for optional PE deduplication
  (main.rs:325 ``calculate_hash``).

The decision is a pure per-row reduction over a [reads, max_len] tile:
elementwise work plus row sums, which XLA fuses into one pass over device
memory, so plain jnp is the kernel.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

N_CODE = 4
# polynomial hash bases (odd => invertible mod 2^32, good mixing)
_HASH_B1 = np.uint32(0x01000193)  # FNV prime
_HASH_B2 = np.uint32(0x85EBCA6B)  # murmur3 c2


def _hash_powers(max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    p1 = np.empty(max_len, dtype=np.uint32)
    p2 = np.empty(max_len, dtype=np.uint32)
    a1 = np.uint32(1)
    a2 = np.uint32(1)
    with np.errstate(over="ignore"):
        for i in range(max_len):
            p1[i] = a1
            p2[i] = a2
            a1 = np.uint32(a1 * _HASH_B1)
            a2 = np.uint32(a2 * _HASH_B2)
    return p1, p2


def quality_cutoffs(cutoff_lengths: jax.Array, percentage_valve: float) -> jax.Array:
    """floor(f32(len) * f32(limit)) as int — the exact bad-base cutoff the
    reference computes (main.rs:236 `(seq1.len() as f32 * limit) as usize`).
    A read is dropped when bad_count >= cutoff; cutoff 0 drops everything
    (including empty reads)."""
    return jnp.floor(
        cutoff_lengths.astype(jnp.float32) * jnp.float32(percentage_valve)
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("ns_valve", "quality_valve", "percentage_valve"))
def filter_reads_ref(
    seqs: jax.Array,      # [B, L] int8 base codes
    quals: jax.Array,     # [B, L] int8 raw phred+33 bytes
    lengths: jax.Array,   # [B] int32
    ns_valve: int,
    quality_valve: int,
    percentage_valve: float,
    cutoff_lengths: jax.Array | None = None,  # [B] int32; PE passes mate 1's
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Returns (keep [B] bool, hash1 [B] uint32, hash2 [B] uint32)."""
    B, L = seqs.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (B, L), 1)
    valid = col < lengths[:, None]
    n_count = jnp.sum(jnp.logical_and(seqs == N_CODE, valid), axis=1)
    bad = jnp.sum(
        jnp.logical_and(quals.astype(jnp.int32) <= quality_valve, valid), axis=1
    )
    cutoff = quality_cutoffs(
        lengths if cutoff_lengths is None else cutoff_lengths, percentage_valve
    )
    keep = jnp.logical_and(n_count <= ns_valve, bad < cutoff)
    p1, p2 = _hash_powers(L)
    s = jnp.where(valid, seqs.astype(jnp.uint32) + 1, 0)
    h1 = jnp.sum(s * jnp.asarray(p1)[None, :], axis=1, dtype=jnp.uint32)
    h2 = jnp.sum(s * jnp.asarray(p2)[None, :], axis=1, dtype=jnp.uint32)
    return keep, h1, h2


def filter_reads(
    seqs,
    quals,
    lengths,
    ns_valve: int,
    quality_valve: int,
    percentage_valve: float,
    cutoff_lengths=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Host-facing entry: moves the batch to the device and runs
    :func:`filter_reads_ref`, which XLA fuses into one pass."""
    cl = None if cutoff_lengths is None else jnp.asarray(cutoff_lengths)
    return filter_reads_ref(
        jnp.asarray(seqs), jnp.asarray(quals), jnp.asarray(lengths),
        ns_valve, quality_valve, percentage_valve, cl,
    )
