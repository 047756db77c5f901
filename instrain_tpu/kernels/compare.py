"""
Compare-stack device kernel: all-pairs coverage-overlap counting as a
matrix product.

The compare operation's dense work is, per scaffold and mm level, the
pairwise overlap of per-sample coverage-threshold masks
(reference: readComparer.calc_mm2overlap, readComparer.py:145-191 —
`coverage_overlap`, `compared_bases_count`, and the conANI/popANI
denominators all derive from |t_i & t_j| and |t_i| + |t_j|). For N
samples that is an N x N Gram matrix of 0/1 vectors — exactly a matmul:
stack the masks as a bf16 0/1 tensor and compute
einsum("nml,kml->mnk") with f32 accumulation (XLA hands it to cuBLAS on
the GPU). It is exact: bf16 holds 0 and 1 exactly, products are 0/1,
and per-chunk sums stay far below 2^24, so no TF32 rounding can enter.

The wire format is bit-packed (uint8, 8 positions/byte) so h2d moves
L/8 bytes per (sample, mm); unpacking to bf16 happens on device. Long
scaffolds are chunked on the position axis and the int32 partial counts
accumulate on host — the result is exact for any length.

Host path (CPU backend / small workloads): uint64 AND + popcount
(np.bitwise_count), identical integers.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# position-axis chunk per device call: 2^22 positions = 512 KB packed
# per (sample, mm) row; keeps per-chunk f32 accumulation far below 2^24
CHUNK_BITS = 1 << 22


@jax.jit
def _overlap_counts_device(packed):
    """packed: uint8 [N, Mg, W] bit-packed masks (big-endian bit order,
    np.packbits default). Returns (both [Mg, N, N] int32,
    single [Mg, N] int32)."""
    bits = jnp.unpackbits(packed, axis=-1)          # [N, Mg, W*8]
    x = bits.astype(jnp.bfloat16)
    both = jnp.einsum("nml,kml->mnk", x, x,
                      preferred_element_type=jnp.float32)
    single = bits.sum(axis=-1, dtype=jnp.int32).T   # [Mg, N]
    return both.astype(jnp.int32), single


def pairwise_overlap_counts_device(masks: List[np.ndarray]
                                   ) -> Tuple[np.ndarray, np.ndarray]:
    """masks: per-sample [Mg, L] bool arrays (same shape). Returns
    (both [Mg, N, N], single [Mg, N]) int64 — |t_i & t_j| and |t_i| per
    mm level."""
    n = len(masks)
    mg, L = masks[0].shape
    both = np.zeros((mg, n, n), np.int64)
    single = np.zeros((mg, n), np.int64)
    for c0 in range(0, L, CHUNK_BITS):
        c1 = min(c0 + CHUNK_BITS, L)
        packed = np.stack([np.packbits(m[:, c0:c1], axis=-1)
                           for m in masks])         # [N, Mg, W]
        b, s = _overlap_counts_device(packed)
        both += np.asarray(b, dtype=np.int64)
        single += np.asarray(s, dtype=np.int64)
    return both, single


def pairwise_overlap_counts_host(masks: List[np.ndarray]
                                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Host path: uint64 popcount over packed words (np.bitwise_count).
    Bit-identical to the device path."""
    n = len(masks)
    mg, L = masks[0].shape
    packed = [np.packbits(m, axis=-1) for m in masks]
    words = []
    for p in packed:
        w = p
        pad = (-w.shape[-1]) % 8
        if pad:
            w = np.pad(w, [(0, 0), (0, pad)])
        words.append(w.view(np.uint64))
    both = np.zeros((mg, n, n), np.int64)
    single = np.zeros((mg, n), np.int64)
    for i in range(n):
        single[:, i] = np.bitwise_count(words[i]).sum(axis=-1)
        for j in range(i, n):
            c = np.bitwise_count(words[i] & words[j]).sum(axis=-1)
            both[:, i, j] = c
            both[:, j, i] = c
    return both, single
