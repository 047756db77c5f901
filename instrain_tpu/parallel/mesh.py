"""
Multi-device execution of the real profile compute path over a
jax.sharding.Mesh.

The reference parallelizes profiling with process pools over 10 kb genome
windows plus a scaffold-level merge stage
(profile/profile_controller.py:157-193,243-271). The equivalent here
shards the SAME fused kernels the single-device engines run —
multi-device is an execution placement, not a separate code path:

- position sharding ("pos"): a scaffold's count tensor [M, 4, L] shards
  along L. Every heavy quantity in kernels.sitestats.site_stats is
  position-local, so the math runs embarrassingly parallel; the
  on-device compaction (compact_outputs_with_dense) jit-compiles with
  the sharded operands and XLA's SPMD partitioner inserts the
  collectives (psum for the per-mm scaffold aggregates, a distributed
  sort for the medians, all-gathers for the nonzero row compaction).
  Bit-identical to the single-device run whenever the bucket-padded
  position axis divides the mesh (tests/test_parallel.py asserts full
  SNV/scaffold/linkage table equality 1-vs-8 devices); with further
  mesh padding only the PRNG-based rarefied columns can shift (the
  counter-based draws are indexed by padded position).
- scaffold sharding ("s"): the batch engine's bucket stacks
  [S, Mp, 4, Lp] shard along S. Per-scaffold programs are independent,
  so this is the exact analogue of the reference's split-worker pool
  with devices replacing processes; results are bit-identical to the
  unsharded batch for every scaffold.

Both paths return the same CompactStats/HybridStats objects the
single-device engines produce, so tables/linkage/genes/storage run
unchanged downstream. Wired into profile() via ProfileConfig.mesh_devices
(CLI --mesh_devices).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "pos") -> Mesh:
    """1-D device mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def position_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """NamedSharding splitting the trailing (position) axis."""
    spec = [None] * ndim
    spec[-1] = mesh.axis_names[0]
    return NamedSharding(mesh, P(*spec))


def leading_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """NamedSharding splitting the leading (scaffold/batch) axis."""
    spec = [None] * ndim
    spec[0] = mesh.axis_names[0]
    return NamedSharding(mesh, P(*spec))


def place_position_sharded(counts: np.ndarray, ref_codes: np.ndarray,
                           mesh: Mesh) -> Tuple[jax.Array, jax.Array]:
    """Pad the position axis to a multiple of the mesh size (zero counts /
    ref code 4 — masked naturally downstream) and device_put both arrays
    sharded along it."""
    n = mesh.devices.size
    M, B, L = counts.shape
    Lp = -(-L // n) * n
    if Lp != L:
        cp = np.zeros((M, B, Lp), counts.dtype)
        cp[:, :, :L] = counts
        rp = np.full(Lp, 4, ref_codes.dtype)
        rp[:L] = ref_codes
        counts, ref_codes = cp, rp
    return (jax.device_put(counts, position_sharding(mesh, 3)),
            jax.device_put(ref_codes, position_sharding(mesh, 1)))


def place_batch_sharded(arrays: dict, mesh: Mesh) -> dict:
    """Pad every array's leading (scaffold) axis to a multiple of the mesh
    size and device_put sharded along it. Padding scaffolds carry zero
    counts and length 0, which the batch kernel masks out entirely."""
    n = mesh.devices.size
    S = next(iter(arrays.values())).shape[0]
    Sp = -(-S // n) * n
    out = {}
    for k, a in arrays.items():
        a = np.asarray(a)
        if Sp != S:
            pad = np.zeros((Sp - S,) + a.shape[1:], a.dtype)
            if k == "ref_codes":
                pad[:] = 4
            a = np.concatenate([a, pad], axis=0)
        out[k] = jax.device_put(a, leading_sharding(mesh, a.ndim))
    return out
