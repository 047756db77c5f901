"""
Multi-host execution (reference analogue: the process pools + pickled
queues of SURVEY §2.16; here: jax.distributed + host-sharded scaffolds).

Topology model:
  - hosts (DCN): each host owns a subset of scaffolds (greedy bin-packing
    by filtered-pair count — replacing the reference's runtime cost model,
    profile_controller.py:460-465) and decodes only the BAM records of its
    scaffolds (the .bai/linear index makes per-scaffold ranges seekable;
    full-scan decode is the fallback).
  - devices within a host: the position axis of each scaffold tiles
    across local devices (parallel/mesh.py); scaffold aggregates psum
    over the device links. Where several processes share a host, each is
    bound to one local device (`local_device_ids`), since a JAX process
    otherwise reserves memory on every device it sees.
  - final table assembly: per-host pandas tables concatenate via
    process_allgather (host gather over DCN).

This module is exercised in CI via the virtual-device mesh
(__graft_entry__.dryrun_multichip); real multi-host runs initialize with
`init_distributed` on each worker.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids: Optional[Sequence[int]] = None):
    """Initialize jax.distributed (no-op for single-process runs).
    `local_device_ids` limits this process to those devices of its host."""
    import jax
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    logging.info(f"jax.distributed: process {jax.process_index()} of "
                 f"{jax.process_count()}, {jax.local_device_count()} local "
                 f"devices")


def assign_scaffolds_to_hosts(scaffold_pairs: Dict[str, int],
                              n_hosts: int) -> List[List[str]]:
    """
    Greedy balanced assignment of scaffolds to hosts by filtered-pair
    count (largest-first into the lightest bin).
    """
    order = sorted(scaffold_pairs, key=scaffold_pairs.get, reverse=True)
    loads = [0] * n_hosts
    bins: List[List[str]] = [[] for _ in range(n_hosts)]
    for s in order:
        i = int(np.argmin(loads))
        bins[i].append(s)
        loads[i] += scaffold_pairs[s] + 1
    return bins


def my_scaffolds(scaffold_pairs: Dict[str, int]) -> List[str]:
    """The scaffolds this process owns under the canonical assignment."""
    import jax
    bins = assign_scaffolds_to_hosts(scaffold_pairs, jax.process_count())
    return bins[jax.process_index()]


def allgather_tables(local_tables):
    """
    Gather per-host pandas tables to every host (DCN). Single-process runs
    return the input unchanged. Payloads ride zlib-compressed (level 1:
    count/position arrays compress ~6x, shrinking the gather buffers and
    the padded-copy traffic), and the local shard is reused as-is instead
    of round-tripping through its own gathered row.
    """
    import jax
    if jax.process_count() == 1:
        return local_tables
    import pickle
    import zlib

    from jax.experimental import multihost_utils

    payload = np.frombuffer(
        zlib.compress(pickle.dumps(local_tables, protocol=5), 1),
        dtype=np.uint8)
    # pad to the max payload size across hosts
    sizes = multihost_utils.process_allgather(
        np.array([payload.size], dtype=np.int64))
    maxlen = int(sizes.max())
    padded = np.zeros(maxlen, dtype=np.uint8)
    padded[:payload.size] = payload
    gathered = multihost_utils.process_allgather(padded)
    me = jax.process_index()
    out = []
    for i, (row, size) in enumerate(zip(gathered, sizes.ravel())):
        if i == me:
            out.extend(local_tables)
        else:
            out.extend(pickle.loads(zlib.decompress(
                row[:int(size)].tobytes())))
    return out
