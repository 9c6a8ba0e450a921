"""Multi-chip / multi-host SPMD execution support.

The device replacement for the reference's pthread pipeline (reference
transcode.cpp:1491-1500, feed.h:281-456): reads are pure data
parallelism, so the entire scale-out story is a 1-D ``reads`` mesh —
the cards of one host, which NVLink joins all to all, and hosts joined
over the network with ``jax.distributed.initialize``. Barcode panels and
the substitution LUT are replicated per card; the decode step psums its per-decoder counters
inside the shard_map (device/step.py), which is the exact collective
analog of ``Transcode::collect`` merging thread-local accumulators
(reference transcode.cpp:317-320). Host-side float64 accumulators (the
report path) merge by elementwise sum at finalize.

Input sharding across hosts is round-robin over read batches: host k of H
processes batches k, k+H, k+2H, ... of its feeds — each host reads a
disjoint slice, no coordination required, and merged statistics are
order-insensitive sums.
"""

from __future__ import annotations

import os

import numpy as np


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Initialize JAX distributed from args or the standard environment
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID). Returns
    (process_id, num_processes); (0, 1) when running single-host."""
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return 0, 1
    num_processes = int(
        num_processes
        if num_processes is not None
        else os.environ.get("JAX_NUM_PROCESSES", 1)
    )
    process_id = int(
        process_id
        if process_id is not None
        else os.environ.get("JAX_PROCESS_ID", 0)
    )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return process_id, num_processes


def reads_mesh(devices=None):
    """1-D data-parallel mesh over all (global) devices."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), ("reads",))


def host_batch_slices(process_id: int, num_processes: int):
    """Infinite round-robin predicate: does this host own batch `index`?"""

    def owns(index: int) -> bool:
        return index % num_processes == process_id

    return owns


def merge_host_accumulators(engines: list) -> None:
    """Merge per-shard host accumulators into the first engine's — the
    DCN-side analog of Transcode::collect for the float64 report state.
    Every field is a sum/min/max, so merging is order-insensitive."""
    if len(engines) <= 1:
        return
    primary = engines[0]
    for other in engines[1:]:
        for mine, theirs in zip(primary._runtimes, other._runtimes):
            mine.accumulator.collect(theirs.accumulator)
        primary.incoming_count += other.incoming_count
        primary.incoming_pf_count += other.incoming_pf_count
        primary.outgoing_count += other.outgoing_count
        primary.outgoing_pf_count += other.outgoing_pf_count
        if primary.channel_quality is not None and other.channel_quality:
            for mine, theirs in zip(
                primary.channel_quality, other.channel_quality
            ):
                mine.merge(theirs)
