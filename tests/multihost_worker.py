"""Worker for the N-process multi-host integration test: each process
decodes its slice of a deterministic batch over the global mesh (2 local
devices per process) and verifies the psum-merged counters equal the
single-process result."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main(process_id: int, coordinator: str, num_processes: int = 2):
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    import numpy as np
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from pheniqs_tpu.device.distributed import reads_mesh
    from pheniqs_tpu.device.flagship import (
        flagship_instrument,
        flagship_ontology,
        synthetic_batch,
    )
    from pheniqs_tpu.device.step import make_decode_step, make_sharded_decode_step

    instrument = flagship_instrument(sample_barcodes=8, cellular_barcodes=16)
    ontology = flagship_ontology(sample_barcodes=8, cellular_barcodes=16)
    total = 64 * num_processes  # divisible by the global device count
    full = synthetic_batch(instrument, ontology, total, seed=5)
    used = instrument.used_segments

    # single-process reference counters over the full batch (local jit)
    reference_step = jax.jit(make_decode_step(instrument))
    full_batch = {
        "segments": [
            (
                jnp.asarray(full["segments"][s][0]),
                jnp.asarray(full["segments"][s][1]),
                jnp.asarray(full["segments"][s][2]),
            )
            for s in used
        ],
        "qcfail": jnp.asarray(full["qcfail"]),
    }
    _, reference_counters = jax.block_until_ready(reference_step(full_batch))

    # distributed: each process owns its contiguous half of the reads
    mesh = reads_mesh()
    share = total // num_processes
    lo = process_id * share
    hi = lo + share

    def to_global(local):
        return multihost_utils.host_local_array_to_global_array(
            local, mesh, P("reads")
        )

    global_batch = {
        "segments": [
            (
                to_global(full["segments"][s][0][lo:hi]),
                to_global(full["segments"][s][1][lo:hi]),
                to_global(full["segments"][s][2][lo:hi]),
            )
            for s in used
        ],
        "qcfail": to_global(full["qcfail"][lo:hi]),
    }
    sharded_step = make_sharded_decode_step(instrument, mesh)
    per_read, counters = jax.block_until_ready(sharded_step(global_batch))

    for reference, merged in zip(reference_counters, counters):
        for key, value in reference.items():
            expected = np.asarray(value)
            got = np.asarray(merged[key].addressable_data(0))
            np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)

    # the per-read decisions this process can address must equal the
    # reference rows for its half
    local_decoded = np.concatenate(
        [
            np.asarray(shard.data)
            for shard in per_read["decoders"][0]["decoded"].addressable_shards
        ]
    )
    reference_per_read, _ = jax.block_until_ready(reference_step(full_batch))
    expected_decoded = np.asarray(reference_per_read["decoders"][0]["decoded"])[
        lo:hi
    ]
    np.testing.assert_array_equal(np.sort(local_decoded), np.sort(expected_decoded))

    print(f"MULTIHOST-OK {process_id}", flush=True)


if __name__ == "__main__":
    main(
        int(sys.argv[1]),
        sys.argv[2],
        int(sys.argv[3]) if len(sys.argv) > 3 else 2,
    )
