"""One-command multi-chip / multi-host throughput bench.

    python -m pheniqs_tpu.tools.multichip_bench [--reads N] [--virtual D]

Runs the production hybrid engine (FASTQ -> tagged SAM) over the flagship
workload with the full scale-out topology engaged:

  * multi-host: `jax.distributed.initialize` from the standard env
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); each
    host owns the PHENIQS_SHARD=k:H round-robin slice of the input and
    process 0 prints the cross-host aggregate (summed over DCN with one
    psum) — the collective analog of ``Transcode::collect`` (reference
    transcode.cpp:317-320)
  * multi-chip: the engine shard_maps its decode step over a 1-D `reads`
    mesh of this process's local devices with psum-merged counters
    (device/step.py)

`--virtual D` forces a D-device virtual CPU platform so the exact same
code path validates on a development machine (this is what the driver's
``dryrun_multichip`` exercises); on real hardware run it with no flags.

Prints one JSON line:
  {"metric": "multichip_e2e_hybrid", "value": <global reads/s>, ...}
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys


def run_bench(
    reads: int = 500_000,
    batch_size: int = 65536,
    threads: int = 4,
    fidelity: str = "hybrid",
    bench_dir: str | None = None,
    output: str | None = None,
    tp: str | None = None,
    tp_threshold: int | None = None,
) -> dict:
    """Synthesize (or reuse) the flagship input, run the engine over this
    host's shard, and return the cross-host aggregated stats dict.

    ``tp="R:P"`` engages barcode-axis tensor parallelism: the engine runs
    its decode step over a 2-D (reads, panel) mesh, sharding every PAMLD
    panel above ``tp_threshold`` barcodes across P devices
    (device/tp.py + make_tp_sharded_decode_step)."""
    import jax
    import numpy as np

    from ..benchmark import WORK_DIR, run_e2e, synthesize_fastq_input
    from ..device.distributed import initialize_multihost

    if tp:
        os.environ["PHENIQS_TP"] = tp
        if tp_threshold is not None:
            os.environ["PHENIQS_TP_THRESHOLD"] = str(tp_threshold)

    process_id, num_processes = initialize_multihost()
    if num_processes > 1:
        os.environ["PHENIQS_SHARD"] = f"{process_id}:{num_processes}"

    bench_dir = bench_dir or os.environ.get(
        "PHENIQS_BENCH_DIR", os.path.join(WORK_DIR, "bench")
    )
    paths = synthesize_fastq_input(
        os.path.join(bench_dir, f"multichip_{reads}"), reads
    )
    if output is None:
        output = os.path.join(
            bench_dir, f"multichip_out_p{process_id}.sam"
        )
    stats = run_e2e(
        paths, output, fidelity=fidelity, threads=threads,
        batch_size=batch_size,
    )

    # cross-host aggregate: one DCN psum over (reads, wall-clock). The
    # global rate uses the max wall (hosts run concurrently).
    local = np.array([stats["reads"], stats["wall_s"]], dtype=np.float64)
    if num_processes > 1:
        from jax.sharding import Mesh, PartitionSpec

        mesh = Mesh(np.array(jax.devices()), ("hosts",))
        # all-sum of reads, all-max of wall over DCN
        import jax.numpy as jnp

        def agg(values):
            return (
                jax.lax.psum(values[0], "hosts"),
                jax.lax.pmax(values[1], "hosts"),
            )

        global_reads, global_wall = jax.jit(
            jax.shard_map(
                agg,
                mesh=mesh,
                in_specs=PartitionSpec(),
                out_specs=(PartitionSpec(), PartitionSpec()),
            )
        )(jnp.asarray(local))
        total_reads = float(global_reads)
        wall = float(global_wall)
    else:
        total_reads = float(local[0])
        wall = float(local[1])

    local_devices = len(jax.local_devices())
    result = {
        "metric": "multichip_e2e_hybrid",
        "value": round(total_reads / wall, 1) if wall else 0.0,
        "unit": "reads/s",
        "hosts": num_processes,
        "devices_per_host": local_devices,
        "reads": int(total_reads),
        "wall_s": round(wall, 3),
        "per_host_steady_reads_per_s": stats.get("steady_reads_per_s"),
        "process_id": process_id,
    }
    if tp:
        result["tp"] = tp
    return result


def run_device_step(n_devices: int, reads: int, reps: int = 5) -> dict:
    """Time the sharded decode step on a FIXED total workload over this
    process's first ``n_devices`` devices (the scaling probe's inner body).

    The workload is the flagship synthetic device batch (4-segment
    NovaSeq shape, dual PAMLD + naive UMI), padded and shard_mapped over
    a 1-D ``reads`` mesh exactly as the production engine does
    (device/step.py:make_sharded_decode_step). Prints/returns the median
    step wall over ``reps`` post-warmup repetitions.
    """
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from ..device.flagship import (
        flagship_instrument,
        flagship_ontology,
        synthetic_batch,
    )
    from ..device.step import make_sharded_decode_step, pad_batch

    devices = jax.devices()
    assert len(devices) >= n_devices, (len(devices), n_devices)
    instrument = flagship_instrument()
    batch_np = synthetic_batch(
        instrument, flagship_ontology(), reads, seed=11
    )
    batch = {
        "segments": [
            (
                jnp.asarray(batch_np["segments"][s][0]),
                jnp.asarray(batch_np["segments"][s][1]),
                jnp.asarray(batch_np["segments"][s][2]),
            )
            for s in instrument.used_segments
        ],
        "qcfail": jnp.asarray(batch_np["qcfail"]),
    }
    mesh = Mesh(np.array(devices[:n_devices]), ("reads",))
    step = make_sharded_decode_step(instrument, mesh)
    padded, _true_n = pad_batch(batch, n_devices)
    if os.environ.get("PHENIQS_SCALING_BREAK") == "1" and n_devices > 1:
        # test hook: deliberately break work partitioning by tiling the
        # batch n-fold, so every device's shard is the FULL workload —
        # the replication regression the scaling gate exists to catch
        import jax.numpy as _jnp

        def _tile(x):
            return _jnp.concatenate([x] * n_devices, axis=0)

        padded = {
            "segments": [
                (_tile(c), _tile(q), _tile(l))
                for c, q, l in padded["segments"]
            ],
            "qcfail": _tile(padded["qcfail"]),
        }
    jax.block_until_ready(step(padded))  # compile + warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(step(padded))
        walls.append(time.perf_counter() - t0)
    med = float(np.median(walls))
    return {
        "metric": "device_step_scaling_probe",
        "n_devices": n_devices,
        "reads": reads,
        "reads_per_device_shard": padded["qcfail"].shape[0] // n_devices,
        "step_ms_median": round(med * 1e3, 2),
        "step_ms_all": [round(w * 1e3, 2) for w in walls],
        "reads_per_s": round(reads / med, 1),
        "reps": reps,
    }


def run_scaling(n_devices: int, reads: int = 524_288) -> dict:
    """Work-partitioning scaling gate: fixed total workload, n=1 vs n=N.

    Spawns one fresh subprocess per device count (the virtual CPU device
    count is a process-wide XLA flag), times the sharded decode step on
    the SAME total workload with the SAME host resources, and reports

        partition_efficiency = t_single / t_sharded

    On a core-rich host this approaches min(N, cores) (true strong
    scaling); on a memory-bandwidth-bound host (this 4-core dev VM,
    where the step wall does not move with core count) the ideal is ~1.0: partitioning the batch
    N ways adds only collective/dispatch overhead. Either way a sharding
    regression that REPLICATES per-device work (the failure mode this
    gate exists to catch, SURVEY §2.9) multiplies total work ~N-fold and
    collapses the ratio far below the 0.7 gate the dryrun asserts.
    """
    results = {}
    for n in (1, n_devices):
        env = dict(os.environ)
        flags = env.get("XLA_FLAGS", "")
        flags = re.sub(
            r"--xla_force_host_platform_device_count=\d+", "", flags
        )
        env["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={n}"
        ).strip()
        env["JAX_PLATFORMS"] = "cpu"
        env.pop("PHENIQS_TP", None)
        out = subprocess.run(
            [
                sys.executable,
                "-m",
                "pheniqs_tpu.tools.multichip_bench",
                "--device-step",
                "--virtual",
                str(n),
                "--reads",
                str(reads),
            ],
            env=env,
            capture_output=True,
            text=True,
            timeout=1200,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"scaling probe n={n} failed rc={out.returncode}:\n"
                f"{out.stderr[-2000:]}"
            )
        results[n] = json.loads(out.stdout.strip().splitlines()[-1])
    t1 = results[1]["step_ms_median"]
    tn = results[n_devices]["step_ms_median"]
    efficiency = t1 / tn if tn else 0.0
    return {
        "metric": "multichip_scaling",
        "reads": reads,
        "n_devices": n_devices,
        "single_step_ms": t1,
        "sharded_step_ms": tn,
        "partition_efficiency": round(efficiency, 3),
        "single": results[1],
        "sharded": results[n_devices],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="multi-chip/multi-host hybrid e2e throughput bench"
    )
    parser.add_argument("--reads", type=int, default=500_000)
    parser.add_argument("--batch-size", type=int, default=65536)
    parser.add_argument("--threads", type=int, default=4)
    parser.add_argument("--fidelity", default="hybrid")
    parser.add_argument(
        "--virtual", type=int, default=0,
        help="force an N-device virtual CPU platform (validation mode)",
    )
    parser.add_argument(
        "--tp", default=None, metavar="R:P",
        help="2-D (reads, panel) mesh: shard large PAMLD panels over P"
        " devices (barcode-axis tensor parallelism)",
    )
    parser.add_argument(
        "--tp-threshold", type=int, default=None,
        help="shard PAMLD panels above this many barcodes (default 16384)",
    )
    parser.add_argument(
        "--device-step", action="store_true",
        help="time the sharded decode step only (fixed workload; the"
        " scaling probe's inner body)",
    )
    parser.add_argument(
        "--scaling", action="store_true",
        help="work-partitioning scaling gate: fixed workload, n=1 vs"
        " n=--virtual subprocess pair, prints partition_efficiency",
    )
    args = parser.parse_args(argv)

    if args.scaling:
        result = run_scaling(max(args.virtual, 2), reads=args.reads)
        print(json.dumps(result))
        return 0

    if args.virtual >= 1:
        # force an args.virtual-device CPU platform, for --virtual 1 too
        # (a "1-device CPU" probe must not silently measure the GPU)
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.virtual}"
            ).strip()
        import jax
        from jax._src import xla_bridge

        if not xla_bridge.backends_are_initialized():
            jax.config.update("jax_platforms", "cpu")

    if args.device_step:
        result = run_device_step(max(args.virtual, 1), reads=args.reads)
        print(json.dumps(result))
        return 0

    result = run_bench(
        reads=args.reads,
        batch_size=args.batch_size,
        threads=args.threads,
        fidelity=args.fidelity,
        tp=args.tp,
        tp_threshold=args.tp_threshold,
    )
    if result["process_id"] == 0:
        print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
