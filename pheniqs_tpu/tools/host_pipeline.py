"""Host-pipeline ceiling measurement (no accelerator).

The engine's scale-out story needs one number per host: how fast the
host path alone — native FASTQ parse -> input filters -> wire pack ->
SHM worker staging -> decision apply -> tag render -> ordered write —
can feed a chip. The reference names exactly this as the
demultiplexing wall (reference docs/configuration.md:20: gzip FASTQ
input is I/O-bound before it is CPU-bound; reference
transcode.cpp:1776-1795 exists to keep decoders fed). This tool runs a
ladder of real pipeline prefixes over the flagship workload and prints
one JSON line per stage plus the full-pipeline steady state, so the
binding stage is measured, not asserted:

  parse        native FASTQ batch parse only (the ingest ceiling)
  parse+pack   + input filters + H2D wire-blob packing (dispatch-thread
               work in the production engine)
  full         the production streamed engine with the device replaced
               by an instant decision fabricator (benchmark.run_e2e
               fidelity="null"): every host stage at production cost,
               decisions spread across the barcode panel

Run:  python -m pheniqs_tpu.tools.host_pipeline --reads 5000000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _stage_engine(ontology):
    """A non-streamed engine exposing the parse and pack prefixes."""
    from ..benchmark import _NullDeviceMixin
    from ..engine.device import DeviceEngine

    class StageEngine(_NullDeviceMixin, DeviceEngine):
        pass

    return StageEngine(ontology, hybrid=False)


def _measure_prefix(ontology, batch_size: int, packed: bool) -> dict:
    engine = _stage_engine(ontology)
    engine._initiate_feeds()
    start = time.perf_counter()
    reads = 0
    batches = engine.read_batches(batch_size)
    if packed:
        for _raw_size, _raw_pf, batch, _packed in engine._prepared_batches(
            batches
        ):
            reads += batch.size
    else:
        for batch in batches:
            reads += batch.size
    wall = time.perf_counter() - start
    engine._close_feeds()
    return {
        "reads": reads,
        "wall_s": round(wall, 3),
        "reads_per_s": round(reads / wall, 1) if wall else 0.0,
    }


def main(argv=None) -> int:
    # the accelerator is excluded by design (set before jax is imported)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    from ..benchmark import (
        WORK_DIR,
        e2e_ontology,
        run_e2e,
        synthesize_fastq_input,
    )

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--reads", type=int, default=5_000_000)
    parser.add_argument(
        "--threads", type=int, default=(os.cpu_count() or 4) + 1
    )
    parser.add_argument("--batch", type=int, default=1 << 17)
    parser.add_argument(
        "--dir", default=os.path.join(WORK_DIR, "host_pipeline"),
        help="input cache directory",
    )
    parser.add_argument(
        "--out", default=os.path.join(WORK_DIR, "host_pipeline_out.sam"),
        help="output SAM path (a real file: write cost is part of the "
        "pipeline; /dev/null elides it)",
    )
    parser.add_argument(
        "--skip-prefixes", action="store_true",
        help="only run the full pipeline stage",
    )
    args = parser.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")

    paths = synthesize_fastq_input(args.dir, args.reads)

    rows = []
    if not args.skip_prefixes:
        for name, packed in (("parse", False), ("parse+pack", True)):
            ontology = e2e_ontology(paths, args.out, 1)
            stats = _measure_prefix(ontology, args.batch, packed)
            stats["stage"] = name
            rows.append(stats)
            print(json.dumps(stats), flush=True)

    stats = run_e2e(
        paths, args.out, fidelity="null",
        threads=args.threads, batch_size=args.batch,
    )
    stats["stage"] = "full"
    stats["threads"] = args.threads
    rows.append(stats)
    print(json.dumps(stats), flush=True)

    steady = stats.get("steady_reads_per_s", stats["reads_per_s"])
    print(
        json.dumps(
            {
                "metric": "host_pipeline_ceiling",
                "value": steady,
                "unit": "reads/s",
                "stages": {
                    row["stage"]: row["reads_per_s"] for row in rows
                },
            }
        ),
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
