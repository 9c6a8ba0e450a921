"""Ablation profiler for the device decode step (compute-only).

Attributes the device decode step's time by timing a ladder of jitted sub-programs over the
SAME resident packed H2D blob the production engine ships — each rung adds
one stage of the real step, so rung-to-rung deltas localize the cost:

  null      dispatch + one trivial reduce (the per-call latency floor)
  unpack    + 10-bit wire-format unpack (elementwise bit ops)
  plans     + tokenization gathers (apply_plans, both PAMLD decoders)
  features  + observation feature tensor build (LUT gather + one-hots)
  sigma     + the (N,5W)x(5W,B) likelihood contractions (matrix products)
  posterior + full PAMLD posterior/filters/uncertainty for both decoders
  full      the production step (counters + packed D2H blob), as compiled
            by the engine (want_uncertain=True, h2d wire format)

Each rung reports latency (block every call) and pipelined throughput
(dispatch `depth` calls, then block) — the engine overlaps dispatch with
host work, so the pipelined number is what production sees. `full` also
runs a batch-size sweep: if reads/s scales with batch while latency stays
flat, per-call dispatch (not compute) is the wall.

Run on the GPU:  python -m pheniqs_tpu.tools.profile_step
On the CPU backend it still runs (its numbers say nothing about the
device, but it exercises every rung).

Prints one JSON line per measurement; pass --markdown for a table.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _build_blob(batch_np, instrument, widths):
    import numpy as np

    from ..device.step import pack_h2d_blob

    used = [batch_np["segments"][s] for s in instrument.used_segments]
    segments = []
    for code, qual, length in used:
        segments.append(
            (code.astype(np.uint8), qual.astype(np.uint8), length)
        )
    return pack_h2d_blob(widths, segments, batch_np["qcfail"])


def _variants(instrument, widths):
    """The ablation ladder: name -> fn(blob) returning a small array (so
    nothing is dead-code-eliminated)."""
    import jax.numpy as jnp

    from ..device.classify import (
        apply_plans,
        observation_features,
        pamld_classify_device,
        MATMUL_PRECISION,
    )
    from ..device.instrument import UNIFORM_BASE_QUALITY
    from ..device.step import _unpack_h2d_blob, make_decode_step

    pamld = [d for d in instrument.decoders if d.algorithm == "pamld"]

    def v_null(blob):
        return blob[:, 0].astype(jnp.int32).sum()

    def v_unpack(blob):
        segments, qcfail, pad, forced = _unpack_h2d_blob(widths, blob)
        total = qcfail.sum() + pad.sum() + forced.sum()
        for c, q, l in segments:
            total = total + c.sum() + q.sum() + l.sum()
        return total

    def _plans(blob):
        segments, qcfail, _, _ = _unpack_h2d_blob(widths, blob)
        return [apply_plans(dec, segments) for dec in pamld], qcfail

    def v_plans(blob):
        observations, _ = _plans(blob)
        total = jnp.int32(0)
        for observation in observations:
            for c, q, l in observation:
                total = total + c.sum() + q.sum() + l.sum()
        return total

    def _features(blob):
        observations, qcfail = _plans(blob)
        out = []
        for observation in observations:
            obs_code = jnp.concatenate([c for c, _, _ in observation], axis=1)
            obs_qual = jnp.concatenate([q for _, q, _ in observation], axis=1)
            out.append(
                (
                    observation_features(instrument, obs_code, obs_qual),
                    obs_code,
                    obs_qual,
                )
            )
        return out, qcfail

    def v_features(blob):
        feats, _ = _features(blob)
        return sum(f.sum() for f, _, _ in feats)

    def v_sigma(blob):
        feats, _ = _features(blob)
        total = jnp.float32(0)
        for dec, (features, _, obs_qual) in zip(pamld, feats):
            qpos = (obs_qual > 0).astype(jnp.float32).sum(axis=1)
            sigma = (
                jnp.dot(
                    features,
                    dec.likelihood_matrix,
                    precision=MATMUL_PRECISION,
                    preferred_element_type=jnp.float32,
                )
                + qpos[:, None] * UNIFORM_BASE_QUALITY
            )
            total = total + sigma.sum()
        return total

    def v_posterior(blob):
        feats, qcfail = _features(blob)
        total = jnp.float32(0)
        for dec, (_, obs_code, obs_qual) in zip(pamld, feats):
            result = pamld_classify_device(
                instrument, dec, obs_code, obs_qual, qcfail,
                want_uncertain=True,
            )
            qcfail = result["qcfail"]
            total = (
                total
                + result["decoded"].sum()
                + result["confidence"].sum()
                + result["distance"].sum()
                + result["uncertain"].sum()
            )
        return total

    full = make_decode_step(
        instrument,
        want_uncertain=True,
        want_counters=True,
        pack_outputs=True,
        h2d_widths=widths,
    )

    def v_full(blob):
        packed, counters = full({"blob": blob})
        return packed["blob"].astype(jnp.int32).sum() + counters.sum()

    return {
        "null": v_null,
        "unpack": v_unpack,
        "plans": v_plans,
        "features": v_features,
        "sigma": v_sigma,
        "posterior": v_posterior,
        "full": v_full,
    }


def _measure(fn, blobs, iters, depth):
    """(latency s/call, pipelined s/call) for a jitted fn over resident
    data. Latency blocks every call; pipelined keeps `depth` dispatches in
    flight the way the engine's lookahead does.

    ``blobs`` is a LIST of distinct resident buffers cycled per call, so
    no runtime can serve a repeated same-argument dispatch from a cache."""
    import jax

    jax.block_until_ready([fn(b) for b in blobs])  # compile + warm
    t0 = time.perf_counter()
    for i in range(iters):
        jax.block_until_ready(fn(blobs[i % len(blobs)]))
    latency = (time.perf_counter() - t0) / iters

    pending = []
    t0 = time.perf_counter()
    for i in range(iters):
        pending.append(fn(blobs[i % len(blobs)]))
        if len(pending) > depth:
            jax.block_until_ready(pending.pop(0))
    jax.block_until_ready(pending)
    pipelined = (time.perf_counter() - t0) / iters
    return latency, pipelined


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="ablation profile of the device decode step"
    )
    parser.add_argument("--batch", type=int, default=1 << 17)
    parser.add_argument("--iters", type=int, default=12)
    parser.add_argument("--depth", type=int, default=2,
                        help="in-flight dispatches for the pipelined mode")
    parser.add_argument(
        "--sweep", default="131072,262144,524288,1048576",
        help="comma-separated batch sizes for the full-step sweep"
        " (empty string disables)",
    )
    parser.add_argument("--markdown", action="store_true")
    args = parser.parse_args(argv)

    import jax
    import numpy as np

    from ..device.flagship import flagship_instrument, flagship_ontology, synthetic_batch

    ontology = flagship_ontology()
    instrument = flagship_instrument()
    widths = [
        -(-max(batch_w, 1) // 4) * 4
        for batch_w in (8, 8, 26)
    ]

    sweep = [int(x) for x in args.sweep.split(",") if x] if args.sweep else []
    max_n = max([args.batch] + sweep)
    # distinct workloads per in-flight call (see _measure): rotate which
    # reads land in the window so buffer contents differ call-to-call
    n_variants = max(2, args.depth + 1)
    batch_np = synthetic_batch(
        instrument, ontology, max_n + n_variants, seed=31
    )
    blob_np = _build_blob(batch_np, instrument, widths)

    device = jax.devices()[0]
    rows = []

    def resident(n):
        out = [
            jax.device_put(blob_np[k : k + n], device)
            for k in range(n_variants)
        ]
        jax.block_until_ready(out)
        return out

    def record(name, n, latency, pipelined):
        row = {
            "variant": name,
            "batch": n,
            "latency_ms": round(latency * 1e3, 3),
            "pipelined_ms": round(pipelined * 1e3, 3),
            "latency_reads_per_s": round(n / latency, 1),
            "pipelined_reads_per_s": round(n / pipelined, 1),
        }
        rows.append(row)
        if not args.markdown:
            print(json.dumps(row), flush=True)

    variants = _variants(instrument, widths)
    blobs = resident(args.batch)
    for name, fn in variants.items():
        jitted = jax.jit(fn)
        latency, pipelined = _measure(jitted, blobs, args.iters, args.depth)
        record(name, args.batch, latency, pipelined)

    for n in sweep:
        if n == args.batch:
            continue
        blobs_n = resident(n)
        jitted = jax.jit(variants["full"])
        latency, pipelined = _measure(
            jitted, blobs_n, max(4, args.iters // 2), args.depth
        )
        record("full", n, latency, pipelined)

    if args.markdown:
        print(f"platform: {device.platform} ({device.device_kind})")
        print("| variant | batch | latency ms | pipelined ms |"
              " latency reads/s | pipelined reads/s |")
        print("|---|---|---|---|---|---|")
        for row in rows:
            print(
                "| {variant} | {batch} | {latency_ms} | {pipelined_ms} |"
                " {latency_reads_per_s:,.0f} |"
                " {pipelined_reads_per_s:,.0f} |".format(**row)
            )
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
