"""Measure the real HBM footprint and step cost of large barcode panels.

The TP `shard_threshold` (device/step.py
make_tp_sharded_decode_step) was a guess; this tool replaces it with
data. For each panel size it builds a synthetic whitelist decoder,
device-puts the chunked-path constants, runs the production posterior
(the same `pamld_classify_device` the engine compiles) over one batch,
and reports:

  * analytic panel bytes (likelihood matrix + codes + concentration)
  * device memory stats before/after (when the runtime exposes them)
  * steady per-batch latency and reads/s

Run on the GPU: ``python -m pheniqs_tpu.tools.panel_memory``
(the CPU backend works for the memory arithmetic; its latencies say
nothing about the device).
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def synthetic_panel_decoder(b: int, w: int, seed: int = 7):
    """A DeviceDecoder-shaped synthetic whitelist: B barcodes of width W
    with uniform concentration, bypassing the config compiler (panel
    construction is what is being measured, not parsing)."""
    import numpy as np
    import jax.numpy as jnp

    from ..device.instrument import (
        LARGE_PANEL_B,
        STRICT_CODES,
        DeviceDecoder,
    )

    rng = np.random.default_rng(seed)
    codes = np.array(STRICT_CODES, dtype=np.int64)[
        rng.integers(4, size=(b, w))
    ]
    strict = np.ones((b, w), dtype=np.float32)
    onehot4 = np.zeros((b, w, 4), dtype=np.float32)
    for c, code in enumerate(STRICT_CODES):
        onehot4[:, :, c] = (codes == code).astype(np.float32)
    g = np.concatenate([onehot4, strict[:, :, None]], axis=2)
    g = np.ascontiguousarray(g.reshape(b, w * 5).T)

    noise = 0.05
    concentration = np.full(b, (1.0 - noise) / b, dtype=np.float32)
    dec = DeviceDecoder(
        algorithm="pamld",
        classifier_type="cellular",
        index=1,
        multiplexing=False,
        plans=[],
        segment_widths=[w],
        barcode_count=b,
        width=w,
        panel_codes=jnp.asarray(codes.astype(np.int32)),
        panel_strict=jnp.asarray(strict),
        likelihood_matrix=jnp.asarray(g),
        concentration=jnp.asarray(concentration),
        panel_match16=None,  # chunked path above LARGE_PANEL_B
        noise=noise,
        confidence_threshold=0.95,
        random_barcode_probability=0.25**w,
    )
    assert b > LARGE_PANEL_B, "sizes below the chunked cutoff not measured"
    return dec


def analytic_bytes(b: int, w: int) -> dict:
    return {
        "likelihood_matrix": 5 * w * b * 4,
        "panel_codes": b * w * 4,
        "concentration": b * 4,
        "total": (5 * w + w + 1) * b * 4,
    }


def _memory_stats(device):
    try:
        stats = device.memory_stats()
    except Exception:
        return None
    if not stats:
        return None
    return {
        "bytes_in_use": stats.get("bytes_in_use"),
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "bytes_limit": stats.get("bytes_limit"),
    }


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="HBM footprint / cost of large barcode panels"
    )
    parser.add_argument(
        "--sizes", default="65536,262144,1048576",
        help="comma-separated panel cardinalities",
    )
    parser.add_argument("--width", type=int, default=16)
    parser.add_argument("--batch", type=int, default=131072)
    parser.add_argument("--iters", type=int, default=6)
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ..device.classify import pamld_classify_device
    from ..device.instrument import (
        DeviceInstrument,
        STRICT_CODES,
    )
    from ..phred import SUBSTITUTION_LUT, TRUE_POSITIVE_QUALITY

    device = jax.devices()[0]
    n = args.batch
    w = args.width
    rng = np.random.default_rng(3)

    for b in (int(x) for x in args.sizes.split(",")):
        dec = synthetic_panel_decoder(b, w)
        instrument = DeviceInstrument(
            decoders=[dec],
            multiplexing_index=0,
            input_segment_cardinality=1,
            substitution_lut=jnp.asarray(
                SUBSTITUTION_LUT.astype(np.float32)
            ),
            tpq=jnp.asarray(TRUE_POSITIVE_QUALITY.astype(np.float32)),
        )
        before = _memory_stats(device)

        # reads drawn FROM the panel so decode rates are realistic
        pick = rng.integers(b, size=n)
        obs_code_np = np.asarray(dec.panel_codes)[pick]
        flip = rng.random((n, w)) < 0.02
        obs_code_np = np.where(
            flip,
            np.array(STRICT_CODES)[rng.integers(4, size=(n, w))],
            obs_code_np,
        )
        obs_qual_np = rng.integers(20, 40, size=(n, w))

        # the panel travels as a runtime ARGUMENT, not a closed-over
        # constant: a 1M-barcode panel is hundreds of MB, which does not
        # belong embedded in the compiled program
        import dataclasses

        def run(obs_code, obs_qual, matrix, concentration):
            bound = dataclasses.replace(
                dec, likelihood_matrix=matrix, concentration=concentration
            )
            result = pamld_classify_device(
                instrument, bound,
                obs_code.astype(jnp.int32), obs_qual.astype(jnp.int32),
                jnp.zeros(n, dtype=bool),
            )
            return (
                result["decoded"],
                result["confidence"],
                result["qcfail"],
            )

        matrix_dev = jax.device_put(dec.likelihood_matrix, device)
        conc_dev = jax.device_put(dec.concentration, device)
        compiled = jax.jit(run)

        def jitted(code, qual):
            return compiled(code, qual, matrix_dev, conc_dev)
        buffers = [
            (
                jax.device_put(np.roll(obs_code_np, k, axis=0), device),
                jax.device_put(np.roll(obs_qual_np, k, axis=0), device),
            )
            for k in range(2)
        ]
        out = jitted(*buffers[0])
        jax.block_until_ready(out)
        decoded = np.asarray(out[0])
        t0 = time.perf_counter()
        for i in range(args.iters):
            jax.block_until_ready(jitted(*buffers[i % 2]))
        latency = (time.perf_counter() - t0) / args.iters
        after = _memory_stats(device)

        print(
            json.dumps(
                {
                    "panel_b": b,
                    "width": w,
                    "batch": n,
                    "analytic_panel_bytes": analytic_bytes(b, w)["total"],
                    "memory_before": before,
                    "memory_after": after,
                    "latency_s": round(latency, 4),
                    "reads_per_s": round(n / latency, 1),
                    "decoded_fraction": round(
                        float((decoded > 0).mean()), 4
                    ),
                },
            ),
            flush=True,
        )


if __name__ == "__main__":
    main(sys.argv[1:])
