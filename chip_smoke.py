"""Smoke test of the `mux` hybrid path on an NVIDIA GPU.

Drives the flagship instrument at full width (96 dual-index 8+8 nt PAMLD
sample barcodes, 384 x 16 nt PAMLD cellular barcodes, a naive 10 nt UMI,
4-segment 150/8/8/26 nt reads; device/flagship.py) and holds every device
decision to the strict float64 engine:

  a. device: JAX's platform, device kind and count, the card's name and
     power limit; exits nonzero unless the platform is ``gpu``
  b. step: one 131072-read batch through the jitted decode step against
     the f64 oracle (decode/oracle.py) for the PAMLD sample, the PAMLD
     cellular and the sample panel run as an MDD decoder, once for each
     distance path (PHENIQS_DISTANCE_PATH=gather|contraction)
  c. bound: the measured inputs of the hybrid re-resolution bound
     (device/classify.py): the ulp error of ``jnp.exp`` over every f32
     argument the posterior's exponentials take, and analytic_tpq_epsilon
  d. e2e: 2,097,152 flagship reads as FASTQ through
     ``mux --fidelity hybrid`` on the card to a real SAM file, against
     ``mux --fidelity strict`` on the CPU

    python chip_smoke.py           # phases a-d on one GPU
    python chip_smoke.py --four    # phase e alone: the e2e job on four GPUs,
                                   # through the engine's reads mesh and again
                                   # with PHENIQS_TP=2:2 (panel sharding)

Every phase that uses the card runs in a child process of its own, one at a
time; the parent never opens the card, and the strict reference runs with
JAX_PLATFORMS=cpu. Any failed phase exits nonzero. The last line of stdout
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".work", "chip_smoke")

BATCH = 1 << 17
E2E_READS = 16 * BATCH
#: relative tolerance of an unflagged device confidence against the f64
#: oracle, and of the SAM confidence tags against the strict engine's
CONF_RTOL = 1e-5
#: the hybrid bound's assumption about f32 exp on the shifted
#: conditionals (device/classify.py _HYBRID_SAFETY)
EXP_ULP_LIMIT = 2.0
#: the noise term's exp (positive arguments, up to f32 overflow) enters
#: the confidence once, beside the 8 u of exp/division rounding the bound
#: allows before its 4x safety factor
NOISE_EXP_ULP_LIMIT = 8.0
FLOAT_TAGS = ("XB:f:", "XM:f:", "XC:f:")
_RESULT = "chip_smoke result: "


class SmokeFailure(RuntimeError):
    """A phase's output disagrees with its reference."""


# --- comparison helpers (pure numpy; unit-tested on the CPU) ----------------


def decision_diff(dev_decoded, dev_qcfail, ref_decoded, ref_qcfail):
    """Rows whose decision (decoded barcode or chained qcfail) differs."""
    return (np.asarray(dev_decoded) != np.asarray(ref_decoded)) | (
        np.asarray(dev_qcfail, dtype=bool) != np.asarray(ref_qcfail, dtype=bool)
    )


def uncovered(diff, uncertain) -> int:
    """Differing rows the device did NOT flag for f64 re-resolution: the
    hybrid contract requires zero."""
    return int(np.count_nonzero(np.asarray(diff) & ~np.asarray(uncertain)))


def confidence_violations(dev_conf, ref_conf, flagged, rtol=CONF_RTOL) -> int:
    """Unflagged rows whose device confidence is off the f64 oracle's by
    more than ``rtol`` relative (a zero oracle confidence needs a zero)."""
    dev = np.asarray(dev_conf, dtype=np.float64)
    ref = np.asarray(ref_conf, dtype=np.float64)
    bad = np.abs(dev - ref) > rtol * np.abs(ref)
    return int(np.count_nonzero(bad & ~np.asarray(flagged)))


def sam_decisions(line: str) -> tuple:
    """The non-float fields of one SAM record (tests/test_hybrid.py rule)."""
    return tuple(f for f in line.split("\t") if f[:5] not in FLOAT_TAGS)


def sam_float_tags(line: str) -> dict:
    return {f[:2]: f[5:] for f in line.split("\t") if f[:5] in FLOAT_TAGS}


def float_tags_agree(device: dict, strict: dict, rtol=CONF_RTOL) -> bool:
    """Do two records' XB/XM/XC tags agree?

    Each tag carries 1 - confidence, printed from f32 with %g, so the
    comparison is made on the confidence: within ``rtol`` of the strict
    one, plus one quantum of the 6-digit print on either side. A tag is
    written only for a confidence strictly inside (0, 1); an f32
    confidence that rounds to 1.0 drops it, so a tag present on one side
    only must itself be within ``rtol`` of confidence 1."""
    for key in set(device) | set(strict):
        if key in device and key in strict:
            x_dev, x_ref = float(device[key]), float(strict[key])
            quantum = (
                2 * 10.0 ** (math.floor(math.log10(abs(x_ref))) - 5)
                if x_ref
                else 0.0
            )
            if abs(x_dev - x_ref) > rtol * (1.0 - x_ref) + quantum:
                return False
        else:
            present = float(device.get(key, strict.get(key)))
            if present > rtol:
                return False
    return True


def compare_sam(device_path: str, strict_path: str) -> dict:
    """Record-by-record comparison of two SAM files: non-float fields
    must be identical, float tags must pass float_tags_agree."""
    records = mismatches = tag_violations = 0
    with open(device_path) as dev, open(strict_path) as ref:
        dev_lines = (line.rstrip("\n") for line in dev
                     if not line.startswith("@"))
        ref_lines = (line.rstrip("\n") for line in ref
                     if not line.startswith("@"))
        sentinel = object()
        while True:
            a = next(dev_lines, sentinel)
            b = next(ref_lines, sentinel)
            if a is sentinel or b is sentinel:
                if a is not b:
                    mismatches += 1  # record counts differ
                break
            records += 1
            if sam_decisions(a) != sam_decisions(b):
                mismatches += 1
            elif not float_tags_agree(sam_float_tags(a), sam_float_tags(b)):
                tag_violations += 1
    return {
        "records": records,
        "mismatches": mismatches,
        "tag_violations": tag_violations,
    }


def report_counts(doc, prefix: str = "") -> dict:
    """Every integer count of a JSON run report, keyed by its path."""
    out = {}
    if isinstance(doc, dict):
        for key, value in doc.items():
            out.update(report_counts(value, f"{prefix}/{key}"))
    elif isinstance(doc, list):
        for k, value in enumerate(doc):
            out.update(report_counts(value, f"{prefix}[{k}]"))
    elif "count" in prefix.rsplit("/", 1)[-1] and isinstance(doc, int):
        out[prefix] = doc
    return out


def exp_ulp_error(lo: float, hi: float, stride: int = 1, chunk: int = 1 << 26):
    """Largest ulp error of jit(jnp.exp) on the default device against
    numpy's float64 exp, over every ``stride``-th f32 in [lo, hi].

    Results that are f32-normal are measured in ulps of the exact value.
    Below FLT_MIN (arguments under about -87.3) the card may flush to zero;
    there the absolute error is returned instead — a term under 2^-126
    beside the posterior's decoded conditional of exactly 1.0 lies below
    one ulp of the sum (device/classify.py)."""
    import jax
    import jax.numpy as jnp

    exp32 = jax.jit(jnp.exp)
    tiny = float(np.finfo(np.float32).tiny)
    worst_ulp = 0.0
    worst_abs = 0.0
    points = 0
    # f32 bit patterns: negatives grow with magnitude from 0x80000000,
    # positives from 0; walk [lo, -0] and [+0, hi] separately
    spans = []
    bits = lambda v: int(np.float32(v).view(np.uint32))  # noqa: E731
    if lo < 0:
        spans.append((bits(hi) if hi < 0 else 0x80000000, bits(lo)))
    if hi > 0:
        spans.append((bits(max(lo, 0.0)), bits(hi)))
    for first, last in spans:
        for start in range(first, last + 1, chunk * stride):
            stop = min(start + chunk * stride, last + 1)
            x = np.arange(start, stop, stride, dtype=np.int64).astype(
                np.uint32
            ).view(np.float32)
            got = np.asarray(exp32(x), dtype=np.float64)
            exact = np.exp(x.astype(np.float64))
            error = np.abs(got - exact)
            normal = exact >= tiny
            if normal.any():
                _, e = np.frexp(exact[normal])
                worst_ulp = max(
                    worst_ulp, float(np.max(np.ldexp(error[normal], 24 - e)))
                )
            if (~normal).any():
                worst_abs = max(worst_abs, float(np.max(error[~normal])))
            points += x.size
    return {"max_ulp": worst_ulp, "max_abs_below_normal": worst_abs,
            "points": points}


# --- phases that run on the device (in a child process) ---------------------


def _mdd_ontology():
    """The flagship ontology with its sample panel decoded by MDD (one
    mismatch tolerated per index segment)."""
    from pheniqs_tpu.device.flagship import flagship_ontology

    ontology = flagship_ontology()
    sample = dict(ontology["sample"])
    sample["algorithm"] = "mdd"
    sample["distance tolerance"] = [1, 1]
    for key in ("noise", "confidence threshold", "random barcode probability"):
        sample.pop(key, None)
    ontology["sample"] = sample
    return ontology


def phase_step(distance_path: str, n: int = BATCH, seed: int = 11,
               iters: int = 10) -> dict:
    """Phase b on the default device: the decode step against the f64
    oracle for PAMLD sample + cellular, and for the sample panel as MDD.
    Raises SmokeFailure on any decision outside the uncertain mask or any
    unflagged confidence off by more than CONF_RTOL."""
    import jax
    import jax.numpy as jnp

    from pheniqs_tpu.decode.oracle import mdd_classify, pamld_classify
    from pheniqs_tpu.decode.spec import spec_from_ontology
    from pheniqs_tpu.device.classify import MATMUL_PRECISION
    from pheniqs_tpu.device.flagship import flagship_ontology, synthetic_batch
    from pheniqs_tpu.device.instrument import compile_instrument
    from pheniqs_tpu.device.step import make_decode_step
    from pheniqs_tpu.transform import SegmentBatch

    os.environ["PHENIQS_DISTANCE_PATH"] = distance_path
    pamld_ontology = flagship_ontology()
    batch_np = synthetic_batch(None, pamld_ontology, n, seed=seed)
    i7, i5, cell = (batch_np["segments"][s] for s in (1, 2, 3))
    sample_code = np.concatenate([i7[0], i5[0]], axis=1).astype(np.uint8)
    sample_qual = np.concatenate([i7[1], i5[1]], axis=1).astype(np.uint8)
    cell_code = cell[0][:, :16].astype(np.uint8)
    cell_qual = cell[1][:, :16].astype(np.uint8)
    no_fail = np.zeros(n, dtype=bool)

    report = {"distance_path": distance_path, "reads": n,
              "precision": str(MATMUL_PRECISION)}
    for label, ontology in (("pamld", pamld_ontology),
                            ("mdd", _mdd_ontology())):
        instrument = compile_instrument(ontology)
        device_batch = {
            "segments": [
                tuple(jnp.asarray(a) for a in batch_np["segments"][s])
                for s in instrument.used_segments
            ],
            "qcfail": jnp.asarray(batch_np["qcfail"]),
        }
        step = jax.jit(
            make_decode_step(instrument, want_uncertain=True,
                             want_counters=False)
        )
        per_read, _ = jax.block_until_ready(step(device_batch))
        started = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(step(device_batch))
        report[f"{label}_step_reads_per_s"] = n * iters / (
            time.perf_counter() - started
        )
        decoders = [
            {k: np.asarray(v) for k, v in entry.items()}
            for entry in per_read["decoders"]
        ]
        uncertain = np.zeros(n, dtype=bool)
        for entry in decoders:
            uncertain |= entry["uncertain"]
        report[f"{label}_flagged"] = int(uncertain.sum())

        sample_spec = spec_from_ontology(ontology["sample"], "sample")
        cell_spec = spec_from_ontology(ontology["cellular"][0], "cellular")
        if label == "pamld":
            sample_ref = pamld_classify(
                sample_spec, sample_code, sample_qual, no_fail
            )
        else:
            observation = [
                SegmentBatch(code=seg[0].astype(np.uint8),
                             quality=seg[1].astype(np.uint8),
                             length=seg[2])
                for seg in (i7, i5)
            ]
            sample_ref = mdd_classify(sample_spec, observation, no_fail)
        cell_ref = pamld_classify(
            cell_spec, cell_code, cell_qual, sample_ref.qcfail
        )
        # decoders in classify order: sample, molecular (naive), cellular
        checks = (("sample", decoders[0], sample_ref),
                  ("cellular", decoders[2], cell_ref))
        for name, dev, ref in checks:
            key = f"{label}_{name}"
            diff = decision_diff(dev["decoded"], dev["qcfail"],
                                 ref.decoded, ref.qcfail)
            report[f"{key}_differing"] = int(diff.sum())
            report[f"{key}_uncovered"] = uncovered(diff, uncertain)
            report[f"{key}_conf_violations"] = confidence_violations(
                dev["confidence"], ref.confidence, uncertain
            )
    failures = [k for k, v in report.items()
                if k.endswith(("_uncovered", "_conf_violations")) and v]
    if failures:
        raise SmokeFailure(f"step vs oracle ({distance_path}): {report}")
    return report


def phase_bound(stride: int = 1) -> dict:
    """Phase c: the hybrid bound's measured inputs on the default device.
    The posterior's exponentials take arguments in [LN_PHRED_BASE * 3233,
    0] (the shifted conditionals) and in (0, ln FLT_MAX] (the noise term
    rescaled into the shifted frame; beyond it the exact value overflows
    f32 too); at stride 1 every f32 of both ranges is measured."""
    from pheniqs_tpu.device.classify import _F64_UNDERFLOW_SIGMA
    from pheniqs_tpu.device.instrument import LN_PHRED_BASE, analytic_tpq_epsilon

    conditional = exp_ulp_error(
        LN_PHRED_BASE * _F64_UNDERFLOW_SIGMA, 0.0, stride=stride
    )
    # the largest f32 whose exact exponential is still a finite f32
    top = np.float32(np.log(np.finfo(np.float32).max))
    while np.exp(np.float64(top)) > np.finfo(np.float32).max:
        top = np.nextafter(top, np.float32(0))
    noise = exp_ulp_error(
        float(np.finfo(np.float32).tiny), float(top), stride=stride
    )
    report = {
        "exp_conditional": conditional,
        "exp_noise": noise,
        "analytic_tpq_epsilon": analytic_tpq_epsilon(),
    }
    if conditional["max_ulp"] > EXP_ULP_LIMIT:
        raise SmokeFailure(f"jnp.exp exceeds {EXP_ULP_LIMIT} ulp: {report}")
    if noise["max_ulp"] > NOISE_EXP_ULP_LIMIT:
        raise SmokeFailure(
            f"jnp.exp exceeds {NOISE_EXP_ULP_LIMIT} ulp on the noise term:"
            f" {report}"
        )
    if conditional["max_abs_below_normal"] > float(np.finfo(np.float32).tiny):
        raise SmokeFailure(f"jnp.exp below FLT_MIN: {report}")
    return report


def identity_child() -> dict:
    """Phase a: the device as JAX reports it."""
    import jax

    devices = jax.devices()
    identity = {"platform": devices[0].platform,
                "kind": devices[0].device_kind, "count": len(devices)}
    print(f"device: platform={identity['platform']} kind={identity['kind']}"
          f" count={identity['count']}", flush=True)
    print(f"jax: {jax.__version__}", flush=True)
    return identity


def device_child() -> dict:
    """Phases a-c in one process on the card (one process start, one
    device reservation)."""
    identity = identity_child()
    if identity["platform"] != "gpu":
        raise SmokeFailure(f"no GPU: JAX runs on {identity['platform']}")
    result = {"device": identity}
    for path in ("gather", "contraction"):
        started = time.perf_counter()
        report = phase_step(path)
        report["phase_s"] = time.perf_counter() - started
        print(f"step[{path}]: {json.dumps(report)}", flush=True)
        result[f"step_{path}"] = report
    started = time.perf_counter()
    bound = phase_bound()
    bound["phase_s"] = time.perf_counter() - started
    print(f"bound: {json.dumps(bound)}", flush=True)
    result["bound"] = bound
    return result


# --- orchestration (parent; never opens the card) ----------------------------


def _run_child(function: str, timeout: int, env=None) -> dict:
    """Run ``chip_smoke.<function>()`` in a fresh interpreter; echo its
    output and return the dict it hands back."""
    code = (
        "import json, chip_smoke; "
        f"print({_RESULT!r} + json.dumps(chip_smoke.{function}()))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=HERE, env=env,
        stdout=subprocess.PIPE, text=True, timeout=timeout,
    )
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(_RESULT):
            result = json.loads(line[len(_RESULT):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or result is None:
        raise SmokeFailure(f"{function} failed (exit {proc.returncode})")
    return result


def run_mux(paths, fidelity: str, out_dir: str, label: str, threads: int,
            batch: int, env: dict) -> dict:
    """One `mux` run over the flagship FASTQ: returns the SAM path, the
    report, the wall time and the hybrid re-resolution count."""
    from pheniqs_tpu.device.flagship import flagship_ontology

    base = flagship_ontology()
    sam = os.path.join(out_dir, f"{label}.sam")
    report_path = os.path.join(out_dir, f"{label}.json")
    config = {
        "input": list(paths),
        "template": {"transform": {"token": ["0::"]}},
        "sample": base["sample"],
        "cellular": base["cellular"],
        "molecular": base["molecular"],
        "output": [sam],
        "report url": report_path,
    }
    config_path = os.path.join(out_dir, f"{label}_job.json")
    with open(config_path, "w") as handle:
        json.dump(config, handle)
    started = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
         "--config", config_path, "--fidelity", fidelity,
         "--threads", str(threads), "--batch-size", str(batch)],
        cwd=HERE, env=dict(env, PHENIQS_TRACE="1"),
        capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - started
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SmokeFailure(f"mux {label} exit {proc.returncode}")
    resolved = re.search(r"re-resolution: (\d+) reads", proc.stderr)
    rate = re.search(r"reads in ([0-9.]+)s = ([0-9,]+) reads/s", proc.stderr)
    placement = re.findall(r"h2d placement: (.*)", proc.stderr)
    with open(report_path) as handle:
        report = json.load(handle)
    return {
        "sam": sam,
        "report": report,
        "wall_s": wall,
        "engine_s": float(rate.group(1)) if rate else None,
        "resolved": int(resolved.group(1)) if resolved else None,
        "placement": placement[0] if placement else None,
    }


def placement_ok(placement: str | None, reads_axis: int) -> bool:
    """Did each card receive only its own rows? ``placement`` is the
    engine's PHENIQS_TRACE line (engine/device.py _put_blob): every shard
    must hold batch / reads_axis rows."""
    if placement is None:
        return False
    fields = dict(item.split("=") for item in placement.split())
    rows = [int(r) for r in fields["rows"].split(",")]
    return len(rows) == 1 and rows[0] * reads_axis == int(fields["batch"])


def check_against_strict(run: dict, strict: dict, n_reads: int,
                         reads_axis: int | None = None) -> dict:
    """Phase d/e verdict for one device run against the strict run; with
    ``reads_axis`` the run's blob placement is checked too."""
    sam = compare_sam(run["sam"], strict["sam"])
    counts = report_counts(run["report"])
    strict_counts = report_counts(strict["report"])
    differing = sorted(
        k for k in set(counts) | set(strict_counts)
        if counts.get(k) != strict_counts.get(k)
    )
    verdict = {
        **sam,
        "report_count_keys": len(strict_counts),
        "report_count_mismatches": differing[:10],
        "resolved_share": (
            run["resolved"] / n_reads if run["resolved"] is not None else None
        ),
        "engine_reads_per_s": (
            n_reads / run["engine_s"] if run["engine_s"] else None
        ),
        "wall_reads_per_s": n_reads / run["wall_s"],
        "placement": run["placement"],
    }
    if reads_axis is not None:
        verdict["placement_ok"] = placement_ok(run["placement"], reads_axis)
    if (sam["records"] != n_reads or sam["mismatches"]
            or sam["tag_violations"] or differing or not strict_counts
            or verdict.get("placement_ok") is False):
        raise SmokeFailure(f"device run disagrees with strict: {verdict}")
    return verdict


def phase_e2e(n_reads: int = E2E_READS, batch: int = BATCH,
              threads: int | None = None, variants=(("hybrid", {}, None),),
              work: str = WORK, platform: str = "cuda") -> dict:
    """Phase d (and e): synthesize the flagship FASTQ, run each hybrid
    variant ``(label, extra env, reads-axis size or None)`` with
    JAX_PLATFORMS=``platform`` and the strict engine on the CPU, and
    compare each with strict. Pinning the platform makes a hybrid run
    fail where the CUDA backend does not start, instead of falling back
    to the CPU and passing as a GPU run. The parent process stays off
    the card."""
    from pheniqs_tpu.benchmark import synthesize_fastq_input

    threads = threads or os.cpu_count() or 4
    os.makedirs(work, exist_ok=True)
    started = time.perf_counter()
    paths = synthesize_fastq_input(os.path.join(work, "flagship"), n_reads)
    print(f"e2e: {n_reads} reads synthesized in"
          f" {time.perf_counter() - started:.1f}s", flush=True)
    env = dict(os.environ)
    runs = {}
    for label, extra, _ in variants:
        runs[label] = run_mux(paths, "hybrid", work, label, threads, batch,
                              dict(env, JAX_PLATFORMS=platform, **extra))
    strict = run_mux(paths, "strict", work, "strict", threads, batch,
                     dict(env, JAX_PLATFORMS="cpu"))
    result = {"strict_wall_reads_per_s": n_reads / strict["wall_s"]}
    print(f"e2e: strict {n_reads} reads in {strict['wall_s']:.1f}s"
          " (CPU, JAX_PLATFORMS=cpu)", flush=True)
    try:
        for label, _, reads_axis in variants:
            verdict = check_against_strict(runs[label], strict, n_reads,
                                           reads_axis)
            print(f"e2e[{label}]: {json.dumps(verdict)}", flush=True)
            result[label] = verdict
    finally:
        for run in (*runs.values(), strict):
            if os.path.exists(run["sam"]):
                os.unlink(run["sam"])
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="smoke test of the mux hybrid path on an NVIDIA GPU"
    )
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-GPU phase: the e2e job through the reads"
        " mesh and with PHENIQS_TP=2:2, each against strict",
    )
    args = parser.parse_args(argv)
    # fails fast outside a checkout
    from pheniqs_tpu.benchmark import card_identity

    try:
        if args.four:
            device = _run_child("identity_child", timeout=300)
            if device["platform"] != "gpu" or device["count"] < 4:
                raise SmokeFailure(f"--four needs four GPUs: {device}")
            phase_e2e(variants=(
                ("hybrid_reads_mesh", {}, 4),
                ("hybrid_tp_2x2", {"PHENIQS_TP": "2:2",
                                   "PHENIQS_TP_THRESHOLD": "100"}, 2),
            ))
        else:
            device = _run_child("device_child", timeout=900)["device"]
            phase_e2e()
        for line in card_identity():
            print(f"card: {line}", flush=True)
    except (SmokeFailure, subprocess.SubprocessError, OSError) as error:
        print(f"chip_smoke FAILED: {error}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {"platform": device["platform"], "kind": device["kind"],
                   "count": device["count"]},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
