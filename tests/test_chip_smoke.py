"""chip_smoke.py: its comparison helpers, its phases at small sizes on the
CPU backend, its refusal to run without a GPU, and (marked ``gpu``) its
step and bound phases at full width on the card."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "dev_decoded, dev_qcfail, expected",
    [
        ([1, 2, 3], [0, 0, 1], [False, False, False]),
        ([1, 5, 3], [0, 0, 1], [False, True, False]),  # barcode differs
        ([1, 2, 3], [1, 0, 1], [True, False, False]),  # qcfail differs
    ],
)
def test_decision_diff(dev_decoded, dev_qcfail, expected):
    diff = chip_smoke.decision_diff(dev_decoded, dev_qcfail, [1, 2, 3],
                                    [0, 0, 1])
    assert diff.tolist() == expected


@pytest.mark.parametrize(
    "diff, uncertain, expected",
    [
        ([0, 1, 1, 0], [0, 1, 1, 0], 0),  # every difference flagged
        ([0, 1, 1, 0], [1, 1, 0, 0], 1),  # one difference escaped the mask
        ([0, 0, 0, 0], [1, 1, 1, 1], 0),  # flags without differences
    ],
)
def test_uncovered_is_the_mask_containment_check(diff, uncertain, expected):
    assert chip_smoke.uncovered(
        np.asarray(diff, bool), np.asarray(uncertain, bool)
    ) == expected


@pytest.mark.parametrize(
    "dev, ref, flagged, expected",
    [
        (0.95 * (1 + 0.9e-5), 0.95, False, 0),  # inside 1e-5 relative
        (0.95 * (1 + 1.1e-5), 0.95, False, 1),  # outside
        (0.95 * (1 + 1e-3), 0.95, True, 0),  # flagged rows re-resolve in f64
        (0.0, 0.0, False, 0),
        (1e-30, 0.0, False, 1),  # a zero oracle confidence needs a zero
    ],
)
def test_confidence_violations(dev, ref, flagged, expected):
    assert chip_smoke.confidence_violations(
        [dev], [ref], np.asarray([flagged])
    ) == expected


@pytest.mark.parametrize(
    "device, strict, agree",
    [
        ({"XB": "0.25"}, {"XB": "0.25"}, True),
        # 1 - XB is the confidence: 0.75 vs 0.75 * (1 - 2e-6)
        ({"XB": "0.250002"}, {"XB": "0.25"}, True),
        ({"XB": "0.2501"}, {"XB": "0.25"}, False),
        # tiny error probabilities: relative error on XB is meaningless,
        # the confidences 1 - 1.2e-9 and 1 - 3.5e-9 agree to 1e-5
        ({"XB": "3.5e-09"}, {"XB": "1.2e-09"}, True),
        # f32 confidence rounded to 1.0 drops the tag on one side
        ({}, {"XC": "4.8e-09"}, True),
        ({"XC": "0.3"}, {}, False),
        ({"XB": "0.25", "XC": "0.1"}, {"XB": "0.25", "XC": "0.2"}, False),
    ],
)
def test_float_tags_agree(device, strict, agree):
    assert chip_smoke.float_tags_agree(device, strict) is agree


def _sam(path, records):
    with open(path, "w") as handle:
        handle.write("@HD\tVN:1.0\n")
        for record in records:
            handle.write("\t".join(record) + "\n")
    return str(path)


def test_compare_sam(tmp_path):
    base = ["r1", "4", "*", "BC:Z:ACGT", "XB:f:0.25"]
    same = _sam(tmp_path / "a.sam", [base, ["r2", "4", "*", "XB:f:0.5"]])
    strict = _sam(tmp_path / "b.sam", [base, ["r2", "4", "*", "XB:f:0.5"]])
    assert chip_smoke.compare_sam(same, strict) == {
        "records": 2, "mismatches": 0, "tag_violations": 0,
    }
    other = _sam(tmp_path / "c.sam", [base, ["r2", "516", "*", "XB:f:0.6"]])
    assert chip_smoke.compare_sam(other, strict)["mismatches"] == 1
    tags = _sam(tmp_path / "d.sam", [base, ["r2", "4", "*", "XB:f:0.6"]])
    assert chip_smoke.compare_sam(tags, strict)["tag_violations"] == 1
    short = _sam(tmp_path / "e.sam", [base])
    assert chip_smoke.compare_sam(short, strict)["mismatches"] == 1


def test_report_counts():
    doc = {
        "incoming": {"count": 10, "pf count": 9},
        "sample": {
            "classified": [{"count": 4, "pf pooled fraction": 0.5},
                           {"count": 6}],
            "average classified confidence": 0.99,
        },
    }
    assert chip_smoke.report_counts(doc) == {
        "/incoming/count": 10,
        "/incoming/pf count": 9,
        "/sample/classified[0]/count": 4,
        "/sample/classified[1]/count": 6,
    }


@pytest.mark.parametrize(
    "placement, reads_axis, ok",
    [
        ("shards=4 rows=32768 batch=131072", 4, True),
        ("shards=4 rows=65536 batch=131072", 2, True),  # (2, 2) TP mesh
        ("shards=4 rows=131072 batch=131072", 4, False),  # replicated
        ("shards=2 rows=32768,98304 batch=131072", 2, False),
        (None, 4, False),
    ],
)
def test_placement_ok(placement, reads_axis, ok):
    assert chip_smoke.placement_ok(placement, reads_axis) is ok


def test_exp_ulp_error_on_the_cpu_backend():
    """The measurement itself: XLA:CPU's f32 exp stays within the 2-ulp
    assumption on the conditionals' range (sampled here; stride 1 on the
    card)."""
    result = chip_smoke.exp_ulp_error(-744.4, 0.0, stride=4099)
    assert result["points"] > 250_000
    assert 0.0 < result["max_ulp"] <= chip_smoke.EXP_ULP_LIMIT
    assert result["max_abs_below_normal"] <= np.finfo(np.float32).tiny


@pytest.mark.parametrize("path", ["gather", "contraction"])
def test_step_phase_on_the_cpu_backend(monkeypatch, path):
    """Phase b at a small batch: every decision that differs from the
    f64 oracle is flagged, unflagged confidences within 1e-5."""
    monkeypatch.setenv("PHENIQS_DISTANCE_PATH", path)  # restored afterwards
    report = chip_smoke.phase_step(path, n=2048, iters=1)
    assert report["reads"] == 2048
    for label in ("pamld_sample", "pamld_cellular", "mdd_sample",
                  "mdd_cellular"):
        assert report[f"{label}_uncovered"] == 0, report
        assert report[f"{label}_conf_violations"] == 0, report


def test_e2e_phase_on_the_cpu_mesh(tmp_path):
    """Phase d/e at a small size: hybrid over the test suite's 8-device
    CPU reads mesh against strict, blob placement included."""
    result = chip_smoke.phase_e2e(
        n_reads=4096, batch=1024, threads=2,
        variants=(("hybrid_mesh", {}, 8),), work=str(tmp_path),
        platform="cpu",
    )
    verdict = result["hybrid_mesh"]
    assert verdict["records"] == 4096
    assert verdict["mismatches"] == 0 and verdict["tag_violations"] == 0
    assert verdict["placement_ok"] is True
    assert verdict["report_count_keys"] > 0
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".sam")]


def test_e2e_phase_fails_without_a_gpu(tmp_path):
    """Phase d pins its hybrid runs to CUDA: on a host without a GPU the
    hybrid `mux` fails instead of passing on the CPU backend."""
    with pytest.raises(chip_smoke.SmokeFailure, match="mux hybrid exit"):
        chip_smoke.phase_e2e(n_reads=1024, batch=1024, threads=1,
                             work=str(tmp_path))


def _run(args, cwd, env=None):
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu", **(env or {})),
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_a_gpu(script):
    result = _run([script], REPO, {"PHENIQS_BENCH_MODE": "step"})
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
    assert "platform=cpu" in result.stdout


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Outside a checkout the smoke test must fail, not pass vacuously."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300, env=env,
    )
    assert result.returncode != 0
    assert not result.stdout.strip().endswith("}")


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["gather", "contraction"])
def test_step_phase_on_the_gpu(gpu, path, monkeypatch):
    monkeypatch.setenv("PHENIQS_DISTANCE_PATH", path)
    report = chip_smoke.phase_step(path)
    assert report["reads"] == chip_smoke.BATCH
    print(json.dumps(report))


@pytest.mark.gpu
def test_bound_phase_on_the_gpu(gpu):
    report = chip_smoke.phase_bound(stride=97)
    assert report["exp_conditional"]["max_ulp"] <= chip_smoke.EXP_ULP_LIMIT
