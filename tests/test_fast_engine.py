"""End-to-end `--fidelity fast` (device path) vs strict on BDGGG.

The fast engine must make identical classification decisions (RG
assignment, qcfail flags, corrected barcodes, channel routing) on the real
BDGGG workload; float confidence tags (XB/XM/XC) may differ within f32
tolerance of the strict f64 values.
"""

import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_mux(reference_root, config, fidelity):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    # run the subprocess on the CPU backend
    env["JAX_PLATFORMS"] = "cpu"
    result = subprocess.run(
        [
            sys.executable,
            "-m",
            "pheniqs_tpu.cli.main",
            "mux",
            "--config",
            config,
            "--precision",
            "15",
            "--fidelity",
            fidelity,
        ],
        cwd=reference_root,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert result.returncode == 0, result.stderr[-4000:]
    return result


FLOAT_TAGS = ("XB:f:", "XM:f:", "XC:f:")


def split_tags(line):
    fields = line.rstrip("\n").split("\t")
    fixed, floats = [], {}
    for field in fields:
        if field[:5] in FLOAT_TAGS:
            floats[field[:5]] = float(field[5:])
        else:
            fixed.append(field)
    return fixed, floats


def test_fast_matches_strict_on_bdggg(reference_root, bdggg):
    config = os.path.join(bdggg, "BDGGG_annotated.json")
    strict = run_mux(reference_root, config, "strict")
    fast = run_mux(reference_root, config, "fast")

    strict_lines = strict.stdout.split("\n")
    fast_lines = fast.stdout.split("\n")
    assert len(strict_lines) == len(fast_lines)

    for s_line, f_line in zip(strict_lines, fast_lines):
        if s_line.startswith("@"):
            assert f_line.startswith("@")
            continue
        s_fixed, s_floats = split_tags(s_line)
        f_fixed, f_floats = split_tags(f_line)
        assert s_fixed == f_fixed, (s_line, f_line)
        assert set(s_floats) == set(f_floats)
        for tag, s_value in s_floats.items():
            f_value = f_floats[tag]
            assert math.isclose(s_value, f_value, rel_tol=5e-4, abs_tol=5e-6), (
                tag,
                s_value,
                f_value,
            )


def test_devices_option_limits_mesh(reference_root):
    """--devices 1 restricts the data-parallel mesh to one device; output
    decisions are unchanged (and identical to the unrestricted run)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    outputs = {}
    for devices in ("1", "8"):
        result = subprocess.run(
            [sys.executable, "-m", "pheniqs_tpu.cli.main", "mux",
             "--config", "test/BDGGG/BDGGG_annotated.json",
             "--precision", "15", "--fidelity", "fast",
             "--devices", devices],
            cwd=reference_root, env=env, capture_output=True, text=True,
            timeout=600,
        )
        assert result.returncode == 0, result.stderr[-2000:]
        outputs[devices] = [
            line for line in result.stdout.splitlines()
            if not line.startswith("@")
        ]
    assert outputs["1"] == outputs["8"]

    # in-process: the mesh really shrinks
    import json as _json
    import jax

    from pheniqs_tpu.engine.device import DeviceEngine
    from pheniqs_tpu.cli.interface import Interface
    from pheniqs_tpu.config.compiler import InstructionCompiler

    interface = Interface(
        ["pheniqs-tpu", "mux",
         "--config", os.path.join(reference_root, "test/BDGGG/BDGGG_annotated.json"),
         "--base-input", os.path.join(reference_root, "test/BDGGG"),
         "--devices", "1"]
    )
    compiler = InstructionCompiler(interface.operation())
    compiler.assemble()
    engine = DeviceEngine(compiler.compile())
    assert engine.ontology.get("devices") == 1
    assert engine._mesh() is None  # single device -> no mesh
