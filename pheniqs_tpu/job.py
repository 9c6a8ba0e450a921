"""Job lifecycle: assemble -> compile -> execute -> finalize -> write result
(reference job.h:34-51, pipeline.cpp:75-104).

Modes: --validate (describe only), --compile (emit compiled instruction),
--static (emit assembled instruction), or a full transcode run.
"""

from __future__ import annotations

import sys

from .config.compiler import InstructionCompiler, write_compiled_instruction
from .config.jsonkit import clean_json_object, sort_json, write_json
from .config.url import URL
from .errors import PheniqsError


class TranscodeJob:
    def __init__(self, operation: dict):
        self.operation = operation
        self.interactive = operation.get("interactive", {})
        self.compiler = InstructionCompiler(operation)
        self.ontology: dict = {}
        self.engine = None
        self.report: dict = {}

    @property
    def float_precision(self) -> int:
        return int(self.ontology.get("float precision", 15))

    def is_validate_only(self) -> bool:
        return bool(self.interactive.get("validate only"))

    def is_compile_only(self) -> bool:
        return bool(self.interactive.get("compile only"))

    def is_static_only(self) -> bool:
        return bool(self.interactive.get("static only"))

    def run(self, stdout=None, stderr=None):
        stdout = stdout if stdout is not None else sys.stdout
        stderr = stderr if stderr is not None else sys.stderr

        self.compiler.assemble()
        if self.is_static_only():
            assembled = self.compiler.apply_interactive_ontology(
                _deep_copy(self.compiler.instruction)
            )
            assembled = clean_json_object(sort_json(assembled))
            stdout.write(write_json(assembled, 324) + "\n")
            return

        self.ontology = self.compiler.compile()
        if self.is_compile_only():
            stdout.write(
                write_compiled_instruction(self.ontology, self.float_precision)
                + "\n"
            )
            return
        if self.is_validate_only():
            from .describe import describe_instruction

            describe_instruction(
                self.ontology,
                stdout,
                display_distance=bool(self.interactive.get("display distance")),
            )
            return

        self.execute(stdout)
        self.write_result(stdout, stderr)

    def _warn_cpu_device_mode(self, fidelity: str):
        """The device fidelities exist for accelerators; on a CPU-only
        backend the XLA-compiled step is the SLOWEST engine on this
        workload class (measured on a 4-core CPU host: CPU-XLA hybrid
        105-143k reads/s vs strict --threads 4 at 204k) while
        `--fidelity strict` gives the same decisions (hybrid's contract)
        faster. Warn loudly so a CPU-only user does not silently get the
        worst engine; PHENIQS_QUIET_CPU_DEVICE=1 silences (test meshes
        run device modes on the CPU backend on purpose)."""
        import os as os_mod
        import sys as sys_mod

        if os_mod.environ.get("PHENIQS_QUIET_CPU_DEVICE") == "1":
            return
        try:
            import jax

            platform = jax.default_backend()
        except Exception:
            return
        if platform == "cpu":
            # hybrid's contract IS strict-identical decisions; fast's
            # boundary decisions may differ, so only claim identity
            # where it holds (docs/cli.md mode matrix)
            tail = (
                "gives identical decisions faster on CPU"
                if fidelity == "hybrid"
                else "is faster on CPU and is the reference-exact engine"
            )
            sys_mod.stderr.write(
                f"[pheniqs-tpu] warning: --fidelity {fidelity} on a"
                " CPU-only backend is the slowest engine for this"
                f" workload; --fidelity strict {tail}"
                " (docs/cli.md mode matrix)\n"
            )

    def execute(self, stdout):
        fidelity = self.interactive.get("fidelity", "strict")
        from .engine.strict import StrictEngine

        # our workers each run the whole per-read pipeline, so the worker
        # count is the full --threads budget; the reference's derived
        # "decoding threads" split (transcode.cpp:1491-1500, ~1 for short
        # barcodes) only applies when the user overrides it explicitly
        import os as os_mod

        # an EXPLICIT decoding-thread override (CLI or instruction file)
        # wins; otherwise the full --threads budget. The compiled
        # ontology's "decoding threads" is ignored here because the
        # compiler derives it with the reference's io/decode split
        # (transcode.cpp:1491-1500), which does not describe our workers.
        explicit = self.interactive.get("decoding threads") or (
            self.compiler.instruction.get("decoding threads")
            if isinstance(self.compiler.instruction, dict)
            else None
        )
        threads = int(explicit or self.ontology.get("threads") or 1)
        # more workers than cores oversubscribes the host
        threads = min(threads, os_mod.cpu_count() or threads)
        # CRAM output streams too: workers build compressed slice parts,
        # the parent stamps the format's sequential record counters in raw
        # batch order (io/cram.py CramPartBuilder)
        # device modes: the parent owns ingest+classify+stats and the rest
        # of the thread budget renders; strict mode: autonomous workers own
        # the whole pipeline, so they get the full budget (reference
        # transcode.cpp:1491-1500 splits its budget the same way between
        # io and decoding threads)
        workers = max(1, threads - 1)
        if fidelity in ("strict", "exact", None):
            if threads > 1:
                from .engine.stream import StreamedStrictEngine

                self.engine = StreamedStrictEngine(self.ontology, threads)
            else:
                self.engine = StrictEngine(self.ontology)
        elif fidelity in ("fast", "device"):
            from .engine.device import DeviceEngine, StreamedDeviceEngine

            self._warn_cpu_device_mode(fidelity)
            if threads > 1:
                self.engine = StreamedDeviceEngine(self.ontology, workers=workers)
            else:
                self.engine = DeviceEngine(self.ontology)
        elif fidelity == "hybrid":
            from .engine.device import DeviceEngine, StreamedDeviceEngine

            self._warn_cpu_device_mode(fidelity)
            if threads > 1:
                self.engine = StreamedDeviceEngine(
                    self.ontology, hybrid=True, workers=workers
                )
            else:
                self.engine = DeviceEngine(self.ontology, hybrid=True)
        else:
            from .errors import ConfigurationError

            raise ConfigurationError(
                f"unknown fidelity {fidelity}; expected strict, fast or hybrid"
            )
        batch_size = int(self.interactive.get("batch size", 16384))
        self.engine.execute(batch_size=batch_size)
        import os

        partial_path = os.environ.get("PHENIQS_PARTIAL")
        if partial_path:
            # one input shard of a PHENIQS_SHARD=k:H run: dump the raw
            # statistic sums for `pheniqs_tpu.tools.merge` to recombine
            import json

            with open(partial_path, "w") as stream:
                json.dump(self.engine.dump_partial_state(), stream)
        include_job = None
        if self.ontology.get("include compiled job"):
            import copy

            include_job = copy.deepcopy(self.ontology)
            if isinstance(include_job.get("feed"), dict):
                include_job["feed"].pop("sensed", None)
        self.report = self.engine.finalize_report(include_job)

    def write_result(self, stdout, stderr):
        report_url = URL(self.ontology.get("report url", "/dev/stderr"))
        payload = write_json(self.report, self.float_precision) + "\n"
        if report_url.is_dev_null():
            pass
        elif report_url.is_stdout():
            stdout.write(payload)
        elif report_url.is_stderr():
            stderr.write(payload)
        else:
            with open(report_url.path, "w") as stream:
                stream.write(write_json(self.report, self.float_precision))

        prior_url_encoded = self.ontology.get("prior adjusted job url")
        if prior_url_encoded:
            prior_url = URL(prior_url_encoded)
            if not prior_url.is_dev_null():
                from .report.prior import apply_prior_adjustment

                adjusted = _deep_copy(self.compiler.instruction)
                adjusted = self.compiler.apply_interactive_ontology(adjusted)
                apply_prior_adjustment(adjusted, self.engine)
                adjusted = clean_json_object(sort_json(adjusted))
                payload = write_json(adjusted, self.float_precision) + "\n"
                if prior_url.is_stdout():
                    stdout.write(payload)
                elif prior_url.is_stderr():
                    stderr.write(payload)
                else:
                    with open(prior_url.path, "w") as stream:
                        stream.write(
                            write_json(adjusted, self.float_precision)
                        )


def _deep_copy(value):
    if isinstance(value, dict):
        return {k: _deep_copy(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_deep_copy(v) for v in value]
    return value


def run_job(argv: list[str], stdout=None, stderr=None) -> int:
    from .cli.interface import Interface

    try:
        interface = Interface(argv)
        if interface.version_triggered:
            interface.print_version(stderr or sys.stderr)
            return 0
        if interface.help_triggered:
            interface.print_help(stderr or sys.stderr)
            return 0
        operation = interface.operation()
        job = TranscodeJob(operation)
        job.run(stdout, stderr)
        return 0
    except PheniqsError as error:
        (stderr or sys.stderr).write(error.describe() + "\n")
        return error.code
