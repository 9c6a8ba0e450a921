"""Built-in interface configuration: global defaults, projection templates
and the CLI option surface.

This is the Python equivalent of the reference's embedded configuration
document (reference configuration.json, compiled into the binary by
tool/pheniqs-configuration-api.py): a single source of truth for option
parsing, default values, and the projection repository that decoder and
barcode compilation draws templates from.
"""

from __future__ import annotations

import os

#: root-level global defaults (reference configuration.json `default`)
ROOT_DEFAULT = {
    "buffer capacity": 2048,
    "corrected quality": 30,
    "float precision": 15,
    "input phred offset": 33,
    "leading segment index": 0,
    "output phred offset": 33,
    "platform": "ILLUMINA",
}

#: projection templates (reference configuration.json `projection`)
PROJECTION = {
    "action": {
        "application name": None,
        "application version": None,
        "base input url": None,
        "base output url": None,
        "default": None,
        "epilog": None,
        "full command": None,
        "implementation": "generic",
        "include compiled job": None,
        "license": None,
        "projection": None,
        "schema": None,
        "working directory": None,
    },
    "sample:decoder": {
        "CN": None,
        "DT": None,
        "LB": None,
        "PG": None,
        "PI": None,
        "PL": None,
        "PM": None,
        "SM": None,
        "algorithm": "pamld",
        "codec": None,
        "confidence threshold": 0.95,
        "corrected quality": None,
        "distance tolerance": None,
        "flowcell id": None,
        "flowcell lane number": None,
        "high quality distance threshold": 0,
        "high quality threshold": 30,
        "noise": 0.01,
        "quality masking threshold": 0,
        "segment cardinality": 0,
        "undetermined": None,
    },
    "sample:barcode": {
        "CN": None,
        "DT": None,
        "LB": None,
        "PG": None,
        "PI": None,
        "PL": None,
        "PM": None,
        "SM": None,
        "algorithm": None,
        "concentration": 1,
        "flowcell id": None,
        "flowcell lane number": None,
        "segment cardinality": None,
    },
    "cellular:decoder": {
        "algorithm": "pamld",
        "codec": None,
        "confidence threshold": 0.95,
        "corrected quality": None,
        "distance tolerance": None,
        "high quality distance threshold": 0,
        "high quality threshold": 30,
        "noise": 0.01,
        "quality masking threshold": 0,
        "segment cardinality": 0,
        "undetermined": None,
    },
    "cellular:barcode": {
        "algorithm": None,
        "concentration": 1,
        "segment cardinality": None,
    },
    "molecular:decoder": {
        "algorithm": "naive",
        "codec": None,
        "confidence threshold": 0.95,
        "corrected quality": None,
        "distance tolerance": None,
        "high quality distance threshold": 0,
        "high quality threshold": 30,
        "noise": 0.01,
        "quality masking threshold": 0,
        "segment cardinality": 0,
        "undetermined": None,
    },
    "molecular:barcode": {
        "algorithm": None,
        "concentration": 1,
        "segment cardinality": None,
    },
    "multiplex:decoder": {
        "base output url": None,
        "enable quality control": None,
        "filter outgoing qc fail": False,
        "output": None,
    },
    "multiplex:barcode": {
        "enable quality control": None,
        "filter outgoing qc fail": False,
        "output": None,
    },
}

#: the `mux` action: defaults and option surface (reference
#: configuration.json action[0])
MUX_ACTION = {
    "name": "mux",
    "description": "Multiplex and Demultiplex annotated DNA sequence reads",
    "implementation": "transcode",
    "default": {
        "default output compression": "unknown",
        "default output compression level": "5",
        "default output format": "sam",
        "filter incoming qc fail": False,
        "filter outgoing qc fail": False,
        "input": ["/dev/stdin"],
        "output": ["/dev/stdout"],
        "report url": "/dev/stderr",
        "sample": {"algorithm": "passthrough"},
    },
    "option": [
        {"name": "help only", "handle": ["-h", "--help"], "type": "boolean", "help": "Show this help"},
        {"name": "input", "handle": ["-i", "--input"], "type": "url", "plural": True, "help": "Path to an input feed; repeat per segment"},
        {"name": "output", "handle": ["-o", "--output"], "type": "url", "plural": True, "help": "Path to an output feed; repeatable"},
        {"name": "configuration url", "handle": ["-c", "--config"], "type": "url", "help": "Path to the instruction file"},
        {"name": "report url", "handle": ["-R", "--report"], "type": "url", "help": "Path to the run report"},
        {"name": "prior adjusted job url", "handle": ["--prior"], "type": "url", "help": "Emit a prior-adjusted instruction here"},
        {"name": "base input url", "handle": ["-I", "--base-input"], "type": "url", "help": "Base directory for relative input paths"},
        {"name": "base output url", "handle": ["-O", "--base-output"], "type": "url", "help": "Base directory for relative output paths"},
        {"name": "sense input layout", "handle": ["-s", "--sense-input"], "type": "boolean", "help": "Detect the interleaving layout of the input"},
        {"name": "filter outgoing qc fail", "handle": ["-n", "--no-output-npf"], "type": "boolean", "help": "Drop reads that fail quality control from the output"},
        {"name": "filter incoming qc fail", "handle": ["-N", "--no-input-npf"], "type": "boolean", "help": "Drop incoming reads flagged as failing quality control"},
        {"name": "leading segment index", "handle": ["-l", "--leading"], "type": "integer", "help": "Index of the segment that drives read metadata"},
        {"name": "default output format", "handle": ["-F", "--format"], "type": "string", "help": "Output format: sam, bam, cram or fastq"},
        {"name": "default output compression", "handle": ["-Z", "--compression"], "type": "string", "help": "Output compression: gz, bgzf, none"},
        {"name": "default output compression level", "handle": ["-L", "--level"], "type": "string", "help": "Output compression level 0-9"},
        {"name": "template token", "handle": ["-T", "--token"], "type": "string", "plural": True, "help": "Output template token; repeatable"},
        {"name": "platform", "handle": ["-P", "--platform"], "type": "string", "help": "Sequencing platform for read group metadata"},
        {"name": "enable quality control", "handle": ["-q", "--quality"], "type": "boolean", "help": "Collect per-cycle quality statistics per channel"},
        {"name": "validate only", "handle": ["-V", "--validate"], "type": "boolean", "help": "Print the compiled instruction in human form and exit"},
        {"name": "display distance", "handle": ["-D", "--distance"], "type": "boolean", "help": "With --validate: print barcode distance metrics"},
        {"name": "compile only", "handle": ["-C", "--compile"], "type": "boolean", "help": "Print the compiled instruction as JSON and exit"},
        {"name": "static only", "handle": ["-S", "--static"], "type": "boolean", "help": "Print the assembled instruction as JSON and exit"},
        {"name": "include compiled job", "handle": ["-j", "--job"], "type": "boolean", "help": "Embed the compiled instruction in the report"},
        {"name": "threads", "handle": ["-t", "--threads"], "type": "integer", "help": "Worker process count for the strict engine"},
        {"name": "decoding threads", "handle": ["--decoding-threads"], "type": "integer", "help": "Override the decoding worker count"},
        {"name": "htslib threads", "handle": ["--htslib-threads"], "type": "integer", "help": "Compression thread pool size"},
        {"name": "buffer capacity", "handle": ["-B", "--buffer"], "type": "integer", "help": "Feed buffer capacity in reads"},
        {"name": "float precision", "handle": ["--precision"], "type": "integer", "help": "Significant digits in emitted JSON numbers"},
        # device-engine extensions (not present in the reference)
        {"name": "fidelity", "handle": ["--fidelity"], "type": "string", "help": "Decode fidelity: strict (f64 host), fast (device f32), hybrid (device + f64 re-resolve)"},
        {"name": "batch size", "handle": ["--batch-size"], "type": "integer", "help": "Reads per device batch"},
        {"name": "devices", "handle": ["--devices"], "type": "integer", "help": "Limit the number of accelerator devices"},
    ],
}


def detected_threads() -> int:
    return max(1, os.cpu_count() or 1)


def build_configuration(
    application_name: str,
    application_version: str,
    full_command: str,
    working_directory: str,
    threads: int | None = None,
) -> dict:
    """Assemble the interface configuration document with environment
    details injected into the default node (reference
    interface.cpp:1060-1117 apply_action_base)."""
    from .jsonkit import merge_json, project_json

    configuration = {
        "name": "pheniqs-tpu",
        "default": dict(ROOT_DEFAULT),
        "projection": {k: _copy(v) for k, v in PROJECTION.items()},
        "schema": {"instruction:lax": {"type": "object"}},
        "action": [_copy(MUX_ACTION)],
    }
    default = configuration["default"]
    default["working directory"] = working_directory
    default["base input url"] = working_directory
    default["base output url"] = working_directory
    default["application version"] = application_version
    default["application name"] = application_name
    default["full command"] = full_command
    default["threads"] = threads if threads is not None else detected_threads()

    # project the root onto the action template and merge into each action
    action_projection = configuration["projection"]["action"]
    action_template = project_json(action_projection, configuration)
    if isinstance(action_template, dict):
        projection = action_template.get("projection")
        if isinstance(projection, dict):
            projection.pop("action", None)
    for action in configuration["action"]:
        merged = merge_json(action_template, action)
        action.clear()
        action.update(merged)
    return configuration


def _copy(value):
    if isinstance(value, dict):
        return {k: _copy(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_copy(v) for v in value]
    return value
