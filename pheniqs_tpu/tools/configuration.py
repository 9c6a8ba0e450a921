"""Configuration artifacts generator (reference
tool/pheniqs-configuration-api.py): emits a zsh completion script from the
built-in CLI option specification. The reference generated an embedded
configuration.h as well; this framework ships the specification as Python
(config/builtin.py), so only the completion artifact remains.
"""

from __future__ import annotations

import argparse
import sys

#: zsh completion metadata per option name: (help, value spec)
_VALUE_SPECS = {
    "input": ': :_files -g "*.(fq|fq.gz|fastq|fastq.gz|bam|sam)"',
    "output": ': :_files -g "*.(fq|fq.gz|fastq|fastq.gz|bam|sam)"',
    "configuration url": ': :_files -g "*.json"',
    "report url": ': :_files -g "*.json"',
    "prior adjusted job url": ': :_files -g "*.json"',
    "base input url": ": :_files -/",
    "base output url": ": :_files -/",
    "default output format": ":default output format:(fastq sam bam)",
    "default output compression": ":default output compression:(none gz bgzf)",
    "default output compression level": (
        ":default output compression level:(0 1 2 3 4 5 6 7 8 9)"
    ),
    "platform": (
        ":platform:(CAPILLARY LS454 ILLUMINA SOLID HELICOS IONTORRENT ONT "
        "PACBIO ELEMENT)"
    ),
    "fidelity": ":fidelity:(strict fast)",
}

_HELP = {
    "help only": "Show this help",
    "input": "Path to an input file. May be repeated.",
    "output": "Path to an output file. May be repeated.",
    "configuration url": "Path to configuration file",
    "report url": "Path to report file",
    "prior adjusted job url": "Path to prior adjusted configuration file",
    "base input url": "Base input url",
    "base output url": "Base output url",
    "sense input layout": "Sense input segment layout",
    "filter outgoing qc fail": "Filter outgoing QC failed reads",
    "filter incoming qc fail": "Filter incoming QC failed reads",
    "leading segment index": "Leading read segment index",
    "default output format": "Default output format",
    "default output compression": "Default output compression",
    "default output compression level": "Default output compression level",
    "template token": "Output read token",
    "platform": "Sequencing platform",
    "enable quality control": "Enable quality control",
    "validate only": "Validate configuration file and emit a report",
    "display distance": "Display pairwise barcode distance during validation",
    "compile only": "Compile configuration file and emit the instruction",
    "static only": "Emit the static instruction",
    "include compiled job": "Include the compiled job in the report",
    "threads": "Thread pool size",
    "decoding threads": "Decoding thread count",
    "htslib threads": "IO thread count",
    "buffer capacity": "Feed buffer capacity",
    "float precision": "Floating point precision in reports",
    "fidelity": "Numeric fidelity: strict (f64 host) or fast (device f32)",
    "batch size": "Reads per device batch",
    "devices": "Device count override",
}


def generate_zsh(application: str = "pheniqs-tpu") -> str:
    from ..config.builtin import MUX_ACTION, _copy

    CONFIGURATION = {"action": [_copy(MUX_ACTION)]}
    safe = application.replace("-", "_")
    lines = [
        f"#compdef {application}",
        "",
        "# Auto generated from the built-in configuration specification.",
        "",
        f"_{safe}_commands() {{",
        "    local -a commands",
        "    commands=(",
    ]
    for action in CONFIGURATION.get("action", []):
        description = action.get("description", "")
        lines.append(f"        '{action['name']}:{description}'")
    lines += [
        "    )",
        "    _describe -t common-commands 'common commands' commands",
        "};",
        "",
    ]
    for action in CONFIGURATION.get("action", []):
        lines.append(f"_{safe}_{action['name']}() {{")
        lines.append("    _arguments -C \\")
        for option in action.get("option", []):
            handles = option["handle"]
            name = option["name"]
            help_text = _HELP.get(name, name)
            if len(handles) == 2:
                short, long = handles
                prefix = (
                    f"\\*{{{short},{long}}}"
                    if option.get("plural")
                    else f"'({short} {long})'{{{short},{long}}}"
                )
            else:
                prefix = f"'{handles[0]}'"
            entry = f"    {prefix}'[{help_text}]'"
            if option.get("type") != "boolean":
                value = _VALUE_SPECS.get(name, f":{name}:")
                entry += f"'{value}'"
            lines.append(entry + " \\")
        lines[-1] = lines[-1][:-2]  # strip trailing backslash
        lines.append("};")
        lines.append("")
    lines += [
        f"_{safe}() {{",
        '    local context curcontext="$curcontext" state state_descr line',
        "    typeset -A opt_args",
        "    _arguments -C \\",
        "        '(-h --help)'{-h,--help}'[Show help]' \\",
        "        '(-v --version)'{-v,--version}'[Show version]' \\",
        "        '1:command:->command' \\",
        "        '*::options:->options'",
        "    case $state in",
        "        command) ",
        f"            _{safe}_commands",
        "        ;;",
        "        options)",
        "            case $words[1] in",
    ]
    for action in CONFIGURATION.get("action", []):
        lines.append(f"                {action['name']})")
        lines.append(f"                    _{safe}_{action['name']}")
        lines.append("                ;;")
    lines += [
        "            esac",
        "        ;;",
        "    esac",
        "};",
        "",
        f"_{safe} \"$@\"",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pheniqs-tpu-configuration-api",
        description="generate CLI artifacts from the built-in configuration",
    )
    parser.add_argument("action", choices=["zsh"])
    parser.add_argument("--application", default="pheniqs-tpu")
    args = parser.parse_args(argv)
    if args.action == "zsh":
        sys.stdout.write(generate_zsh(args.application))
    return 0


if __name__ == "__main__":
    sys.exit(main())
