"""Command-line interface: parses argv against the built-in option
specification and assembles the "operation" document that drives a job —
the action ontology plus an `interactive` member holding exactly the
options the user passed (reference interface.cpp:947-1049).
"""

from __future__ import annotations

import os
import sys

from ..errors import CommandLineError
from ..version import __version__
from ..config.builtin import build_configuration
from ..config.jsonkit import sort_json


def format_command(argv: list[str]) -> str:
    return " ".join(argv)


class ParsedAction:
    def __init__(self, ontology: dict, argv: list[str]):
        self.ontology = ontology
        self.name = ontology.get("name", "")
        self.option_by_handle: dict[str, dict] = {}
        self.option_by_name: dict[str, dict] = {}
        for option in ontology.get("option", []):
            self.option_by_name[option["name"]] = option
            for handle in option["handle"]:
                self.option_by_handle[handle] = option
        self.interactive: dict = {}
        self.parse(argv)

    def parse(self, argv: list[str]):
        position = 0
        while position < len(argv):
            handle = argv[position]
            option = self.option_by_handle.get(handle)
            if option is None:
                raise CommandLineError(f"unknown argument {handle}")
            name = option["name"]
            if option.get("type") == "boolean":
                value = True
            else:
                position += 1
                if position >= len(argv):
                    raise CommandLineError(f"missing value for {handle}")
                raw = argv[position]
                if option.get("type") == "integer":
                    try:
                        value = int(raw)
                    except ValueError:
                        raise CommandLineError(f"{handle} value {raw} is not an integer")
                elif option.get("type") == "decimal":
                    try:
                        value = float(raw)
                    except ValueError:
                        raise CommandLineError(f"{handle} value {raw} is not a number")
                else:
                    value = raw
            if option.get("plural"):
                self.interactive.setdefault(name, []).append(value)
            else:
                self.interactive[name] = value
            position += 1

    def operation(self) -> dict:
        document = {
            k: v for k, v in self.ontology.items() if k != "option"
        }
        document["interactive"] = dict(self.interactive)
        return sort_json(document)


class Interface:
    def __init__(self, argv: list[str]):
        self.argv = argv
        self.application_name = argv[0] if argv else "pheniqs-tpu"
        self.application_version = __version__
        self.full_command = format_command(argv)
        self.working_directory = os.getcwd()

        self.configuration = build_configuration(
            application_name=self.application_name,
            application_version=self.application_version,
            full_command=self.full_command,
            working_directory=self.working_directory,
        )
        self.selected: ParsedAction | None = None
        self.help_triggered = False
        self.version_triggered = False
        self._select_action()

    def _select_action(self):
        argv = self.argv[1:]
        if not argv:
            self.help_triggered = True
            return
        if argv[0] in ("--version", "-v"):
            self.version_triggered = True
            return
        if argv[0] in ("--help", "-h"):
            self.help_triggered = True
            return
        action_by_name = {
            a["name"]: a for a in self.configuration.get("action", [])
        }
        if argv[0] in action_by_name:
            self.selected = ParsedAction(action_by_name[argv[0]], argv[1:])
            if self.selected.interactive.get("help only"):
                self.help_triggered = True
        else:
            raise CommandLineError(f"unknown action {argv[0]}")

    def operation(self) -> dict:
        if self.selected is None:
            raise CommandLineError("no action selected")
        return self.selected.operation()

    def print_version(self, stream=None):
        stream = stream or sys.stderr
        import numpy

        stream.write(f"pheniqs-tpu version {self.application_version}\n")
        stream.write(f"numpy {numpy.__version__}\n")
        try:
            import jax

            stream.write(f"jax {jax.__version__}\n")
        except Exception:
            pass

    def print_help(self, stream=None):
        stream = stream or sys.stderr
        stream.write(
            "pheniqs-tpu: accelerated barcode classification\n\n"
            "Usage: pheniqs-tpu mux [OPTIONS]\n\n"
            "Options:\n"
        )
        for action in self.configuration.get("action", []):
            if action["name"] != "mux":
                continue
            for option in action.get("option", []):
                handles = ", ".join(option["handle"])
                stream.write(f"  {handles:32s} {option.get('help', '')}\n")
