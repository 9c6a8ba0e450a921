"""Stable-key AOT program store: survive source edits without re-paying
the cold compile.

The XLA persistent compilation cache keys on the unoptimized HLO module
*including* per-op source-file/line metadata, so ANY edit to a module on
the traced path (even shifted line numbers) re-keys the decode-step
program and re-pays the cold compile. This store removes the
source-location sensitivity by caching the *serialized exported program*
(``jax.export`` StableHLO bytes) on disk under a SEMANTIC key::

    sha256(jax version | backend platform | abstract input signature |
           jaxpr structure printout (carries no source locations) |
           every closed-over constant's bytes)

A source edit that only shifts line numbers traces to the identical
jaxpr structure and constants -> same key -> the saved artifact is
reused; and because the artifact's StableHLO bytes are then byte-stable
across processes, XLA's persistent compile cache hits too. An edit that
CHANGES the traced computation (different ops, shapes, thresholds or
panel constants) changes the jaxpr text or a constant hash -> new key ->
honest recompile. Serializing an export needs the ``flatbuffers``
package; where it is missing the store falls back to plain ``jax.jit``
(and says so under PHENIQS_TRACE).

Scope: the engine's single-device decode step. Sharded/TP steps keep
plain ``jax.jit`` — their mesh topology belongs in the key.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time

import numpy as np

from .. import CHECKOUT

__all__ = [
    "CHECKOUT_CACHE",
    "aot_jit",
    "aot_cache_dir",
    "cpu_fingerprint",
    "semantic_key",
]

#: the compile-cache root where JAX_COMPILATION_CACHE_DIR is unset: one
#: fixed path inside the checkout (listed in .gitignore)
CHECKOUT_CACHE = os.path.join(CHECKOUT, ".jax_cache")


def _trace(message: str):
    if os.environ.get("PHENIQS_TRACE"):
        print(f"pheniqs aot: {message}", file=sys.stderr, flush=True)


def aot_cache_dir() -> str | None:
    """Artifact directory (PHENIQS_AOT=dir, =0 disables; default ``aot``
    under the XLA compile-cache root — JAX_COMPILATION_CACHE_DIR, else
    CHECKOUT_CACHE — so both caches travel together)."""
    value = os.environ.get("PHENIQS_AOT")
    if value == "0":
        return None
    if value:
        return value
    base = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE
    return os.path.join(base, "aot")


def cpu_fingerprint() -> str:
    """The host CPU's identity as XLA:CPU sees it: ISA feature flags plus
    the model identity. The model lines matter as much as the flags —
    XLA:CPU bakes LLVM tuning attributes derived from the CPU *model*
    (``+prefer-no-gather`` etc., cpu_aot_loader.cc) into AOT artifacts,
    so two hosts with identical cpuinfo flags can still produce
    incompatible executables (observed in the round-3 multichip dryrun:
    the loader warned a cached artifact may SIGILL)."""
    import platform as platform_mod

    flags = ""
    identity: dict[str, str] = {}
    wanted = ("model name", "vendor_id", "cpu family", "model",
              "stepping", "CPU implementer", "CPU part")
    try:
        with open("/proc/cpuinfo") as stream:
            for line in stream:
                if not line.strip():
                    break  # first processor block read; the rest repeat
                key, _, value = line.partition(":")
                key = key.strip()
                # x86 spells it "flags", aarch64 "Features"
                if key in ("flags", "Features"):
                    flags = " ".join(sorted(value.split()))
                elif key in wanted and key not in identity:
                    identity[key] = value.strip()
    except OSError:
        pass
    model = ";".join(f"{k}={v}" for k, v in sorted(identity.items()))
    return platform_mod.machine() + "|" + model + "|" + flags


def semantic_key(fn, specs_tree) -> str:
    """Source-location-independent key for ``fn`` at the given abstract
    inputs: jaxpr structure + closed-over constant bytes + platform."""
    import jax

    closed = jax.make_jaxpr(fn)(specs_tree)
    digest = hashlib.sha256()
    digest.update(jax.__version__.encode())
    backend = jax.default_backend()
    digest.update(backend.encode())
    if backend == "cpu":
        # XLA:CPU AOT artifacts bake the compile machine's feature set
        # (avx512 etc.); loading one on a host with different features
        # logs loudly and can SIGILL — key on a host fingerprint so a
        # moved cache recompiles instead
        digest.update(cpu_fingerprint().encode())
    leaves, treedef = jax.tree.flatten(specs_tree)
    digest.update(str(treedef).encode())
    for leaf in leaves:
        digest.update(f"{leaf.shape}{leaf.dtype}".encode())
    digest.update(str(closed.jaxpr).encode())
    for const in closed.consts:
        host = np.asarray(const)
        digest.update(f"{host.shape}{host.dtype}".encode())
        digest.update(host.tobytes())
    return digest.hexdigest()


def aot_jit(fn, specs_tree, label: str = "step"):
    """``jax.jit(fn)`` for exactly the given abstract inputs, backed by the
    on-disk exported-program store. Falls back to plain jit when the store
    is disabled or the export path fails (e.g. a backend that cannot
    lower-to-StableHLO detached from its runtime)."""
    import jax
    from jax import export

    directory = aot_cache_dir()
    if directory is None:
        return jax.jit(fn)
    if jax.default_backend() == "cpu" and not os.environ.get("PHENIQS_AOT"):
        # XLA:CPU compiles this step in seconds, and loading an XLA:CPU
        # AOT artifact prints a spurious cpu_aot_loader SIGILL warning
        # even for a same-host artifact (it compares the baked LLVM
        # tuning attributes — +prefer-no-gather etc. — against raw
        # cpuinfo flags, which never carry them). Default the store off
        # on CPU; PHENIQS_AOT=dir opts in explicitly.
        _trace("cpu backend: store off by default (PHENIQS_AOT=dir opts in)")
        return jax.jit(fn)
    try:
        started = time.perf_counter()
        key = semantic_key(fn, specs_tree)
        path = os.path.join(directory, f"{label}-{key[:32]}.jaxexport")
        if os.path.exists(path):
            with open(path, "rb") as handle:
                exported = export.deserialize(bytearray(handle.read()))
            _trace(
                f"loaded {os.path.basename(path)}"
                f" in {time.perf_counter() - started:.1f}s"
            )
            return jax.jit(exported.call)
        exported = export.export(jax.jit(fn))(specs_tree)
        os.makedirs(directory, exist_ok=True)
        blob = exported.serialize()
        temp = f"{path}.tmp.{os.getpid()}"
        with open(temp, "wb") as handle:
            handle.write(blob)
        os.replace(temp, path)
        _trace(
            f"exported {os.path.basename(path)} ({len(blob)} B)"
            f" in {time.perf_counter() - started:.1f}s"
        )
        # run the freshly exported artifact (not the source-keyed jit) so
        # its byte-stable StableHLO populates the XLA persistent cache
        return jax.jit(exported.call)
    except Exception as error:
        _trace(f"store unavailable ({error!r}); plain jit")
        return jax.jit(fn)
