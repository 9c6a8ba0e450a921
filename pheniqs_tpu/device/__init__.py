"""The device compute path: jittable decode programs and the sharded decode step.

Everything under this package is functional JAX — static shapes, no Python
control flow on traced values — so the whole decode step compiles to one
XLA program per (batch shape, instrument) and shards over a device mesh
with `shard_map`. The NumPy oracle in ``pheniqs_tpu.decode.oracle`` is the
float64 reference this path is tested against.
"""

from .instrument import DeviceInstrument, compile_instrument  # noqa: F401
from .step import make_decode_step, make_sharded_decode_step  # noqa: F401
