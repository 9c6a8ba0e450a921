"""pheniqs-tpu: an accelerated barcode classification (demultiplexing) engine.

A brand-new implementation in JAX/XLA, run on an NVIDIA GPU, with
the capabilities of Pheniqs (PHilology ENcoder wIth Quality Statistics):
PAMLD (Phred-adjusted maximum likelihood), MDD (minimum distance) and naive
decoding of sample / cellular / molecular barcodes from FASTQ/SAM streams,
SAM auxiliary tag annotation, per-barcode output routing, and JSON statistics
reports with noise/concentration prior estimation.

Architecture (see SURVEY.md for the reference analysis):
  - host ingest packs reads into int8 code/quality tensors (SoA batches)
  - jitted XLA programs evaluate dense (reads x barcodes) likelihood
    matrices on the device, data-parallel over a device mesh
  - per-barcode statistics merge via allreduce collectives
  - an exact float64 NumPy engine ("strict" fidelity) reproduces the
    reference's double-precision Kahan-summed semantics bit for bit and
    doubles as the oracle for kernel tests
"""

import os

from .version import __version__

#: the checkout (or install prefix) holding this package; run-time data
#: (.work) and the compile cache (.jax_cache) live under it
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__all__ = ["CHECKOUT", "__version__"]
