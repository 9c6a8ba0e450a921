"""Compile a decoded instruction into device-ready constants.

A ``DeviceInstrument`` is the static, jit-friendly form of one compiled
instruction: per-decoder token plans (fixed-width gathers), barcode panel
matrices laid out for matrix products, and scalar thresholds. It is built once
per job from the same ``DecoderSpec`` objects the strict engine uses, so
the two paths classify from identical compiled state.

The PAMLD likelihood is reformulated as a single skinny matmul. For one
read position w with observed code o, quality q, and expected code e, the
reference substitution quality (reference phred.cpp:39-72, barcode.h:131-164)
is::

    f(q,e,o) = 0                       if q == 0
             = UNIFORM                 if e or o is ambiguous
             = tpq[q]                  if e == o   (both strict A/C/G/T)
             = q                       otherwise

which decomposes into read-side features F and panel-side features G with
``sigma_q[r,b] = F[r] . G[b] + UNIFORM * count(q_r > 0)``:

    F[r, w, 0:4] = onehot4(o) * (tpq[q] - q)      G[b, w, 0:4] = onehot4(e)
    F[r, w, 4]   = strict(o) * (q - UNIFORM)      G[b, w, 4]   = strict(e)

i.e. one (N, 5W) x (5W, B) matrix product.
Per-read Hamming/high-quality distances are then computed only against the
*decoded* barcode with a row gather + elementwise compare, avoiding the
(N, B, W) mismatch tensor entirely.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..decode.spec import DecoderSpec, spec_from_ontology
from ..errors import ConfigurationError
from ..phred import SUBSTITUTION_LUT, TRUE_POSITIVE_QUALITY, UNIFORM_BASE_QUALITY

#: BAM 4-bit codes of the concrete nucleotides A/C/G/T (reference iupac.h:27-50)
STRICT_CODES = (1, 2, 4, 8)

#: natural-log factor: 10^(-0.1 * sigma) == exp(LN_PHRED_BASE * sigma)
LN_PHRED_BASE = float(-0.1 * np.log(10.0))

#: panels larger than this stream through the chunked online posterior
#: instead of materializing the (N, B) matrix (classify._posterior_chunked)
LARGE_PANEL_B = 1024

#: analytic (default) computes the true-positive quality elementwise
#: (analytic_tpq); `lut` gathers it from the (128,) f32 table instead
TPQ_MODE = os.environ.get("PHENIQS_TPQ", "analytic")


def analytic_tpq(q: jnp.ndarray) -> jnp.ndarray:
    """f32 true-positive quality -10*log10(1 - 10^(-q/10)) computed
    elementwise WITHOUT transcendentals, so its accuracy does not depend on
    the backend's log1p (whose error would widen the hybrid re-resolution
    bound):

      * 10^(-q/10) for integer q as a product over q's bits of exact f32
        constants 10^(-2^k/10) (<= 3 ulp, measured 2.1e-7)
      * -log1p(-x) for q >= 8 (x <= 0.159) as an 8-term Horner series
        (truncation < 4e-8 relative)
      * q in 1..7, where the series converges slowly: exact per-q f32
        constants selected by a compare chain

    q == 0 inputs are clamped to 1; callers gate those positions to zero
    contribution, the NUL-terminator convention (reference
    phred.cpp:39-72). The residual deviation from the f64 table is still
    measured exhaustively per process (analytic_tpq_epsilon) and folded
    into the hybrid bound."""
    q = jnp.maximum(q, 1)
    x = jnp.ones(q.shape, jnp.float32)
    for k in range(7):  # q < 0x80
        factor = jnp.float32(10.0 ** (-(1 << k) / 10.0))
        x = x * jnp.where(((q >> k) & 1) == 1, factor, jnp.float32(1.0))
    series = jnp.float32(1.0 / 8.0)
    for n in range(7, 0, -1):
        series = jnp.float32(1.0 / n) + x * series
    tpq = jnp.float32(10.0 / np.log(10.0)) * (x * series)
    from ..phred import TRUE_POSITIVE_QUALITY as _TPQ64

    for qq in range(1, 8):
        tpq = jnp.where(
            q == qq, jnp.float32(np.float32(_TPQ64[qq])), tpq
        )
    return tpq


_ANALYTIC_TPQ_EPS: float | None = None


def analytic_tpq_epsilon() -> float:
    """Exhaustively measured |analytic_f32(q) - tpq_f64(q)| over the ENTIRE
    quality domain (q in 1..127 — q=0 positions contribute nothing), doubled
    for safety, evaluated once per process on the default backend. This is
    verification, not sampling: every input the kernel can ever see is
    covered, so folding `W * eps` into the hybrid re-resolution bound keeps
    the strict-identity guarantee intact with analytic TPQ."""
    global _ANALYTIC_TPQ_EPS
    if _ANALYTIC_TPQ_EPS is None:
        from ..phred import TRUE_POSITIVE_QUALITY

        q = jnp.arange(1, _TPQ_DOMAIN, dtype=jnp.int32)
        measured = np.asarray(
            jax.jit(analytic_tpq)(q), dtype=np.float64
        )
        exact = TRUE_POSITIVE_QUALITY[1:_TPQ_DOMAIN]
        _ANALYTIC_TPQ_EPS = 2.0 * float(
            np.max(np.abs(measured - exact))
        ) + 1e-7
    return _ANALYTIC_TPQ_EPS


_TPQ_DOMAIN = 0x80  # 7-bit phred (reference phred.cpp:39-72)


@dataclass(frozen=True)
class TokenPlan:
    """One fixed-width token gather (reference transform.h:34-88).

    Decoder tokens are required to be fixed width (reference
    transcode.cpp:836-841), so ``width`` is static and the gather compiles
    to a static-shape ``take_along_axis``.
    """

    input_segment_index: int
    start: int
    end: int
    end_terminated: bool
    reverse_complement: bool
    output_segment_index: int
    width: int


@dataclass
class DeviceDecoder:
    """Static decoder config + device constant arrays."""

    algorithm: str  # pamld | mdd | naive | passthrough
    classifier_type: str  # sample | cellular | molecular
    index: int
    multiplexing: bool
    plans: list[TokenPlan]
    segment_widths: list[int]  # observation segment widths (concat order)
    # panel constants (None for naive/passthrough)
    barcode_count: int = 0
    width: int = 0
    panel_codes: jnp.ndarray | None = None  # (B, W) int32
    panel_strict: jnp.ndarray | None = None  # (B, W) f32 strict(e)
    likelihood_matrix: jnp.ndarray | None = None  # (5W, B) f32 — G above
    #: (16W, B) one-hot of panel codes: match counts (and hence Hamming
    #: distances to the decoded barcode) become one matrix product
    #: instead of a per-read row gather — exact at any matmul precision,
    #: TF32 included (see classify.pamld_classify_device).
    #: Built only for ambiguity-coded panels; strict panels carry the
    #: 4x-smaller panel_match4 instead.
    panel_match16: jnp.ndarray | None = None
    #: (4W, B) strict-panel match matrix (match4_from_codes)
    panel_match4: jnp.ndarray | None = None
    concentration: jnp.ndarray | None = None  # (B,) f32
    # scalars
    noise: float = 0.0
    confidence_threshold: float = 0.0
    random_barcode_probability: float = 0.0
    high_quality_threshold: int = 30
    high_quality_distance_threshold: int = 0
    quality_masking_threshold: int = 0
    distance_tolerance: tuple[int, ...] = ()
    # spec back-reference for the host side (tags, reports)
    spec: DecoderSpec | None = None


@dataclass
class DeviceInstrument:
    """All decoders of one instruction in classify order, plus routing.

    ``used_segments`` lists the input segments any decoder token touches;
    only those are shipped to the device (the biological payload segments
    never leave the host — template assembly is host-side memcpy,
    reference transform.h:190-226). Token plans are re-indexed into this
    pruned segment list at compile time.
    """

    decoders: list[DeviceDecoder]
    multiplexing_index: int  # position in `decoders`, or -1
    input_segment_cardinality: int
    substitution_lut: jnp.ndarray  # (128, 16, 16) f32, shared
    tpq: jnp.ndarray  # (128,) f32 true-positive quality table
    used_segments: tuple[int, ...] = ()
    #: measured per-position bound on the analytic-TPQ deviation from the
    #: f64 table (0.0 in `lut` mode); the hybrid bound adds `W * eps`
    tpq_analytic_eps: float = 0.0

    @property
    def sample(self) -> DeviceDecoder | None:
        for dec in self.decoders:
            if dec.classifier_type == "sample":
                return dec
        return None


def _plans_from_rule(spec: DecoderSpec) -> tuple[list[TokenPlan], list[int]]:
    plans: list[TokenPlan] = []
    widths = [0] * spec.rule.output_segment_cardinality
    for tx in spec.rule.transform_array:
        token = tx.token
        length = token.length()
        if length < 0:
            raise ConfigurationError(
                "device decoders require fixed-width tokens "
                f"(token {token} has dynamic width)"
            )
        plans.append(
            TokenPlan(
                input_segment_index=token.input_segment_index,
                start=token.start,
                end=token.end,
                end_terminated=token.end_terminated,
                reverse_complement=tx.reverse_complement,
                output_segment_index=tx.output_segment_index,
                width=length,
            )
        )
        widths[tx.output_segment_index] += length
    return plans, widths


def _distance_by_gather() -> bool:
    """Pick the decoded-barcode distance algorithm: gather the decoded
    panel row and compare (True), or contract a one-hot of the observation
    against the panel's match matrix and pick the decoded column (False).

    The gather is the default: it wins on both backends the program runs
    on. On the GPU
    (H100 80GB HBM3 at a 400 W power limit, PERF.md) the flagship step
    round trip (bench.py step mode, 131072-read batch, runs alternated)
    ran 70.2M and 67.8M reads/s with the gather against 64.8M and 56.2M
    with the contraction, and the full step took 1.60 vs 1.81 ms
    pipelined (tools/profile_step.py); on the CPU the
    contraction is the single most expensive op of the step (149 ms vs
    0.6 ms for the gather at N=131k, B=384). Both are integer-exact, so
    decisions are identical either way (pinned by the CPU-vs-oracle
    suites and chip_smoke.py). PHENIQS_DISTANCE_PATH=gather|contraction
    overrides, so both paths stay testable on either backend."""
    forced = os.environ.get("PHENIQS_DISTANCE_PATH")
    if forced:
        if forced not in ("gather", "contraction"):
            raise ConfigurationError(
                f"PHENIQS_DISTANCE_PATH={forced!r}: expected"
                " gather or contraction"
            )
        return forced == "gather"
    return True


def match16_from_codes(codes: np.ndarray) -> jnp.ndarray:
    """(B, W) BAM codes -> the (16W, B) one-hot match-contraction matrix
    (per-position match counts = onehot(obs) @ this)."""
    b, w = codes.shape
    onehot16 = np.zeros((b, w, 16), dtype=np.float32)
    np.put_along_axis(
        onehot16, codes[:, :, None].astype(np.int64), 1.0, axis=2
    )
    return jnp.asarray(np.ascontiguousarray(onehot16.reshape(b, w * 16).T))


def match4_from_codes(codes: np.ndarray) -> jnp.ndarray | None:
    """(B, W) STRICT BAM codes -> the (4W, B) match-contraction matrix, or
    None when the panel carries ambiguity codes. Match counts against a
    strict panel only need the 4-class observed one-hot (code equality
    with a strict expected base implies the observed base is strict), so
    the read-side one-hot tensor shrinks 4x vs match16 — the distance
    contraction's cost is the one-hot's memory traffic, not its FLOPs."""
    if not np.isin(codes, STRICT_CODES).all():
        return None
    b, w = codes.shape
    onehot4 = np.zeros((b, w, 4), dtype=np.float32)
    for c, code in enumerate(STRICT_CODES):
        onehot4[:, :, c] = (codes == code).astype(np.float32)
    return jnp.asarray(np.ascontiguousarray(onehot4.reshape(b, w * 4).T))


def _panel_matrices(spec: DecoderSpec):
    """Build the (5W, B) likelihood contraction matrix G and companions."""
    codes = spec.panel.codes.astype(np.int64)  # (B, W)
    b, w = codes.shape
    strict = np.isin(codes, STRICT_CODES).astype(np.float32)  # (B, W)
    onehot4 = np.zeros((b, w, 4), dtype=np.float32)
    for c, code in enumerate(STRICT_CODES):
        onehot4[:, :, c] = (codes == code).astype(np.float32)
    g = np.concatenate([onehot4, strict[:, :, None]], axis=2)  # (B, W, 5)
    g = g.reshape(b, w * 5).T  # (5W, B) — contraction layout
    match16 = None
    match4 = None
    if b <= LARGE_PANEL_B and not _distance_by_gather():
        # only the monolithic posterior on the contraction path consumes
        # the match matrices; the gather path and chunked/sharded panels
        # keep the row gather (a (16W, B) matrix for a 1M-barcode
        # whitelist would cost ~1 GB of device memory; classify rebuilds it
        # lazily if the path is forced to contraction after compile).
        # Strict panels take the 4-wide matrix; only ambiguity-coded
        # panels need the full 16-class equality.
        match4 = match4_from_codes(codes)
        if match4 is None:
            match16 = match16_from_codes(codes)
    return (
        jnp.asarray(codes.astype(np.int32)),
        jnp.asarray(strict),
        jnp.asarray(np.ascontiguousarray(g)),
        jnp.asarray(spec.panel.concentration.astype(np.float32)),
        match16,
        match4,
    )


def compile_decoder(spec: DecoderSpec) -> DeviceDecoder:
    plans: list[TokenPlan] = []
    widths: list[int] = []
    if spec.rule is not None and spec.algorithm != "passthrough":
        plans, widths = _plans_from_rule(spec)
    dec = DeviceDecoder(
        algorithm=spec.algorithm,
        classifier_type=spec.classifier_type,
        index=spec.index,
        multiplexing=spec.multiplexing,
        plans=plans,
        segment_widths=widths,
        noise=spec.noise,
        confidence_threshold=spec.confidence_threshold,
        random_barcode_probability=spec.random_barcode_probability,
        high_quality_threshold=spec.high_quality_threshold,
        high_quality_distance_threshold=spec.high_quality_distance_threshold,
        quality_masking_threshold=spec.quality_masking_threshold,
        distance_tolerance=tuple(spec.distance_tolerance),
        spec=spec,
    )
    if spec.panel is not None and spec.algorithm in ("pamld", "mdd"):
        dec.barcode_count = spec.panel.cardinality
        dec.width = spec.panel.width
        (
            dec.panel_codes,
            dec.panel_strict,
            dec.likelihood_matrix,
            dec.concentration,
            dec.panel_match16,
            dec.panel_match4,
        ) = _panel_matrices(spec)
    return dec


def compile_instrument(ontology: dict) -> DeviceInstrument:
    """Build a DeviceInstrument from a compiled instruction ontology, in the
    reference classify order: sample, molecular*, cellular* (reference
    transcode.h:51-65)."""
    from ..config.compiler import topic_elements

    decoders: list[DeviceDecoder] = []
    sample = ontology.get("sample")
    if isinstance(sample, dict):
        decoders.append(compile_decoder(spec_from_ontology(sample, "sample")))
    for element in topic_elements(ontology.get("molecular")):
        decoders.append(compile_decoder(spec_from_ontology(element, "molecular")))
    for element in topic_elements(ontology.get("cellular")):
        decoders.append(compile_decoder(spec_from_ontology(element, "cellular")))

    multiplexing_index = -1
    for i, dec in enumerate(decoders):
        if dec.multiplexing:
            multiplexing_index = i
            break
    if multiplexing_index < 0:
        for i, dec in enumerate(decoders):
            if dec.classifier_type == "sample":
                multiplexing_index = i
                break

    used = sorted(
        {plan.input_segment_index for dec in decoders for plan in dec.plans}
    )
    remap = {segment: position for position, segment in enumerate(used)}
    for dec in decoders:
        dec.plans = [
            TokenPlan(
                input_segment_index=remap[plan.input_segment_index],
                start=plan.start,
                end=plan.end,
                end_terminated=plan.end_terminated,
                reverse_complement=plan.reverse_complement,
                output_segment_index=plan.output_segment_index,
                width=plan.width,
            )
            for plan in dec.plans
        ]

    return DeviceInstrument(
        decoders=decoders,
        multiplexing_index=multiplexing_index,
        input_segment_cardinality=int(
            ontology.get("input segment cardinality", 1)
        ),
        substitution_lut=jnp.asarray(SUBSTITUTION_LUT.astype(np.float32)),
        tpq=jnp.asarray(TRUE_POSITIVE_QUALITY.astype(np.float32)),
        used_segments=tuple(used),
        tpq_analytic_eps=(
            analytic_tpq_epsilon() if TPQ_MODE == "analytic" else 0.0
        ),
    )


__all__ = [
    "DeviceDecoder",
    "DeviceInstrument",
    "TokenPlan",
    "compile_decoder",
    "compile_instrument",
    "LN_PHRED_BASE",
    "STRICT_CODES",
    "UNIFORM_BASE_QUALITY",
    "SUBSTITUTION_LUT",
]
