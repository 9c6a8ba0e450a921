"""Jittable classification: tokenization gathers + PAMLD/MDD decode.

Functional equivalents of the reference decoders (reference pamld.cpp:37-123,
mdd.cpp:37-102) in f32 on device. The float64 strict path
(``pheniqs_tpu.decode.oracle``) remains the byte-exact reference; this path
is the high-throughput production kernel, tested against the oracle for
decision agreement.

All shapes are static: N reads, W observation width, B barcodes. The PAMLD
likelihood is one (N, 5W) x (5W, B) matmul (see device.instrument for the
derivation); distances are computed only for the decoded barcode, by a row
gather or a one-hot match contraction (instrument._distance_by_gather),
never as an (N, B, W) tensor.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from ..iupac import BAM_REVERSE_COMPLEMENT
from .instrument import (
    LARGE_PANEL_B,
    LN_PHRED_BASE,
    TPQ_MODE,
    DeviceDecoder,
    DeviceInstrument,
    UNIFORM_BASE_QUALITY,
    _distance_by_gather,
    analytic_tpq,
    match4_from_codes,
    match16_from_codes,
)

# Precision of the sigma contractions. At DEFAULT the GPU may round f32
# operands to TF32 (10 mantissa bits) for the tensor cores, which moves a
# sigma of hundreds of phred by tenths — enough to flip posterior
# decisions. HIGHEST keeps every product and sum in f32, outside TF32, and
# is what the hybrid-mode error bound below assumes; the env knob exists
# for the fast engine and for profiling (tools/profile_step.py). Hybrid
# mode refuses anything below HIGHEST (pamld_classify_device).
MATMUL_PRECISION = {
    "default": jax.lax.Precision.DEFAULT,
    "high": jax.lax.Precision.HIGH,
    "highest": jax.lax.Precision.HIGHEST,
}[os.environ.get("PHENIQS_MATMUL_PRECISION", "highest").lower()]

# branch codes shared with the oracle (decode.oracle)
BRANCH_PASS = 0
BRANCH_LOW_CONFIDENCE = 1
BRANCH_NOISE = 2

#: sigma_q beyond which 10^(-0.1*sigma) underflows even a subnormal float64,
#: i.e. the only way the oracle's prior-adjusted probability can be zero
_F64_UNDERFLOW_SIGMA = 3233.0

# --- hybrid-mode error bound (derived, docs/device_design.md §hybrid-bound) ---
#
# The device computes sigma_b = fl32(<features, matrix[:, b]>) + qpos*U.
# Per observation position at most two feature terms are nonzero (the
# one-hot match channel and the strictness channel), each bounded by
# q_i + max(TPQ_MAX, U) <= q_i + 6.87, so the absolute-term sum obeys
#   S_read <= 2*sum_i(q_i) + 13.74*W .
# A K-term dot product whose products and additions are each one f32
# operation (Precision.HIGHEST: no TF32 operand rounding) satisfies the
# standard bound
#   |fl(sum) - sum| <= gamma_K * S_read,  gamma_K = K*u/(1-K*u), u = 2^-24,
# with K = 2W + 2 nonzero accumulands, for ANY order of the additions:
# sequential, tree, or a split-K GEMM that sums per-slice partials. A
# fused multiply-add only drops a rounding. Hence per read
#   d_sigma(read) = gamma_{2W+2} * (2*sum_q + 13.74*W).            (phred)
# Propagation to the decision quantities (lambda = ln(10^0.1) = 0.23026):
#   conditional  exp(-lambda*(sigma-shift)): rel err <= lambda*2*d_sigma
#   prior (exact f32 constant product): + u
#   posterior sums over B barcodes (+ noise): rel err <= gamma_{B+2}
#   confidence = best/sum: rel err <= 2*lambda*d_sigma*2 + 2*gamma_{B+2}
#     + exp/div rounding (few u).
# The chunked (>LARGE_PANEL_B) path multiplies running sums by one rescale
# per chunk: + gamma_{2*ceil(B/1024)}.
# A read can only flip vs the f64 oracle when a compared pair sits within
# these bounds of each other; _HYBRID_SAFETY covers the residual terms
# (f32 exp within 2 ulp on the shifted conditionals' argument range
# [LN_PHRED_BASE*3233, 0], division 0.5 ulp) and the oracle's own
# (Kahan-small) f64 error. chip_smoke.py phase c measures the exp error on
# the card over every f32 argument of that range, and fails above 2 ulp
# (1.93 ulp at most on an H100 80GB HBM3 at a 400 W limit, PERF.md).
_HYBRID_SAFETY = 4.0
_U32 = float(2.0**-24)
_TERM_BOUND = 13.74  # 2 * max(TPQ(1)=6.8677, UNIFORM=6.0206)


def _gamma(k: float) -> float:
    ku = k * _U32
    return ku / (1.0 - ku)

def _second_max(p: jnp.ndarray, best0: jnp.ndarray) -> jnp.ndarray:
    """Runner-up value per row given its argmax column: mask the winning
    column and re-max — two elementwise/reduce passes instead of
    ``lax.top_k``'s sort. Equals top_k(p, 2)[:, 1] exactly for p >= 0:
    duplicate maxima at other columns survive the index mask."""
    iota = jax.lax.broadcasted_iota(jnp.int32, p.shape, 1)
    return jnp.where(iota == best0[:, None], 0.0, p).max(axis=1)


_REVCOMP = None


def _revcomp_table():
    global _REVCOMP
    if _REVCOMP is None:
        _REVCOMP = jnp.asarray(BAM_REVERSE_COMPLEMENT.astype(jnp.int32))
    return _REVCOMP


def apply_plans(
    dec: DeviceDecoder,
    segments: list[tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]],
) -> list[tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]]:
    """Vectorized Rule::apply on device (reference transform.h:142-169).

    ``segments`` is a list of (code (N, Wi) int32, quality (N, Wi) int32,
    length (N,) int32). Returns one (code, quality, length) triple per
    observation segment, fixed width, positions past the in-read extent
    zeroed (code 0 / quality 0 — the NUL-terminator convention the
    likelihood LUT treats as a no-op contribution).
    """
    outputs: list[list] = [[] for _ in range(len(dec.segment_widths))]
    out_lengths = [[] for _ in range(len(dec.segment_widths))]
    for plan in dec.plans:
        code, quality, length = segments[plan.input_segment_index]
        n, w_in = code.shape
        length = length.astype(jnp.int32)
        # python-slice coordinate resolution (reference transform.h:73-88)
        if plan.start < 0:
            start = jnp.maximum(length + plan.start, 0)
        else:
            start = jnp.where(plan.start > length, 0, plan.start).astype(jnp.int32)
        if not plan.end_terminated:
            end = length
        elif plan.end < 0:
            end = jnp.maximum(length + plan.end, 0)
        else:
            end = jnp.minimum(plan.end, length).astype(jnp.int32)
        size = jnp.maximum(end - start, 0)

        offsets = jnp.arange(plan.width, dtype=jnp.int32)[None, :]
        valid = offsets < size[:, None]
        if w_in == 0:
            piece_code = jnp.zeros((n, plan.width), dtype=jnp.int32)
            piece_qual = jnp.zeros((n, plan.width), dtype=jnp.int32)
        elif not plan.reverse_complement and plan.start >= 0:
            # static-window fast path (the common forward fixed token):
            # the resolved start collapses to {plan.start, 0} — plan.start
            # normally, 0 for reads shorter than the token start — so the
            # gather is TWO static slices + a row select, with no dynamic
            # gather in the program. Positions the
            # original clipped gather read out of range are invalid
            # (j >= size) and zeroed either way, so zero-padding the
            # window is equivalent.
            hi_end = plan.start + plan.width
            if w_in < hi_end:
                pad_cols = ((0, 0), (0, hi_end - w_in))
                code_p = jnp.pad(code, pad_cols)
                qual_p = jnp.pad(quality, pad_cols)
            else:
                code_p, qual_p = code, quality
            piece_code = code_p[:, plan.start : hi_end]
            piece_qual = qual_p[:, plan.start : hi_end]
            if plan.start > 0:
                shorter = (plan.start > length)[:, None]
                piece_code = jnp.where(
                    shorter, code_p[:, : plan.width], piece_code
                )
                piece_qual = jnp.where(
                    shorter, qual_p[:, : plan.width], piece_qual
                )
            piece_code = jnp.where(valid, piece_code, 0)
            piece_qual = jnp.where(valid, piece_qual, 0)
        else:
            if plan.reverse_complement:
                gather = jnp.clip(end[:, None] - 1 - offsets, 0, max(w_in - 1, 0))
            else:
                gather = jnp.clip(start[:, None] + offsets, 0, max(w_in - 1, 0))
            piece_code = jnp.take_along_axis(code, gather, axis=1)
            piece_qual = jnp.take_along_axis(quality, gather, axis=1)
            if plan.reverse_complement:
                piece_code = _revcomp_table()[piece_code]
            piece_code = jnp.where(valid, piece_code, 0)
            piece_qual = jnp.where(valid, piece_qual, 0)
        outputs[plan.output_segment_index].append((piece_code, piece_qual))
        out_lengths[plan.output_segment_index].append(size)

    result = []
    for s, width in enumerate(dec.segment_widths):
        if outputs[s]:
            seg_code = jnp.concatenate([c for c, _ in outputs[s]], axis=1)
            seg_qual = jnp.concatenate([q for _, q in outputs[s]], axis=1)
            seg_len = sum(out_lengths[s])
        else:
            n = segments[0][0].shape[0]
            seg_code = jnp.zeros((n, width), dtype=jnp.int32)
            seg_qual = jnp.zeros((n, width), dtype=jnp.int32)
            seg_len = jnp.zeros(n, dtype=jnp.int32)
        result.append((seg_code, seg_qual, seg_len))
    return result


def observation_features(
    instrument: DeviceInstrument,
    obs_code: jnp.ndarray,
    obs_qual: jnp.ndarray,
) -> jnp.ndarray:
    """Read-side feature tensor F (N, 5W) for the likelihood contraction."""
    n, w = obs_code.shape
    q = obs_qual.astype(jnp.float32)
    if TPQ_MODE == "lut":
        tpq = instrument.tpq[obs_qual]  # (N, W) table gather
    else:
        # elementwise arithmetic instead of a table gather; the
        # exhaustively measured deviation from the f64 table is folded
        # into the hybrid bound (instrument.tpq_analytic_eps)
        tpq = analytic_tpq(obs_qual)
    # a strict observed base with q == 0 is the NUL-terminator convention:
    # the LUT contributes nothing there (reference phred.cpp:39-72 only
    # fills q in [1, 0x80)), so gate strictness on q > 0
    strict_o = (
        ((obs_code == 1) | (obs_code == 2) | (obs_code == 4) | (obs_code == 8))
        & (obs_qual > 0)
    ).astype(jnp.float32)
    onehot4 = jnp.stack(
        [((obs_code == c) & (obs_qual > 0)).astype(jnp.float32) for c in (1, 2, 4, 8)],
        axis=-1,
    )  # (N, W, 4)
    f_match = onehot4 * (tpq - q)[..., None]
    f_strict = (strict_o * (q - UNIFORM_BASE_QUALITY))[..., None]
    features = jnp.concatenate([f_match, f_strict], axis=-1)  # (N, W, 5)
    return features.reshape(n, w * 5)




def _posterior_chunked(
    features: jnp.ndarray,      # (N, FW)
    qpos_uniform: jnp.ndarray,  # (N,) — count(q>0) * UNIFORM
    matrix: jnp.ndarray,        # (FW, B)
    concentration: jnp.ndarray, # (B,)
    adjusted_noise: float,
    chunk: int = 1024,
):
    """Online posterior over barcode chunks (flash-style running
    min/sum/argmax), so panels of any size never materialize (N, B).
    Numerically identical role to the monolithic path: the running shift is
    the global min sigma, rescaling partial sums as better barcodes appear.
    """
    n, fw = features.shape
    b = matrix.shape[1]
    padded_b = -(-b // chunk) * chunk
    if padded_b != b:
        matrix = jnp.pad(matrix, ((0, 0), (0, padded_b - b)))
        # padding columns get zero concentration and +inf-ish sigma via a
        # large additive mask so they can never win
        concentration = jnp.pad(concentration, (0, padded_b - b))
    mask = jnp.arange(padded_b) >= b  # padding columns
    chunks = padded_b // chunk
    matrix_chunks = matrix.reshape(fw, chunks, chunk).transpose(1, 0, 2)
    conc_chunks = concentration.reshape(chunks, chunk)
    mask_chunks = mask.reshape(chunks, chunk)

    big = jnp.float32(3.0e38)
    init = (
        jnp.full((n,), big, dtype=jnp.float32),   # running min sigma (shift)
        jnp.zeros((n,), dtype=jnp.float32),        # running sum
        jnp.zeros((n,), dtype=jnp.float32),        # running best p (shifted)
        jnp.zeros((n,), dtype=jnp.int32),          # running best index
        jnp.full((n,), big, dtype=jnp.float32),    # sigma of best
        jnp.zeros((n,), dtype=jnp.float32),        # running second-best p
    )

    def body(carry, inputs):
        shift, total, best_p, best0, sigma_best, second_p = carry
        chunk_index, g, conc, pad = inputs
        sigma_c = (
            jnp.dot(
                features,
                g,
                precision=MATMUL_PRECISION,
                preferred_element_type=jnp.float32,
            )
            + qpos_uniform[:, None]
        )
        sigma_c = jnp.where(pad[None, :], big, sigma_c)
        new_shift = jnp.minimum(shift, sigma_c.min(axis=1))
        rescale = jnp.exp(LN_PHRED_BASE * (shift - new_shift))
        cond = jnp.exp(LN_PHRED_BASE * (sigma_c - new_shift[:, None]))
        p = cond * conc[None, :]
        total = total * rescale + p.sum(axis=1)
        best_p = best_p * rescale
        second_p = second_p * rescale
        chunk_best = jnp.argmax(p, axis=1).astype(jnp.int32)
        chunk_best_p = jnp.take_along_axis(p, chunk_best[:, None], axis=1)[:, 0]
        chunk_second_p = _second_max(p, chunk_best)
        better = chunk_best_p > best_p
        second_p = jnp.where(
            better,
            jnp.maximum(best_p, chunk_second_p),
            jnp.maximum(second_p, chunk_best_p),
        )
        best_p = jnp.where(better, chunk_best_p, best_p)
        best0 = jnp.where(better, chunk_index * chunk + chunk_best, best0)
        sigma_best = jnp.where(
            better,
            jnp.take_along_axis(sigma_c, chunk_best[:, None], axis=1)[:, 0],
            sigma_best,
        )
        return (new_shift, total, best_p, best0, sigma_best, second_p), None

    (shift, total, best_p, best0, sigma_best, second_p), _ = jax.lax.scan(
        body,
        init,
        (
            jnp.arange(chunks, dtype=jnp.int32),
            matrix_chunks,
            conc_chunks,
            mask_chunks,
        ),
    )

    if adjusted_noise > 0.0:
        log_noise = float(np.log(adjusted_noise))
        noise_shifted = jnp.exp(log_noise - LN_PHRED_BASE * shift)
    else:
        noise_shifted = jnp.zeros(n, dtype=jnp.float32)
    sigma_p = total + noise_shifted
    return best0, best_p, sigma_p, sigma_best, second_p


def _posterior_panel_sharded(
    features: jnp.ndarray,
    qpos_uniform: jnp.ndarray,
    matrix_shard: jnp.ndarray,       # (FW, B/P) this device's columns
    concentration_shard: jnp.ndarray,
    adjusted_noise: float,
    panel_axis: str,
    barcode_count: int,
    shard_base: jnp.ndarray,         # scalar: first global column index
):
    """Collective posterior over a panel-sharded likelihood matrix — must
    run inside a shard_map with `panel_axis` live (the engine's TP mode,
    device/tp.py documents the algebra)."""
    big = jnp.float32(3.0e38)
    big_index = jnp.int32(2**30)
    local_b = matrix_shard.shape[1]
    column = shard_base + jnp.arange(local_b, dtype=jnp.int32)
    pad = column >= barcode_count

    sigma = (
        jnp.dot(
            features,
            matrix_shard,
            precision=MATMUL_PRECISION,
            preferred_element_type=jnp.float32,
        )
        + qpos_uniform[:, None]
    )
    sigma = jnp.where(pad[None, :], big, sigma)
    shift = jax.lax.pmin(sigma.min(axis=1), panel_axis)
    conditional = jnp.exp(LN_PHRED_BASE * (sigma - shift[:, None]))
    prior_adjusted = jnp.where(
        pad[None, :], 0.0, conditional * concentration_shard[None, :]
    )
    total = jax.lax.psum(prior_adjusted.sum(axis=1), panel_axis)

    best_local = jnp.argmax(prior_adjusted, axis=1).astype(jnp.int32)
    best_p_local = jnp.take_along_axis(
        prior_adjusted, best_local[:, None], axis=1
    )[:, 0]
    second_p_local = (
        _second_max(prior_adjusted, best_local)
        if local_b > 1
        else jnp.zeros_like(best_p_local)
    )
    sigma_best_local = jnp.take_along_axis(sigma, best_local[:, None], axis=1)[:, 0]
    global_index = shard_base + best_local

    best_p = jax.lax.pmax(best_p_local, panel_axis)
    candidate = jnp.where(best_p_local >= best_p, global_index, big_index)
    best0 = jax.lax.pmin(candidate, panel_axis)
    holder = global_index == best0
    sigma_best = jax.lax.pmin(
        jnp.where(holder, sigma_best_local, big), panel_axis
    )
    runner = jnp.where(holder, second_p_local, best_p_local)
    second_p = jax.lax.pmax(runner, panel_axis)

    if adjusted_noise > 0.0:
        noise_shifted = jnp.exp(
            float(np.log(adjusted_noise)) - LN_PHRED_BASE * shift
        )
    else:
        noise_shifted = jnp.zeros_like(shift)
    return best0, best_p, total + noise_shifted, sigma_best, second_p


def pamld_classify_device(
    instrument: DeviceInstrument,
    dec: DeviceDecoder,
    obs_code: jnp.ndarray,
    obs_qual: jnp.ndarray,
    qcfail_in: jnp.ndarray,
    want_uncertain: bool = False,
    panel_shard: tuple | None = None,
    panel_axis: str | None = None,
) -> dict:
    """PamlDecoder::classify on device (reference pamld.cpp:37-123).

    With ``want_uncertain`` the result carries a boolean mask of reads whose
    f32 posterior sits within rounding distance of an argmax tie or a filter
    threshold — the hybrid engine re-resolves exactly those in float64."""
    n, w = obs_code.shape
    if want_uncertain and MATMUL_PRECISION != jax.lax.Precision.HIGHEST:
        # the derived re-resolution bound models the exact-f32 HIGHEST
        # contraction; bf16 operand truncation is far outside it
        raise ValueError(
            "hybrid fidelity requires PHENIQS_MATMUL_PRECISION=highest"
        )
    q_positive = (obs_qual > 0).astype(jnp.float32).sum(axis=1)  # (N,)

    features = observation_features(instrument, obs_code, obs_qual)
    adjusted_noise = dec.noise * dec.random_barcode_probability

    second_p = None
    if panel_shard is not None:
        matrix_shard, concentration_shard, shard_base = panel_shard
        best0, best_p, sigma_p, sigma_decoded, second_p = (
            _posterior_panel_sharded(
                features,
                q_positive * UNIFORM_BASE_QUALITY,
                matrix_shard,
                concentration_shard,
                float(adjusted_noise),
                panel_axis,
                dec.barcode_count,
                shard_base,
            )
        )
    elif dec.barcode_count > LARGE_PANEL_B:
        best0, best_p, sigma_p, sigma_decoded, second_p = _posterior_chunked(
            features,
            q_positive * UNIFORM_BASE_QUALITY,
            dec.likelihood_matrix,
            dec.concentration,
            float(adjusted_noise),
        )
    else:
        # full-f32 contraction (MATMUL_PRECISION above): TF32 operand
        # rounding would move sigmas enough to change confidences
        sigma_q = (
            jnp.dot(
                features,
                dec.likelihood_matrix,
                precision=MATMUL_PRECISION,
                preferred_element_type=jnp.float32,
            )
            + q_positive[:, None] * UNIFORM_BASE_QUALITY
        )  # (N, B)

        # log-sum-exp stabilization: shift by the per-read minimum sigma
        # (the max-likelihood barcode) so the decoded conditional is exactly
        # 1.0 and nothing underflows f32 — confidence is shift-invariant.
        shift = sigma_q.min(axis=1, keepdims=True)  # (N, 1)
        conditional = jnp.exp(LN_PHRED_BASE * (sigma_q - shift))  # in (0, 1]
        prior_adjusted = conditional * dec.concentration[None, :]

        # noise term rescaled into the shifted frame:
        # noise*rbp / 10^(-0.1*shift)
        if adjusted_noise > 0.0:
            log_noise = float(np.log(adjusted_noise))
            noise_shifted = jnp.exp(log_noise - LN_PHRED_BASE * shift[:, 0])
        else:
            noise_shifted = jnp.zeros(n, dtype=jnp.float32)

        sigma_p = prior_adjusted.sum(axis=1) + noise_shifted
        best_p = prior_adjusted.max(axis=1)
        # first max wins, matching the strict `p > best` update rule
        best0 = jnp.argmax(prior_adjusted, axis=1).astype(jnp.int32)
        # decoded-column pick as a masked reduce, NOT take_along_axis:
        # one fused select+sum pass over (N, B), and bit-exact (every
        # other lane contributes +0.0, which is exact in IEEE)
        best_mask = (
            jax.lax.broadcasted_iota(jnp.int32, sigma_q.shape, 1)
            == best0[:, None]
        )
        sigma_decoded = jnp.where(best_mask, sigma_q, 0.0).sum(axis=1)
        if want_uncertain:
            second_p = _second_max(prior_adjusted, best0)

    # p > 0 in the float64 oracle fails only when 10^(-0.1*sigma) underflows
    # a double (sigma beyond the subnormal limit)
    decoded_any = sigma_decoded < _F64_UNDERFLOW_SIGMA
    best_index = jnp.where(decoded_any, best0 + 1, 0).astype(jnp.int32)
    confidence = best_p / sigma_p

    # distances only for the decoded barcode. Contraction path: express
    # the per-position match counts as one (N, 16W) x (16W, B) contraction
    # and pick the decoded column. It asks for no precision, so the GPU
    # may run it in TF32, and it stays exact there: the 0/1 operands are
    # exact in TF32's 10-bit mantissa, so is every product, and the sums
    # are f32 integer counts far below 2^24. Gather path
    # (instrument._distance_by_gather, the default): gather the decoded
    # panel row and compare. Chunked/sharded panels always gather: (N, B)
    # never materializes there.
    need_hq = dec.high_quality_distance_threshold > 0
    if (
        panel_shard is None
        and dec.barcode_count <= LARGE_PANEL_B
        and not _distance_by_gather()
    ):
        # strict panels (the overwhelmingly common case) contract a
        # 4-class observed one-hot against panel_match4 — code equality
        # with a strict expected base implies a strict observed base, so
        # the counts are identical to the 16-class contraction at a
        # quarter of the one-hot's memory traffic
        match4 = dec.panel_match4
        match16 = dec.panel_match16
        if match4 is None and match16 is None:
            # forced to the contraction path after an instrument compile
            # that skipped the matrices (gather default): rebuild here
            host_codes = np.asarray(dec.panel_codes)
            match4 = match4_from_codes(host_codes)
            if match4 is None:
                match16 = match16_from_codes(host_codes)
        if match4 is not None:
            onehot_o = jnp.stack(
                [(obs_code == c).astype(jnp.float32) for c in (1, 2, 4, 8)],
                axis=-1,
            )  # ungated: distance counts q==0 positions too
            match = jnp.dot(
                onehot_o.reshape(n, w * 4),
                match4,
                preferred_element_type=jnp.float32,
            )  # (N, B) per-position match counts
        else:
            onehot_o = jax.nn.one_hot(obs_code, 16, dtype=jnp.float32)
            match = jnp.dot(
                onehot_o.reshape(n, w * 16),
                match16,
                preferred_element_type=jnp.float32,
            )
        pick_mask = (
            jax.lax.broadcasted_iota(jnp.int32, match.shape, 1)
            == best0[:, None]
        )
        match_best = jnp.where(pick_mask, match, 0.0).sum(axis=1)
        raw_distance = (jnp.float32(w) - match_best).astype(jnp.int32)
        if need_hq:
            hq_mask = (obs_qual >= dec.high_quality_threshold).astype(
                jnp.float32
            )
            hq_cols = 4 if match4 is not None else 16
            hq_match = jnp.dot(
                (onehot_o * hq_mask[..., None]).reshape(n, w * hq_cols),
                match4 if match4 is not None else match16,
                preferred_element_type=jnp.float32,
            )
            hq_best = jnp.where(pick_mask, hq_match, 0.0).sum(axis=1)
            raw_hq = (hq_mask.sum(axis=1) - hq_best).astype(jnp.int32)
    else:
        expected = dec.panel_codes[best0]  # (N, W)
        mismatch = expected != obs_code
        raw_distance = mismatch.sum(axis=1, dtype=jnp.int32)
        if need_hq:
            raw_hq = (
                mismatch & (obs_qual >= dec.high_quality_threshold)
            ).sum(axis=1, dtype=jnp.int32)
    distance = jnp.where(decoded_any, raw_distance, 0)
    hq_distance = (
        jnp.where(decoded_any, raw_hq, 0) if need_hq else None
    )

    # noise filter in log space: 10^(-0.1*sigma) > rbp  <=>  sigma < ln(rbp)/ln(10^-0.1)
    if dec.random_barcode_probability > 0.0:
        noise_sigma_threshold = float(
            np.log(dec.random_barcode_probability) / LN_PHRED_BASE
        )
        passed_noise = decoded_any & (sigma_decoded < noise_sigma_threshold)
    else:
        passed_noise = decoded_any
    passed_confidence = confidence > dec.confidence_threshold

    branch = jnp.where(
        passed_noise,
        jnp.where(passed_confidence, BRANCH_PASS, BRANCH_LOW_CONFIDENCE),
        BRANCH_NOISE,
    ).astype(jnp.int8)

    decoded = jnp.where(passed_noise, best_index, 0)
    out_confidence = jnp.where(passed_noise, confidence, 0.0)
    out_distance = jnp.where(passed_noise, distance, 0)

    qcfail = qcfail_in | ~passed_noise | (passed_noise & ~passed_confidence)
    if dec.high_quality_distance_threshold > 0:
        hq_fail = (
            passed_noise
            & passed_confidence
            & (hq_distance >= dec.high_quality_distance_threshold)
        )
        qcfail = qcfail | hq_fail

    result = {
        "decoded": decoded,
        "confidence": out_confidence,
        "distance": out_distance,
        "qcfail": qcfail,
        "branch": branch,
        "argmax": best_index,
    }
    if want_uncertain:
        # derived per-read margins (see the _HYBRID_SAFETY block above):
        # an f32 decision can only differ from the f64 oracle when the
        # compared quantities sit within these bounds of each other
        q_sum = obs_qual.sum(axis=1).astype(jnp.float32)
        # + W * eps: the exhaustively measured analytic-TPQ deviation per
        # position (0.0 in lut mode) — see instrument.analytic_tpq_epsilon
        d_sigma = (
            _gamma(2 * w + 2) * (2.0 * q_sum + _TERM_BOUND * w)
            + instrument.tpq_analytic_eps * w
        )
        lam = float(abs(LN_PHRED_BASE))
        chunks = -(-dec.barcode_count // 1024) if (
            dec.barcode_count > LARGE_PANEL_B
        ) else 0
        rel_eps = _HYBRID_SAFETY * (
            4.0 * lam * d_sigma
            + 2.0 * _gamma(dec.barcode_count + 2)
            + 2.0 * _gamma(2 * chunks)
            + 8.0 * _U32
        )
        sigma_eps = _HYBRID_SAFETY * d_sigma + 1e-4
        uncertain = jnp.zeros(n, dtype=bool)
        if second_p is not None:
            uncertain = uncertain | (second_p > best_p * (1.0 - rel_eps))
        if dec.confidence_threshold > 0.0:
            uncertain = uncertain | (
                jnp.abs(confidence - dec.confidence_threshold)
                < rel_eps * jnp.maximum(confidence, dec.confidence_threshold)
                + 4.0 * _U32
            )
        if dec.random_barcode_probability > 0.0:
            uncertain = uncertain | (
                jnp.abs(sigma_decoded - noise_sigma_threshold) < sigma_eps
            )
        uncertain = uncertain | (
            jnp.abs(sigma_decoded - _F64_UNDERFLOW_SIGMA) < 1.0
        )
        result["uncertain"] = uncertain
    return result


def mdd_classify_device(
    dec: DeviceDecoder,
    observation: list[tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]],
    qcfail_in: jnp.ndarray,
) -> dict:
    """MdDecoder::classify on device (reference mdd.cpp:37-102): exact match
    first, else the FIRST barcode in codec order within per-segment
    tolerance — not the closest."""
    n = observation[0][0].shape[0]
    b = dec.barcode_count
    tolerance = dec.distance_tolerance or tuple(0 for _ in dec.segment_widths)

    offset = 0
    within = jnp.ones((n, b), dtype=bool)
    exact = jnp.ones((n, b), dtype=bool)
    total_error = jnp.zeros((n, b), dtype=jnp.int32)
    for s, (code, quality, length) in enumerate(observation):
        ws = dec.segment_widths[s]
        codes = dec.panel_codes[:, offset : offset + ws]  # (B, Ws)
        offset += ws
        in_range = (
            jnp.arange(ws, dtype=jnp.int32)[None, :] < length[:, None]
        )  # (N, Ws)
        onehot_o = jax.nn.one_hot(code, 16, dtype=jnp.float32)  # (N, Ws, 16)
        onehot_e = jax.nn.one_hot(codes, 16, dtype=jnp.float32)  # (B, Ws, 16)
        # match count within range, as one contraction
        masked_o = onehot_o * in_range[..., None]
        match = jnp.einsum(
            "nwc,bwc->nb",
            masked_o,
            onehot_e,
            precision=MATMUL_PRECISION,
            preferred_element_type=jnp.float32,
        )
        obs_len = length.astype(jnp.float32)[:, None]
        mismatches = (obs_len - match).astype(jnp.int32)
        if dec.quality_masking_threshold > 0:
            unmasked_o = masked_o * (
                quality >= dec.quality_masking_threshold
            ).astype(jnp.float32)[..., None]
            ok = jnp.einsum(
                "nwc,bwc->nb",
                unmasked_o,
                onehot_e,
                precision=MATMUL_PRECISION,
                preferred_element_type=jnp.float32,
            )
            errors = (obs_len - ok).astype(jnp.int32)
        else:
            errors = mismatches
        within = within & (errors <= tolerance[s])
        total_error = total_error + errors
        exact = exact & (length[:, None] == ws) & (mismatches == 0)

    exact_any = exact.any(axis=1)
    exact_first = jnp.argmax(exact, axis=1).astype(jnp.int32)
    scan_any = within.any(axis=1)
    scan_first = jnp.argmax(within, axis=1).astype(jnp.int32)

    decoded = jnp.where(
        exact_any,
        exact_first + 1,
        jnp.where(scan_any, scan_first + 1, 0),
    ).astype(jnp.int32)
    distance = jnp.where(
        ~exact_any & scan_any,
        jnp.take_along_axis(total_error, scan_first[:, None], axis=1)[:, 0],
        0,
    ).astype(jnp.int32)

    qcfail = qcfail_in | (decoded == 0)
    return {
        "decoded": decoded,
        "confidence": jnp.zeros(n, dtype=jnp.float32),
        "distance": distance,
        "qcfail": qcfail,
        "branch": jnp.full(n, BRANCH_PASS, dtype=jnp.int8),
        "argmax": decoded,
    }
