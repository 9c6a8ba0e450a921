"""The strict (exact float64) execution engine.

Runs a compiled instruction end to end on host: streams read batches from
the input feeds, classifies them with the NumPy oracle decoders, assembles
output reads through the template rule, routes them to per-barcode output
channels, and accumulates the statistics that feed the JSON report. Every
numeric decision replicates the reference bit for bit; this engine is both
the `--fidelity strict` path and the correctness oracle for the device path.

Structure mirrors the reference hot loop (reference transcode.h:202-225):
  pull -> validate -> filters -> classify (sample, molecular*, cellular*)
  -> template -> flush -> multiplex push
but vectorized over batches instead of per read.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..config.url import URL
from ..decode.oracle import (
    BRANCH_LOW_CONFIDENCE,
    BRANCH_NOISE,
    BRANCH_PASS,
    ClassifyResult,
    ObservationScratch,
    mdd_classify,
    pamld_classify,
)
from ..decode.spec import spec_from_ontology
from ..errors import ConfigurationError
from ..io.fastq import read_fastq
from ..io.sam import (
    FLAG_MUNMAP,
    FLAG_PAIRED,
    FLAG_QCFAIL,
    FLAG_READ1,
    FLAG_READ2,
    FLAG_UNMAP,
    AuxTags,
    SamHeader,
)
from ..iupac import BAM_TO_ASCII
from ..model.batch import ReadBatch
from ..report.accumulate import DecoderAccumulator
from ..transform import Rule, SegmentBatch


from .feeds import Channel, OutputFeed  # noqa: F401 - engine API

# ---------------------------------------------------------------------------
# decoder runtime wrapper
# ---------------------------------------------------------------------------

class ClassifierRuntime:
    """One classifier: spec + scratch + accumulator + per-batch classify."""

    def __init__(self, ontology: dict, classifier_type: str):
        self.spec = spec_from_ontology(ontology, classifier_type)
        self.accumulator = DecoderAccumulator(
            self.spec.index,
            self.spec.panel.cardinality if self.spec.panel else 0,
        )
        self.scratch: ObservationScratch | None = None
        if self.spec.rule is not None and self.spec.panel is not None:
            widths = [0] * self.spec.rule.output_segment_cardinality
            for tx in self.spec.rule.transform_array:
                widths[tx.output_segment_index] += max(tx.token.length(), 0)
            self.scratch = ObservationScratch(widths)

    def classify(self, batch: ReadBatch, qcfail: np.ndarray) -> ClassifyResult:
        spec = self.spec
        n = batch.size
        if spec.algorithm == "passthrough" or spec.rule is None:
            result = ClassifyResult(
                decoded=np.zeros(n, dtype=np.int32),
                confidence=np.zeros(n, dtype=np.float64),
                edit_distance=np.zeros(n, dtype=np.int32),
                qcfail=qcfail,
                branch=np.full(n, BRANCH_PASS, dtype=np.int8),
                argmax=np.zeros(n, dtype=np.int32),
            )
            self.accumulator.update_counts(result.decoded, result.qcfail)
            return result

        observation = spec.rule.apply(batch.segments)
        if spec.algorithm == "naive":
            result = ClassifyResult(
                decoded=np.zeros(n, dtype=np.int32),
                confidence=np.zeros(n, dtype=np.float64),
                edit_distance=np.zeros(n, dtype=np.int32),
                qcfail=qcfail,
                branch=np.full(n, BRANCH_PASS, dtype=np.int8),
                argmax=np.zeros(n, dtype=np.int32),
                observation=observation,
            )
            self.accumulator.update_counts(result.decoded, result.qcfail)
            return result

        if spec.panel is None:
            raise ConfigurationError(
                f"{spec.algorithm} decoder requires a codec"
            )

        if spec.algorithm == "pamld":
            # effective (scratch-carrying) observation per segment,
            # concatenated across segments for the likelihood kernel
            eff_codes = []
            eff_quals = []
            for segment_index, segment in enumerate(observation):
                code, qual = self.scratch.effective(segment_index, segment)
                eff_codes.append(code)
                eff_quals.append(qual)
            obs_code = np.concatenate(eff_codes, axis=1)
            obs_qual = np.concatenate(eff_quals, axis=1)
            result = pamld_classify(spec, obs_code, obs_qual, qcfail)
            result.observation = observation
            self.record(result)
            return result

        if spec.algorithm == "mdd":
            result = mdd_classify(spec, observation, qcfail)
            self.record(result)
            return result

        raise ConfigurationError(f"unknown algorithm {spec.algorithm}")

    def record(self, result: ClassifyResult):
        """Accumulator updates for one classified batch (reference
        selector.cpp:25-101) — shared by the strict and device engines."""
        acc = self.accumulator
        if self.spec.algorithm == "pamld":
            passed = result.branch == BRANCH_PASS
            acc.update_confidence(
                result.decoded, result.confidence, passed, result.qcfail
            )
            acc.update_filters(
                result.argmax,
                result.branch == BRANCH_LOW_CONFIDENCE,
                result.branch == BRANCH_NOISE,
            )
            acc.update_distance(result.decoded, result.edit_distance, result.qcfail)
            acc.update_counts(result.decoded, result.qcfail)
        elif self.spec.algorithm == "mdd":
            acc.update_distance(result.decoded, result.edit_distance, result.qcfail)
            acc.update_counts(result.decoded, result.qcfail)
        else:
            acc.update_counts(result.decoded, result.qcfail)


# ---------------------------------------------------------------------------
# per-batch tag material
# ---------------------------------------------------------------------------

class BarcodeTagData:
    """Raw and corrected barcode strings for one classifier over a batch."""

    __slots__ = ("raw_seq", "raw_qual", "corrected_seq", "corrected_qual")

    def __init__(self, n: int):
        self.raw_seq = [""] * n
        self.raw_qual = [""] * n
        self.corrected_seq = [""] * n
        self.corrected_qual = [""] * n


def build_tag_data(
    result: ClassifyResult,
    spec,
    phred_offset: int = 33,
    corrected: bool = True,
) -> BarcodeTagData:
    """Vectorized equivalent of append_to_raw/corrected_*_barcode
    (reference read.h:269-348, sequence.h:382-398).

    ASCII conversion happens once per batch (one big decode per segment);
    per-read values are string slices, so the per-read cost is O(1) slices
    and a join."""
    observation = result.observation
    n = observation[0].length.shape[0] if observation else 0
    data = BarcodeTagData(n)

    seg_views = []  # per segment: (seq_str, qual_str, width, lengths, uniform)
    cor_views = []
    for segment_index, segment in enumerate(observation):
        width = segment.width
        seq_str = BAM_TO_ASCII[segment.code].tobytes().decode("latin-1")
        qual_str = (
            (segment.quality.astype(np.uint8) + phred_offset)
            .tobytes()
            .decode("latin-1")
        )
        lengths = segment.length
        uniform = bool((lengths == width).all())
        seg_views.append((seq_str, qual_str, width, lengths, uniform))
        if corrected and spec.panel is not None:
            sl = spec.panel.segment_slices()[segment_index]
            barcode_codes = np.vstack(
                [
                    np.zeros(sl.stop - sl.start, dtype=np.uint8),
                    spec.panel.codes[:, sl],
                ]
            )
            chosen = barcode_codes[result.decoded]  # (N, Ws)
            ws = min(width, chosen.shape[1])
            cor_code = chosen[:, :ws]
            keep_original = (segment.code[:, :ws] == cor_code) | (cor_code == 0)
            cor_qual = np.where(
                keep_original,
                segment.quality[:, :ws],
                np.uint8(spec.corrected_quality),
            )
            cor_seq_str = BAM_TO_ASCII[cor_code].tobytes().decode("latin-1")
            cor_qual_str = (
                (cor_qual.astype(np.uint8) + phred_offset)
                .tobytes()
                .decode("latin-1")
            )
            cor_views.append((cor_seq_str, cor_qual_str, ws, lengths))

    single = len(observation) == 1
    for i in range(n):
        if single:
            seq_str, qual_str, width, lengths, uniform = seg_views[0]
            length = width if uniform else int(lengths[i])
            base = i * width
            data.raw_seq[i] = seq_str[base : base + length]
            data.raw_qual[i] = qual_str[base : base + length]
        else:
            seq_parts = []
            qual_parts = []
            for seq_str, qual_str, width, lengths, uniform in seg_views:
                length = width if uniform else int(lengths[i])
                base = i * width
                seq_parts.append(seq_str[base : base + length])
                qual_parts.append(qual_str[base : base + length])
            data.raw_seq[i] = "".join(seq_parts)
            data.raw_qual[i] = "".join(qual_parts)

    if corrected and spec.panel is not None:
        if len(cor_views) == 1:
            cor_seq_str, cor_qual_str, ws, lengths = cor_views[0]
            uniform = bool((lengths >= ws).all())
            for i in range(n):
                length = ws if uniform else min(int(lengths[i]), ws)
                base = i * ws
                data.corrected_seq[i] = cor_seq_str[base : base + length]
                data.corrected_qual[i] = cor_qual_str[base : base + length]
        else:
            for i in range(n):
                seq_parts = []
                qual_parts = []
                for cor_seq_str, cor_qual_str, ws, lengths in cor_views:
                    length = min(int(lengths[i]), ws)
                    base = i * ws
                    seq_parts.append(cor_seq_str[base : base + length])
                    qual_parts.append(cor_qual_str[base : base + length])
                data.corrected_seq[i] = "".join(seq_parts)
                data.corrected_qual[i] = "".join(qual_parts)
    return data


def _prefetch(iterator, depth: int = 4):
    """Run `iterator` in a background thread with a bounded queue — the
    batch analog of the reference's one-io-thread-per-feed double buffering
    (reference feed.h:281-456). The native parser and file writes release
    the GIL, so ingest genuinely overlaps decode + emission."""
    import queue
    import threading

    fifo: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    failure: list[BaseException] = []

    def run():
        try:
            for item in iterator:
                fifo.put(item)
        except BaseException as error:  # propagate into the consumer
            failure.append(error)
        finally:
            fifo.put(sentinel)

    thread = threading.Thread(target=run, daemon=True, name="pheniqs-ingest")
    thread.start()
    while True:
        item = fifo.get()
        if item is sentinel:
            if failure:
                raise failure[0]
            return
        yield item


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class StrictEngine:
    def __init__(self, ontology: dict):
        self.ontology = ontology
        self.input_segment_cardinality = int(ontology["input segment cardinality"])
        self.output_segment_cardinality = int(ontology["output segment cardinality"])
        self.leading_segment_index = int(ontology.get("leading segment index", 0))
        self.filter_incoming_qc_fail = bool(
            ontology.get("filter incoming qc fail", False)
        )
        self.min_input_length = list(ontology.get("min input length", []))
        self.input_phred_offset = int(ontology.get("input phred offset", 33))
        self.output_phred_offset = int(ontology.get("output phred offset", 33))
        self.enable_quality_control = bool(
            ontology.get("enable quality control", False)
        )

        # classifiers
        sample = ontology.get("sample")
        self.sample = (
            ClassifierRuntime(sample, "sample") if isinstance(sample, dict) else None
        )
        # molecular/cellular accept the single-object and array shapes,
        # as the reference does (transcode.cpp:126-140)
        from ..config.compiler import topic_elements

        self.molecular = [
            ClassifierRuntime(element, "molecular")
            for element in topic_elements(ontology.get("molecular"))
        ]
        self.cellular = [
            ClassifierRuntime(element, "cellular")
            for element in topic_elements(ontology.get("cellular"))
        ]

        self.template_rule = Rule.from_ontology(
            ontology["template"]["transform"], allow_virtual=True
        )
        from ..native import available as _native_available

        self._native_render = _native_available()

        # multiplexing decoder + channels
        self.multiplexing = self._find_multiplexing_runtime()
        self.channels: list[Channel] = []
        self.feeds_by_url: dict[str, OutputFeed] = {}
        for proxy in ontology.get("feed", {}).get("output feed", []) or []:
            self.feeds_by_url[proxy["url"]] = OutputFeed(proxy, ontology)
        decoder_ontology = self._multiplexing_ontology()
        if decoder_ontology is not None:
            channel_nodes = [decoder_ontology.get("undetermined", {})]
            channel_nodes.extend(decoder_ontology.get("codec", {}).values())
            for index, node in enumerate(channel_nodes):
                self.channels.append(Channel(index, node, self.feeds_by_url))

        # per-channel QC accumulators (reference multiplex.h:167-196)
        self.channel_quality = None
        if self.enable_quality_control and self.channels:
            from ..report.quality import ChannelQualityAccumulator

            self.channel_quality = [
                ChannelQualityAccumulator(self.output_segment_cardinality)
                for _ in self.channels
            ]

        # incoming / outgoing counters
        self.incoming_count = 0
        self.incoming_pf_count = 0
        self.outgoing_count = 0
        self.outgoing_pf_count = 0

    def _run_classifier(self, runtime, batch, qcfail):
        """Classification dispatch point; the device engine overrides this
        to serve results from the jitted decode step."""
        return runtime.classify(batch, qcfail)

    def _find_multiplexing_runtime(self):
        for runtime in [self.sample, *self.cellular, *self.molecular]:
            if runtime is not None and runtime.spec.multiplexing:
                return runtime
        return self.sample

    def _multiplexing_ontology(self):
        if self.multiplexing is None:
            return None
        return self.multiplexing.spec.ontology

    # --- input -----------------------------------------------------------------
    def read_batches(self, batch_size: int = 4096):
        """Stream ReadBatches: native C++ parser when available and every
        feed is FASTQ, Python fallback otherwise.

        PHENIQS_SHARD="k:H" makes this process own batches k, k+H, ... —
        the per-host input slicing of the multi-host plan (each host reads
        a disjoint slice; merged statistics are order-insensitive sums)."""
        shard = os.environ.get("PHENIQS_SHARD")
        if shard:
            mine, hosts = (int(x) for x in shard.split(":"))
            for index, batch in enumerate(self._all_read_batches(batch_size)):
                if index % hosts == mine:
                    yield batch
            return
        yield from self._all_read_batches(batch_size)

    def _all_read_batches(self, batch_size: int = 4096):
        segment_proxies = self.ontology["feed"]["input feed by segment"]
        formats = [
            URL(proxy["url"]).format_type or "fastq"
            for proxy in segment_proxies
        ]
        if all(fmt in ("fastq", "bam", "cram") for fmt in formats):
            from ..native import available

            if available():
                from ..io.ingest import native_read_batches

                # the input decompression pool honors the same knob as the
                # output compression pool (reference --htslib-threads)
                pool_threads = self.ontology.get("htslib threads")
                if pool_threads and "PHENIQS_BGZF_THREADS" not in os.environ:
                    os.environ["PHENIQS_BGZF_THREADS"] = str(int(pool_threads))

                try:
                    yield from native_read_batches(
                        [URL(proxy["url"]).path for proxy in segment_proxies],
                        self.input_phred_offset,
                        batch_size,
                        leading_segment_index=self.leading_segment_index,
                        formats=formats,
                        sensed=bool(self.ontology["feed"].get("sensed")),
                        # zero-copy staging: streamed engines provide a
                        # shared-memory arena so the parser writes batch
                        # matrices straight into worker-visible slots
                        arena_provider=getattr(
                            self, "_parse_arena_provider", None
                        ),
                    )
                    return
                except FileNotFoundError:
                    # a .bam that is not BGZF-framed (or otherwise not
                    # native-readable): fall back to the Python reader
                    pass
        yield from self._python_read_batches(batch_size)

    def _record_stream(self, url: str, phred_offset: int):
        """Uniform (name, sequence_ascii, quality_phred, qcfail) record
        stream for any input format."""
        parsed = URL(url)
        fmt = parsed.format_type or "fastq"
        if fmt == "fastq":
            for record in read_fastq(parsed.path, phred_offset):
                yield (record.name, record.sequence, record.quality, record.qcfail)
        elif fmt in ("sam", "bam", "cram"):
            from ..io.hts import hts_record_reader

            for record in hts_record_reader(parsed.path, fmt):
                # classification quality domain is [0, 0x80): map the BAM
                # missing-quality sentinel (0xFF) to 0 and clamp
                # spec-invalid bytes, mirroring the native batch readers —
                # the f64 substitution LUT is sized 0x80 and the native
                # classifier indexes it unchecked (phred.py:17)
                quality = record.quality
                if quality.size and quality.max() >= 0x80:
                    quality = np.where(
                        quality == 0xFF, 0, np.minimum(quality, 0x7F)
                    ).astype(np.uint8)
                yield (
                    record.name,
                    BAM_TO_ASCII[record.code].tobytes(),
                    quality.tobytes(),
                    record.qcfail,
                )
        else:
            raise ConfigurationError(f"unsupported input format {fmt}")

    def _python_read_batches(self, batch_size: int = 4096):
        feed_proxies = self.ontology["feed"]["input feed"]
        segment_proxies = self.ontology["feed"]["input feed by segment"]
        iterators = {
            proxy["url"]: self._record_stream(
                proxy["url"], int(proxy.get("phred offset", 33))
            )
            for proxy in feed_proxies
        }
        segment_urls = [proxy["url"] for proxy in segment_proxies]

        records = []
        while True:
            read = []
            exhausted = False
            for url in segment_urls:
                record = next(iterators[url], None)
                if record is None:
                    exhausted = True
                    break
                read.append(record)
            if exhausted:
                break
            baseline = read[0][0]
            for record in read[1:]:
                if record[0] != baseline:
                    from ..errors import SequenceError

                    layout = ", ".join(
                        f"{p['url']}: {p.get('resolution', 1)}"
                        for p in feed_proxies
                    )
                    hint = f" (feed resolution: {layout})"
                    if self.ontology["feed"].get("sensed"):
                        hint += (
                            "; the layout was sensed from the head of each"
                            " feed and may be wrong for this input — declare"
                            " the input layout explicitly (repeat the url in"
                            " `input` once per interleaved segment) to"
                            " override sensing"
                        )
                    raise SequenceError(
                        f"read out of sync {record[0].decode()} and "
                        f"{baseline.decode()}" + hint
                    )
            records.append(list(read))
            if len(records) >= batch_size:
                yield ReadBatch.from_records(
                    records, self.leading_segment_index
                )
                records = []
        if records:
            yield ReadBatch.from_records(records, self.leading_segment_index)

    # --- execution ---------------------------------------------------------------
    def _initiate_feeds(self):
        header = SamHeader(self.ontology, self.ontology.get("program"))
        initiated = set()
        for url, feed in self.feeds_by_url.items():
            if id(feed) not in initiated:
                feed.initiate(header)
                initiated.add(id(feed))

    def _close_feeds(self):
        for feed in self.feeds_by_url.values():
            feed.close()

    def _stage_add(self, key: str, value: float):
        """Accumulate into the PHENIQS_TRACE pipeline ledger (lazy dict;
        entries named *_n are event counts, the rest seconds). Subclasses
        with a pipelined execute override this with a gated variant."""
        stages = getattr(self, "_stage_seconds", None)
        if stages is None:
            stages = self._stage_seconds = {}
        stages[key] = stages.get(key, 0.0) + value

    def _trace_summary(self, start):
        if os.environ.get("PHENIQS_TRACE") == "1":
            import time

            # throughput observability the reference lacks (SURVEY §5)
            elapsed = time.perf_counter() - start
            sys.stderr.write(
                f"[pheniqs-tpu] {self.incoming_count} reads in "
                f"{elapsed:.2f}s = {self.incoming_count / max(elapsed, 1e-9):,.0f} "
                f"reads/s ({type(self).__name__})\n"
            )
            stages = getattr(self, "_stage_seconds", None)
            if stages:
                # entries named *_n are event counts, not seconds
                breakdown = " ".join(
                    f"{name}={int(value)}"
                    if name.endswith("_n")
                    else f"{name}={value:.2f}s"
                    for name, value in stages.items()
                )
                sys.stderr.write(f"[pheniqs-tpu] pipeline: {breakdown}\n")

    def execute(self, batch_size: int = 4096):
        import time

        self._initiate_feeds()
        start = time.perf_counter()
        batches = self.read_batches(batch_size)
        if os.environ.get("PHENIQS_PREFETCH") == "1":
            # overlap ingest with processing; pays off only when the
            # pipeline is not GIL-bound (e.g. fast engine on a GPU)
            batches = _prefetch(batches)
        for batch in batches:
            self.process_batch(batch)
        self._close_feeds()
        self._trace_summary(start)

    def _apply_input_filters(self, batch: ReadBatch) -> ReadBatch:
        """Incoming qcfail + min-input-length filters (idempotent)."""
        n = batch.size
        keep = np.ones(n, dtype=bool)
        if self.filter_incoming_qc_fail:
            keep &= ~batch.qcfail
        for i in range(1, batch.segment_cardinality):
            if i < len(self.min_input_length) and self.min_input_length[i] > 0:
                keep &= batch.segments[i].length >= self.min_input_length[i]
        if not keep.all():
            batch = batch.select(keep)
        return batch

    def process_batch(self, batch: ReadBatch, filtered: bool = False):
        classified = self._classify_batch(batch, filtered)
        if classified is None:
            return
        self._consume_classified(*classified)

    def _consume_classified(self, batch: ReadBatch, results: list):
        """Hook between the classify and render halves; the streamed engine
        overrides this to hand rendering to worker processes."""
        self._render_batch(batch, results)

    def iter_runtimes(self):
        """Classifier chain in reference order: sample, molecular*,
        cellular* (reference transcode.h:51-65)."""
        out = []
        if self.sample is not None:
            out.append(self.sample)
        out.extend(self.molecular)
        out.extend(self.cellular)
        return out

    def _classify_batch(self, batch: ReadBatch, filtered: bool = False):
        """Classification + statistics half: runs every classifier in chain
        order and updates parent-owned counters. Returns (filtered batch,
        per-runtime ClassifyResult list), or None when nothing survives the
        input filters. The render half (`_render_batch`) is a pure function
        of these results and can run in a worker process."""
        if not filtered:
            self.incoming_count += batch.size
            self.incoming_pf_count += int((~batch.qcfail).sum())
            batch = self._apply_input_filters(batch)
        n = batch.size
        if n == 0:
            return None

        qcfail = batch.qcfail.copy()
        results: list[ClassifyResult] = []
        for runtime in self.iter_runtimes():
            result = self._run_classifier(runtime, batch, qcfail)
            qcfail = result.qcfail
            if (
                not result.observation
                and getattr(self, "_render_local", True)
                and runtime.spec.rule is not None
                and runtime.spec.algorithm != "passthrough"
            ):
                # render consumes the observation; engines whose render
                # workers recompute it remotely skip this back-fill
                result.observation = runtime.spec.rule.apply(batch.segments)
            results.append(result)

        self.outgoing_count += n
        self.outgoing_pf_count += int((~qcfail).sum())
        return batch, results

    def _render_batch(self, batch: ReadBatch, results: list):
        """Template application, tag assembly, QC accumulation, routing and
        output formatting for one classified batch."""
        n = batch.size
        runtimes = self.iter_runtimes()
        qcfail = results[-1].qcfail if results else batch.qcfail.copy()

        # string tag material is only needed on the python fallback path or
        # when the template references corrected-barcode virtual segments;
        # the native render path builds byte spans straight from the
        # observation matrices
        need_strings = self._render_plan()[1] is not None or any(
            tx.token.input_segment_index < 0
            for tx in self.template_rule.transform_array
        )

        position = 0
        sample_result = None
        sample_tags = None
        if self.sample is not None:
            sample_result = results[position]
            position += 1
            if need_strings and sample_result.observation:
                sample_tags = build_tag_data(
                    sample_result, self.sample.spec, corrected=True
                )

        molecular_results = []
        for runtime in self.molecular:
            result = results[position]
            position += 1
            tags = (
                build_tag_data(
                    result,
                    runtime.spec,
                    corrected=runtime.spec.algorithm == "pamld",
                )
                if need_strings and result.observation
                else None
            )
            molecular_results.append((runtime, result, tags))

        cellular_results = []
        for runtime in self.cellular:
            result = results[position]
            position += 1
            tags = (
                build_tag_data(result, runtime.spec, corrected=True)
                if need_strings and result.observation
                else None
            )
            cellular_results.append((runtime, result, tags))

        # --- combined confidences (reference read.h:279-348; the read
        # model's combined distances feed only the accumulators, which
        # record() owns — tags carry confidences alone)
        sample_conf = np.ones(n, dtype=np.float64)
        if (
            sample_result is not None
            and self.sample.spec.algorithm == "pamld"
        ):
            sample_conf = sample_result.confidence.copy()

        molecular_conf = np.ones(n, dtype=np.float64)
        for runtime, result, _ in molecular_results:
            if runtime.spec.algorithm == "pamld":
                classified = result.decoded > 0
                molecular_conf = np.where(
                    classified,
                    np.where(
                        molecular_conf == 1.0,
                        result.confidence,
                        molecular_conf * result.confidence,
                    ),
                    0.0,
                )

        cellular_conf = np.ones(n, dtype=np.float64)
        for runtime, result, _ in cellular_results:
            classified = result.decoded > 0
            if runtime.spec.algorithm == "pamld":
                cellular_conf = np.where(
                    classified,
                    np.where(
                        cellular_conf == 1.0,
                        result.confidence,
                        cellular_conf * result.confidence,
                    ),
                    0.0,
                )

        # --- channel routing
        if self.multiplexing is not None:
            if self.multiplexing is self.sample:
                channel_index = sample_result.decoded
            else:
                channel_index = np.zeros(n, dtype=np.int32)
                for runtime, result, _ in cellular_results + [
                    (r, res, None) for r, res, _ in molecular_results
                ]:
                    if runtime is self.multiplexing:
                        channel_index = result.decoded
                        break
        else:
            channel_index = np.zeros(n, dtype=np.int32)

        # --- template application
        segments = {i: s for i, s in enumerate(batch.segments)}
        needed = {
            tx.token.input_segment_index
            for tx in self.template_rule.transform_array
        }
        if needed & {-1, -2, -3}:
            segments.update(
                self._virtual_segments(
                    n, sample_result, sample_tags, molecular_results, cellular_results
                )
            )
        output_segments = self.template_rule.apply(segments)

        # --- RG per read
        rg_values = None
        if (
            self.sample is not None
            and self.sample.spec.rg_by_barcode_index
            and sample_result is not None
        ):
            rg_table = self.sample.spec.rg_by_barcode_index
            rg_values = [rg_table[i] for i in sample_result.decoded]

        # --- QC accumulation: every read pushed to its channel counts,
        # regardless of the outgoing qcfail filter (reference multiplex.h:219)
        if self.channel_quality is not None:
            for index, accumulator in enumerate(self.channel_quality):
                accumulator.increment_batch(
                    output_segments, channel_index == index
                )

        # --- emit records
        self._emit(
            batch,
            output_segments,
            qcfail,
            channel_index,
            rg_values,
            sample_result,
            sample_tags,
            sample_conf,
            molecular_results,
            molecular_conf,
            cellular_results,
            cellular_conf,
        )

    def _virtual_segments(
        self, n, sample_result, sample_tags, molecular_results, cellular_results
    ):
        """Corrected-barcode virtual segments for template tokens s/c/m."""
        from ..iupac import ASCII_TO_BAM

        virtual = {}

        def make(tag_sets):
            seqs = [""] * n
            quals = [""] * n
            for tags in tag_sets:
                if tags is None:
                    continue
                for i in range(n):
                    seqs[i] += tags.corrected_seq[i]
                    quals[i] += tags.corrected_qual[i]
            width = max((len(s) for s in seqs), default=0)
            code = np.zeros((n, width), dtype=np.uint8)
            qual = np.zeros((n, width), dtype=np.uint8)
            length = np.zeros(n, dtype=np.int32)
            for i in range(n):
                raw = seqs[i].encode()
                length[i] = len(raw)
                code[i, : len(raw)] = ASCII_TO_BAM[np.frombuffer(raw, dtype=np.uint8)]
                qual[i, : len(raw)] = (
                    np.frombuffer(quals[i].encode(), dtype=np.uint8) - 33
                )
            return SegmentBatch(code=code, quality=qual, length=length)

        virtual[-1] = make([sample_tags])
        virtual[-2] = make([t for _, _, t in cellular_results])
        virtual[-3] = make(
            [
                t
                for r, _, t in molecular_results
                if r.spec.algorithm == "pamld" and t is not None
            ]
        )
        return virtual

    def _render_plan(self):
        """Columnar render dispatch: group routed feeds by format and
        give every group that can take a columnar route its own pass —
        MIXED-format jobs (e.g. .cram + .sam outputs in one config) no
        longer drop the whole render onto the per-read fallback (the
        ~6x CRAM-intake cliff).

        Returns (plan, fallback): plan = [(mode, feed-id set)] for the
        columnar passes, fallback = feed-id set for feeds that still
        need the per-read Python path (native lib absent, diagnostic
        override, unknown format), or None when every feed is covered.
        """
        routed = [c for c in self.channels if c.feeds]
        if not routed:
            return [], None
        by_format: dict[str, set[int]] = {}
        feeds_by_id: dict[int, object] = {}
        for channel in routed:
            for feed in channel.feeds:
                by_format.setdefault(feed.format, set()).add(id(feed))
                feeds_by_id[id(feed)] = feed
        from ..native import load as native_load

        native_ok = native_load() is not None
        no_columns = os.environ.get("PHENIQS_BAM_COLUMNS") == "0"
        plan: list[tuple[str, set[int]]] = []
        fallback: set[int] = set()
        for fmt, ids in by_format.items():
            if fmt == "cram":
                # diagnostic override, or all-dev-null (no initiated
                # writer): cheap per-record path
                if no_columns or not any(
                    getattr(feeds_by_id[i], "bam", None) is not None
                    for i in ids
                ):
                    fallback |= ids
                else:
                    plan.append((fmt, ids))
            elif fmt in ("sam", "bam", "fastq"):
                if (fmt == "bam" and no_columns) or not native_ok:
                    fallback |= ids
                else:
                    plan.append((fmt, ids))
            else:
                fallback |= ids
        return plan, (fallback or None)

    def _native_mode(self):
        """"sam" / "bam" / "cram" / "fastq" when every routed feed takes
        the SAME columnar route; None when any feed needs the per-read
        fallback or formats mix (mixed jobs dispatch per group through
        _render_plan)."""
        plan, fallback = self._render_plan()
        if fallback is not None or len(plan) != 1:
            return None
        return plan[0][0]

    def _sam_native_ready(self):
        return self._native_mode() == "sam"

    def _observation_spans(self, result, spec, corrected: bool):
        """(buffer, starts, lens) byte spans for the raw (and corrected)
        barcode sequence/quality of one classifier, straight from the
        observation matrices when row data is contiguous (single segment,
        or every segment filled to width); string fallback otherwise."""
        observation = result.observation
        n = observation[0].length.shape[0]
        single = len(observation) == 1
        uniform = all(
            bool((seg.length == seg.width).all()) for seg in observation
        )
        if not (single or uniform):
            tags = build_tag_data(
                result, spec, phred_offset=33, corrected=corrected
            )
            from ..native import SpanColumn

            def spans(values):
                column = SpanColumn.from_strings(b"", values)
                return column.buffer, column.starts, column.lens

            out = {
                "raw_seq": spans(tags.raw_seq),
                "raw_qual": spans(tags.raw_qual),
            }
            if corrected and spec.panel is not None:
                out["cor_seq"] = spans(tags.corrected_seq)
                out["cor_qual"] = spans(tags.corrected_qual)
            return out

        corrected_panel = corrected and spec.panel is not None
        if self._native_render:
            from ..native import observation_spans

            panel_segs = None
            if corrected_panel:
                panel_segs = [
                    spec.panel.codes[:, sl]
                    for sl in spec.panel.segment_slices()
                ]
            out = observation_spans(
                observation,
                panel_segs,
                result.decoded if corrected_panel else None,
                int(spec.corrected_quality),
            )
            if out is not None:
                return out

        if single:
            code_m = observation[0].code
            qual_m = observation[0].quality
            lens = np.minimum(
                observation[0].length, observation[0].width
            ).astype(np.int32)
        else:
            code_m = np.hstack([seg.code for seg in observation])
            qual_m = np.hstack([seg.quality for seg in observation])
            lens = np.full(n, code_m.shape[1], dtype=np.int32)
        width = code_m.shape[1]
        starts = np.arange(n, dtype=np.int64) * width
        out = {
            "raw_seq": (BAM_TO_ASCII[code_m].tobytes(), starts, lens),
            "raw_qual": (
                (qual_m.astype(np.uint8) + 33).tobytes(), starts, lens
            ),
        }
        if corrected and spec.panel is not None:
            cor_codes = []
            cor_quals = []
            cor_lens = np.zeros(n, dtype=np.int32)
            for segment_index, segment in enumerate(observation):
                sl = spec.panel.segment_slices()[segment_index]
                barcode_codes = np.vstack(
                    [
                        np.zeros(sl.stop - sl.start, dtype=np.uint8),
                        spec.panel.codes[:, sl],
                    ]
                )
                chosen = barcode_codes[result.decoded]
                ws = min(segment.width, chosen.shape[1])
                cor_code = chosen[:, :ws]
                keep_original = (
                    segment.code[:, :ws] == cor_code
                ) | (cor_code == 0)
                cor_qual = np.where(
                    keep_original,
                    segment.quality[:, :ws],
                    np.uint8(spec.corrected_quality),
                )
                cor_codes.append(cor_code)
                cor_quals.append(cor_qual)
                cor_lens += np.minimum(segment.length, ws).astype(np.int32)
            cor_code_m = (
                cor_codes[0] if single else np.hstack(cor_codes)
            )
            cor_qual_m = (
                cor_quals[0] if single else np.hstack(cor_quals)
            )
            cor_width = cor_code_m.shape[1]
            cor_starts = np.arange(n, dtype=np.int64) * cor_width
            out["cor_seq"] = (
                BAM_TO_ASCII[cor_code_m].tobytes(), cor_starts, cor_lens
            )
            out["cor_qual"] = (
                (cor_qual_m.astype(np.uint8) + 33).tobytes(),
                cor_starts,
                cor_lens,
            )
        return out

    @staticmethod
    def _combine_spans(spans_list):
        """Concatenate per-read spans of several classifiers into one span
        set (used for multi-round cellular / multiple molecular tags)."""
        if len(spans_list) == 1:
            return spans_list[0]
        n = spans_list[0][2].shape[0]
        total = sum(spans[2] for spans in spans_list)
        # materialize combined per-read bytes
        pieces = []
        for i in range(n):
            for buffer, starts, lens in spans_list:
                pieces.append(buffer[starts[i] : starts[i] + lens[i]])
        combined = b"".join(pieces)
        starts = np.zeros(n, dtype=np.int64)
        np.cumsum(total[:-1], out=starts[1:])
        return combined, starts, total.astype(np.int32)

    def _tag_columns(
        self,
        n,
        sample_result,
        sample_conf,
        molecular_results,
        molecular_conf,
        cellular_results,
        cellular_conf,
    ):
        """Vectorized tag material in the AuxTags emission order (reference
        auxiliary.cpp:327-359): byte-span columns for string tags, float
        columns for XB/XM/XC (mask = confidence strictly inside (0, 1))."""
        from ..native import FloatColumn, SpanColumn

        columns = []

        def span_column(prefix, spans):
            return SpanColumn(prefix, spans[0], spans[1], spans[2])

        # RG: read-group table indexed by the decoded sample barcode
        if (
            self.sample is not None
            and self.sample.spec.rg_by_barcode_index
            and sample_result is not None
        ):
            table = self.sample.spec.rg_by_barcode_index
            arena = "".join(table).encode("latin-1")
            table_lens = np.fromiter(
                (len(v) for v in table), dtype=np.int32, count=len(table)
            )
            table_starts = np.zeros(len(table), dtype=np.int64)
            np.cumsum(table_lens[:-1], out=table_starts[1:])
            decoded = sample_result.decoded
            columns.append(
                SpanColumn(
                    b"RG:Z:",
                    arena,
                    table_starts[decoded],
                    table_lens[decoded],
                )
            )

        sample_spans = None
        if (
            self.sample is not None
            and sample_result is not None
            and sample_result.observation
        ):
            sample_spans = self._observation_spans(
                sample_result, self.sample.spec, corrected=True
            )
            columns.append(span_column(b"BC:Z:", sample_spans["raw_seq"]))
            columns.append(span_column(b"QT:Z:", sample_spans["raw_qual"]))
        columns.append(
            FloatColumn(
                b"XB:f:",
                (1.0 - sample_conf).astype(np.float32),
                (sample_conf > 0) & (sample_conf < 1),
            )
        )

        mol_spans = [
            (runtime, self._observation_spans(
                result, runtime.spec,
                corrected=runtime.spec.algorithm == "pamld",
            ))
            for runtime, result, _tags in molecular_results
            if result.observation
        ]
        pamld_mol = [
            spans for runtime, spans in mol_spans
            if runtime.spec.algorithm == "pamld"
        ]
        if pamld_mol:
            columns.append(
                span_column(
                    b"RX:Z:",
                    self._combine_spans([s["cor_seq"] for s in pamld_mol]),
                )
            )
            columns.append(
                span_column(
                    b"QX:Z:",
                    self._combine_spans([s["cor_qual"] for s in pamld_mol]),
                )
            )
        if mol_spans:
            ox = self._combine_spans([s["raw_seq"] for _, s in mol_spans])
            bz = self._combine_spans([s["raw_qual"] for _, s in mol_spans])
            columns.append(span_column(b"OX:Z:", ox))
            bz_column = span_column(b"BZ:Z:", bz)
            bz_column.lens = np.where(ox[2] > 0, bz_column.lens, 0).astype(
                np.int32
            )
            columns.append(bz_column)
        columns.append(
            FloatColumn(
                b"XM:f:",
                (1.0 - molecular_conf).astype(np.float32),
                (molecular_conf > 0) & (molecular_conf < 1),
            )
        )

        cell_spans = [
            self._observation_spans(result, runtime.spec, corrected=True)
            for runtime, result, _tags in cellular_results
            if result.observation
        ]
        if cell_spans:
            columns.append(
                span_column(
                    b"CB:Z:",
                    self._combine_spans([s["cor_seq"] for s in cell_spans]),
                )
            )
            cr = self._combine_spans([s["raw_seq"] for s in cell_spans])
            cy = self._combine_spans([s["raw_qual"] for s in cell_spans])
            columns.append(span_column(b"CR:Z:", cr))
            cy_column = span_column(b"CY:Z:", cy)
            cy_column.lens = np.where(cr[2] > 0, cy_column.lens, 0).astype(
                np.int32
            )
            columns.append(cy_column)
        columns.append(
            FloatColumn(
                b"XC:f:",
                (1.0 - cellular_conf).astype(np.float32),
                (cellular_conf > 0) & (cellular_conf < 1),
            )
        )
        return columns

    def _routed_rows(self, qcfail, channel_index):
        """(rows, channel_by_index): reads surviving channel existence +
        per-channel outgoing-qcfail filters (shared by every output
        route)."""
        n = qcfail.shape[0]
        keep = np.zeros(n, dtype=bool)
        channel_by_index = {}
        for index, channel in enumerate(self.channels):
            if not channel.feeds:
                continue
            channel_by_index[index] = channel
            selected = channel_index == index
            if channel.filter_outgoing_qc_fail:
                selected = selected & ~qcfail
            keep |= selected
        return np.flatnonzero(keep), channel_by_index

    @staticmethod
    def _feed_routes(channel_by_index):
        """feed -> (feed, {channel index: [segment slots]}) groupings."""
        routes: dict[int, tuple] = {}
        for index, channel in channel_by_index.items():
            for s, feed in enumerate(channel.feeds):
                entry = routes.setdefault(id(feed), (feed, {}))
                entry[1].setdefault(index, []).append(s)
        return routes

    def _route_and_write_columns(
        self, batch, output_segments, qcfail, channel_index, flags,
        columns, container: str = "sam", feed_ids: set | None = None,
    ):
        """Native full-render routing: one formatted arena per output
        segment (SAM text lines or BAM binary records from the same
        column material), written per feed in global arrival order."""
        import struct as struct_mod

        from ..native import ConstColumn, bam_format_full, sam_format_full

        format_full = (
            bam_format_full if container == "bam" else sam_format_full
        )

        n = batch.size
        cardinality = len(output_segments)
        fail_flags = qcfail.astype(np.int32) * FLAG_QCFAIL

        rows, channel_by_index = self._routed_rows(qcfail, channel_index)
        if rows.size == 0:
            return

        names_blob = batch.names_blob
        name_offsets = batch.name_offsets

        arenas = []
        for s in range(cardinality):
            segment = output_segments[s]
            segment_columns = columns
            if cardinality > 2:
                if container == "bam":
                    # pre-encoded binary aux (encode_bam_aux order:
                    # FI before TC, both only when TC > 2)
                    const = (
                        b"FIi" + struct_mod.pack("<i", s + 1)
                        + b"TCi" + struct_mod.pack("<i", cardinality)
                    )
                else:
                    const = f"FI:i:{s + 1}\tTC:i:{cardinality}".encode()
                segment_columns = [ConstColumn(const)] + columns
            arenas.append(
                format_full(
                    names_blob,
                    name_offsets,
                    np.full(n, flags[s], dtype=np.int32) | fail_flags,
                    segment.code,
                    segment.quality,
                    segment.length,
                    self.output_phred_offset,
                    segment_columns,
                )
            )

        feed_routes = self._feed_routes(channel_by_index)

        from ..native import concat_spans

        for feed, by_channel in feed_routes.values():
            if feed_ids is not None and id(feed) not in feed_ids:
                continue  # mixed-format job: another pass owns this feed
            segment_lists = {tuple(v) for v in by_channel.values()}
            if len(segment_lists) == 1:
                # uniform routing (the usual case): gather all spans with
                # one native concat — no per-read Python
                segs = list(segment_lists.pop())
                member = np.isin(
                    channel_index[rows], np.fromiter(by_channel, dtype=np.int64)
                )
                feed_rows = rows[member]
                if feed_rows.size == 0:
                    continue
                k = len(segs)
                piece_arena = np.tile(
                    np.arange(k, dtype=np.uint8), feed_rows.size
                )
                piece_start = np.stack(
                    [arenas[s][1][feed_rows] for s in segs], axis=1
                ).reshape(-1)
                piece_len = np.stack(
                    [
                        arenas[s][1][feed_rows + 1] - arenas[s][1][feed_rows]
                        for s in segs
                    ],
                    axis=1,
                ).reshape(-1)
                payload = concat_spans(
                    [arenas[s][0] for s in segs],
                    piece_arena,
                    piece_start,
                    piece_len,
                )
                if payload is not None and len(payload):
                    feed.write_records(payload)
                continue
            pieces = []
            for i in rows:
                segment_list = by_channel.get(int(channel_index[i]))
                if segment_list is None:
                    continue
                for s in segment_list:
                    arena, offsets = arenas[s]
                    pieces.append(arena[offsets[i] : offsets[i + 1]])
            if pieces:
                feed.write_records(b"".join(pieces))

    def _route_and_write_cram(
        self, batch, output_segments, qcfail, channel_index, flags,
        columns, sample_decoded=None, feed_ids: set | None = None,
    ):
        """Columnar CRAM render: convert the span/float tag columns into
        CramWriter.write_batch's masked column form (multi-TD slices) and
        write whole interleaved-record blocks per feed — replacing the
        per-read AuxTags intake that made `--output x.cram` the slowest
        output path."""
        n = batch.size
        cardinality = len(output_segments)
        fail_flags = qcfail.astype(np.int64) * FLAG_QCFAIL

        rows, channel_by_index = self._routed_rows(qcfail, channel_index)
        if rows.size == 0:
            return

        # span/float columns -> (key2, type, full-N values, mask) form;
        # RG is skipped (it rides the dedicated CRAM RG series)
        cram_columns = []
        rg_decoded = None
        for column in columns:
            key2 = bytes(column.prefix[:2])
            typechar = chr(column.prefix[3])
            if column.kind == 1:
                cram_columns.append(
                    (key2, "f", column.values, column.mask.astype(bool))
                )
                continue
            if key2 == b"RG":
                rg_decoded = column  # table-indexed span column
                continue
            lens = column.lens
            present = lens > 0
            buffer = column.buffer
            if isinstance(buffer, np.ndarray):
                buffer_arr = buffer
            else:
                buffer_arr = np.frombuffer(buffer, dtype=np.uint8)
            present_lens = lens[present]
            if present_lens.size and (
                present_lens == present_lens[0]
            ).all():
                w = int(present_lens[0])
                starts = np.where(present, column.starts, 0)
                matrix = buffer_arr[
                    starts[:, None] + np.arange(w, dtype=np.int64)[None, :]
                ]
                cram_columns.append((key2, typechar, matrix, present))
            else:
                values = [
                    (
                        buffer_arr[
                            column.starts[i] : column.starts[i] + lens[i]
                        ].tobytes()
                        if present[i]
                        else b""
                    )
                    for i in range(n)
                ]
                cram_columns.append((key2, typechar, values, present))

        feed_routes = self._feed_routes(channel_by_index)

        names = batch.names
        flag_arr = np.asarray(flags, dtype=np.int64)
        for feed, by_channel in feed_routes.values():
            if feed_ids is not None and id(feed) not in feed_ids:
                continue  # mixed-format job: another pass owns this feed
            writer = getattr(feed, "bam", None)
            if writer is None:
                continue  # dev-null
            member = np.isin(
                channel_index[rows], np.fromiter(by_channel, dtype=np.int64)
            )
            feed_rows = rows[member]
            if feed_rows.size == 0:
                continue
            segment_lists = {tuple(v) for v in by_channel.values()}
            if len(segment_lists) != 1:
                # mixed per-channel segment subsets on one feed: rare
                # config; emit per read through the writer's record API
                for i in feed_rows:
                    for s in by_channel[int(channel_index[i])]:
                        self._emit_cram_row(
                            writer, batch, output_segments, i, s,
                            int(flag_arr[s] | fail_flags[i]), cram_columns,
                            rg_decoded, sample_decoded,
                        )
                continue
            segs = list(segment_lists.pop())
            k = len(segs)
            r = feed_rows.size
            rec_names = [names[i] for i in feed_rows for _ in range(k)]
            rec_flags = (
                fail_flags[feed_rows][:, None] + flag_arr[segs][None, :]
            ).reshape(-1)
            width = max(
                max(output_segments[s].code.shape[1] for s in segs), 1
            )
            rec_codes = np.zeros((r * k, width), dtype=np.uint8)
            rec_quals = np.zeros((r * k, width), dtype=np.uint8)
            rec_lens = np.zeros(r * k, dtype=np.int64)
            for position, s in enumerate(segs):
                segment = output_segments[s]
                w = segment.code.shape[1]
                rec_codes[position::k, :w] = segment.code[feed_rows]
                rec_quals[position::k, :w] = segment.quality[feed_rows]
                rec_lens[position::k] = np.clip(
                    segment.length[feed_rows], 0, w
                )
            if rg_decoded is not None and sample_decoded is not None:
                table_index = self._cram_rg_table(writer, sample_decoded)
                rec_rg = np.repeat(table_index[feed_rows], k)
            else:
                rec_rg = np.full(r * k, -1, dtype=np.int64)

            rec_columns = []
            if cardinality > 2:
                rec_columns.append(
                    (
                        b"FI", "i",
                        np.tile(
                            np.asarray(segs, dtype=np.int32) + 1, r
                        ),
                    )
                )
                rec_columns.append(
                    (
                        b"TC", "i",
                        np.full(r * k, cardinality, dtype=np.int32),
                    )
                )
            for key2, typechar, values, mask in cram_columns:
                if isinstance(values, np.ndarray):
                    rec_values = np.repeat(values[feed_rows], k, axis=0)
                else:
                    rec_values = [
                        values[i] for i in feed_rows for _ in range(k)
                    ]
                rec_mask = np.repeat(mask[feed_rows], k)
                rec_columns.append((key2, typechar, rec_values, rec_mask))
            writer.write_batch(
                rec_names, rec_flags, rec_codes, rec_quals, rec_lens,
                rec_rg, rec_columns,
            )

    def _cram_rg_table(self, writer, sample_decoded):
        """decoded sample barcode -> CRAM read-group index, via the
        writer's header RG registry (row 0 = undetermined)."""
        table = self.sample.spec.rg_by_barcode_index
        return np.fromiter(
            (writer.rg_index.get(name, -1) for name in table),
            dtype=np.int64,
            count=len(table),
        )[sample_decoded]

    def _emit_cram_row(
        self, writer, batch, output_segments, i, s, flag, cram_columns,
        rg_decoded, sample_decoded,
    ):
        """Single-record fallback for mixed-segment feed routing."""
        from ..io.sam import AuxTags

        segment = output_segments[s]
        cardinality = len(output_segments)
        tags = AuxTags()
        if cardinality > 2:
            tags.FI = s + 1
            tags.TC = cardinality
        if rg_decoded is not None and sample_decoded is not None:
            tags.RG = self.sample.spec.rg_by_barcode_index[
                int(sample_decoded[i])
            ]
        for key2, typechar, values, mask in cram_columns:
            if not mask[i]:
                continue
            name = key2.decode()
            if not hasattr(tags, name):
                continue
            if typechar == "f":
                setattr(tags, name, float(values[i]))
                continue
            value = (
                values[i].tobytes()
                if isinstance(values, np.ndarray)
                else values[i]
            )
            if isinstance(value, bytes):
                value = value.decode("latin-1")
            setattr(tags, name, value)
        writer.write_record(
            batch.names[i].decode(), flag, segment.code[i],
            segment.quality[i],
            int(min(segment.length[i], segment.code.shape[1])), tags,
        )

    def _route_and_write_fastq(
        self, batch, output_segments, qcfail, channel_index, bc_span,
        feed_ids: set | None = None,
    ):
        """Native FASTQ rendering with the reconstructed Illumina comment
        (reference fastq.h:180-198), routed per feed in arrival order."""
        from ..native import concat_spans, fastq_format_batch

        n = batch.size
        cardinality = len(output_segments)
        platform = str(self.ontology.get("platform", "ILLUMINA"))
        with_comment = platform in ("ILLUMINA", "ELEMENT")

        rows, channel_by_index = self._routed_rows(qcfail, channel_index)
        if rows.size == 0:
            return

        arenas = []
        for s in range(cardinality):
            segment = output_segments[s]
            arenas.append(
                fastq_format_batch(
                    batch.names_blob,
                    batch.name_offsets,
                    qcfail,
                    (s + 1) if with_comment else 0,
                    segment.code,
                    segment.quality,
                    segment.length,
                    self.output_phred_offset,
                    bc_span,
                )
            )

        feed_routes = self._feed_routes(channel_by_index)
        for feed, by_channel in feed_routes.values():
            if feed_ids is not None and id(feed) not in feed_ids:
                continue  # mixed-format job: another pass owns this feed
            segment_lists = {tuple(v) for v in by_channel.values()}
            segs = sorted({s for v in by_channel.values() for s in v})
            if len(segment_lists) == 1:
                member = np.isin(
                    channel_index[rows], np.fromiter(by_channel, dtype=np.int64)
                )
                feed_rows = rows[member]
                if feed_rows.size == 0:
                    continue
                segs = list(segment_lists.pop())
                k = len(segs)
                piece_arena = np.tile(
                    np.arange(k, dtype=np.uint8), feed_rows.size
                )
                piece_start = np.stack(
                    [arenas[s][1][feed_rows] for s in segs], axis=1
                ).reshape(-1)
                piece_len = np.stack(
                    [
                        arenas[s][1][feed_rows + 1] - arenas[s][1][feed_rows]
                        for s in segs
                    ],
                    axis=1,
                ).reshape(-1)
                payload = concat_spans(
                    [arenas[s][0] for s in segs],
                    piece_arena,
                    piece_start,
                    piece_len,
                )
                if payload is not None and len(payload):
                    feed.write(payload)
                continue
            for i in rows:
                segment_list = by_channel.get(int(channel_index[i]))
                if segment_list is None:
                    continue
                for s in segment_list:
                    arena, offsets = arenas[s]
                    feed.write(arena[offsets[i] : offsets[i + 1]])

    def _emit(
        self,
        batch,
        output_segments,
        qcfail,
        channel_index,
        rg_values,
        sample_result,
        sample_tags,
        sample_conf,
        molecular_results,
        molecular_conf,
        cellular_results,
        cellular_conf,
    ):
        n = batch.size
        cardinality = len(output_segments)
        base_flag = FLAG_UNMAP | FLAG_MUNMAP
        flags = []
        for s in range(cardinality):
            flag = base_flag
            if cardinality > 1:
                flag |= FLAG_PAIRED
                if s == 0:
                    flag |= FLAG_READ1
                if s == cardinality - 1:
                    flag |= FLAG_READ2
            flags.append(flag)

        plan, fallback_ids = self._render_plan()
        single = len(plan) == 1 and fallback_ids is None
        columns = None
        for mode, feed_ids in plan:
            # a single-format job needs no per-feed filtering (the
            # overwhelmingly common case keeps its fast path)
            ids = None if single else feed_ids
            if mode in ("sam", "bam", "cram"):
                if columns is None:
                    columns = self._tag_columns(
                        n,
                        sample_result,
                        sample_conf,
                        molecular_results,
                        molecular_conf,
                        cellular_results,
                        cellular_conf,
                    )
                if mode == "cram":
                    self._route_and_write_cram(
                        batch, output_segments, qcfail, channel_index,
                        flags, columns,
                        sample_decoded=(
                            sample_result.decoded
                            if sample_result is not None
                            else None
                        ),
                        feed_ids=ids,
                    )
                else:
                    self._route_and_write_columns(
                        batch, output_segments, qcfail, channel_index,
                        flags, columns, container=mode, feed_ids=ids,
                    )
            else:
                bc_span = None
                if (
                    self.sample is not None
                    and sample_result is not None
                    and sample_result.observation
                ):
                    bc_span = self._observation_spans(
                        sample_result, self.sample.spec, corrected=False
                    )["raw_seq"]
                self._route_and_write_fastq(
                    batch, output_segments, qcfail, channel_index, bc_span,
                    feed_ids=ids,
                )
        if plan and fallback_ids is None:
            return

        # fallback path: per-read AuxTags assembly
        tag_list = []
        for i in range(n):
            name = batch.names[i].decode()
            tags = AuxTags()
            if rg_values is not None:
                tags.RG = rg_values[i]
            if sample_tags is not None:
                tags.BC = sample_tags.raw_seq[i]
                tags.QT = sample_tags.raw_qual[i]
            if 0 < sample_conf[i] < 1:
                tags.XB = 1.0 - sample_conf[i]

            raw_mol_seq = ""
            raw_mol_qual = ""
            cor_mol_seq = ""
            cor_mol_qual = ""
            for runtime, result, mtags in molecular_results:
                if mtags is not None:
                    raw_mol_seq += mtags.raw_seq[i]
                    raw_mol_qual += mtags.raw_qual[i]
                    if runtime.spec.algorithm == "pamld":
                        cor_mol_seq += mtags.corrected_seq[i]
                        cor_mol_qual += mtags.corrected_qual[i]
            if raw_mol_seq:
                tags.OX = raw_mol_seq
                tags.BZ = raw_mol_qual
            if cor_mol_seq:
                tags.RX = cor_mol_seq
                tags.QX = cor_mol_qual
            if 0 < molecular_conf[i] < 1:
                tags.XM = 1.0 - molecular_conf[i]

            cor_cell_seq = ""
            raw_cell_seq = ""
            raw_cell_qual = ""
            for runtime, result, ctags in cellular_results:
                if ctags is not None:
                    raw_cell_seq += ctags.raw_seq[i]
                    raw_cell_qual += ctags.raw_qual[i]
                    cor_cell_seq += ctags.corrected_seq[i]
            if cor_cell_seq:
                tags.CB = cor_cell_seq
            if raw_cell_seq:
                tags.CR = raw_cell_seq
                tags.CY = raw_cell_qual
            if 0 < cellular_conf[i] < 1:
                tags.XC = 1.0 - cellular_conf[i]

            tag_list.append(tags)

        self._route_and_write(
            batch, output_segments, qcfail, channel_index, flags, tag_list,
            feed_ids=fallback_ids,
        )

    def _route_and_write(
        self, batch, output_segments, qcfail, channel_index, flags, tag_list,
        feed_ids: set | None = None,
    ):
        """Route classified reads to their channels\' output feeds in
        global arrival order (the reference pushes per read under ordered
        feed locks, so feeds shared by several channels interleave reads in
        input order; goldens are produced single-threaded). SAM-format
        feeds use the native batch formatter; other formats fall back to
        per-read emission."""
        n = batch.size
        cardinality = len(output_segments)
        fail_flags = qcfail.astype(np.int32) * FLAG_QCFAIL

        rows, channel_by_index = self._routed_rows(qcfail, channel_index)
        if rows.size == 0:
            return

        all_sam = all(
            feed.format == "sam"
            for channel in channel_by_index.values()
            for feed in channel.feeds
        )
        native_format = None
        if all_sam:
            from ..native import load as native_load, sam_format_batch

            if native_load() is not None:
                native_format = sam_format_batch

        if native_format is not None:
            names_blob = batch.names_blob
            name_offsets = batch.name_offsets
            tag_bytes = [t.encode().encode() for t in tag_list]
            tag_blob = b"".join(tag_bytes)
            tag_offsets = np.zeros(n + 1, dtype=np.int64)
            tag_offsets[1:] = np.cumsum([len(x) for x in tag_bytes])
            arenas = []
            for s in range(cardinality):
                segment = output_segments[s]
                arenas.append(
                    native_format(
                        names_blob,
                        name_offsets,
                        np.full(n, flags[s], dtype=np.int32) | fail_flags,
                        segment.code,
                        segment.quality,
                        segment.length,
                        self.output_phred_offset,
                        tag_blob,
                        tag_offsets,
                    )
                )
            # feed -> {channel index -> ordered segment list}
            feed_routes: dict[int, tuple] = {}
            for index, channel in channel_by_index.items():
                for s, feed in enumerate(channel.feeds):
                    entry = feed_routes.setdefault(id(feed), (feed, {}))
                    entry[1].setdefault(index, []).append(s)
            channels_of_row = channel_index
            for feed, by_channel in feed_routes.values():
                if feed_ids is not None and id(feed) not in feed_ids:
                    continue  # a columnar pass owns this feed
                pieces = []
                for i in rows:
                    segment_list = by_channel.get(int(channels_of_row[i]))
                    if segment_list is None:
                        continue
                    for s in segment_list:
                        arena, offsets = arenas[s]
                        pieces.append(arena[offsets[i] : offsets[i + 1]])
                if pieces:
                    feed.write(b"".join(pieces))
        else:
            for i in rows:
                channel = channel_by_index[int(channel_index[i])]
                name = batch.names[i].decode()
                tags = tag_list[i]
                if cardinality > 2:
                    tags.TC = cardinality
                for s in range(cardinality):
                    if cardinality > 2:
                        # per-segment FI with the read's TC (reference
                        # read.h flush; emitted only when TC > 2)
                        tags.FI = s + 1
                    segment = output_segments[s]
                    feed = channel.feeds[s]
                    if feed_ids is not None and id(feed) not in feed_ids:
                        continue  # a columnar pass owns this feed
                    feed.emit(
                        name,
                        int(flags[s] | fail_flags[i]),
                        segment.code[i],
                        segment.quality[i],
                        int(segment.length[i]),
                        tags,
                        s,
                    )

    # --- partial-run statistics (PHENIQS_SHARD merge workflow) ------------------
    def _partial_runtimes(self):
        """Deterministic decoder order for partial serialization: sample,
        molecular*, cellular* (matches finalize_report's traversal)."""
        runtimes = []
        if self.sample is not None:
            runtimes.append(self.sample)
        runtimes.extend(self.molecular)
        runtimes.extend(self.cellular)
        return runtimes

    def dump_partial_state(self) -> dict:
        """Raw statistic sums for one input shard (PHENIQS_SHARD=k:H run).
        Every field merges across shards by elementwise addition, so H
        partials recombine into exactly the single-run report — the
        multi-host analog of the reference's thread-local accumulator
        collect (reference selector.h:32-92)."""
        doc: dict = {
            "pheniqs partial": 1,
            "incoming count": self.incoming_count,
            "incoming pf count": self.incoming_pf_count,
            "outgoing count": self.outgoing_count,
            "outgoing pf count": self.outgoing_pf_count,
            "decoders": [
                runtime.accumulator.state_dict()
                for runtime in self._partial_runtimes()
            ],
        }
        if self.channel_quality is not None:
            doc["multiplex"] = [
                accumulator.state_dict() for accumulator in self.channel_quality
            ]
        return doc

    def merge_partial_state(self, doc: dict):
        from ..errors import ConfigurationError

        if doc.get("pheniqs partial") != 1:
            raise ConfigurationError("not a pheniqs partial statistics document")
        runtimes = self._partial_runtimes()
        states = doc.get("decoders", [])
        if len(states) != len(runtimes):
            raise ConfigurationError(
                f"partial has {len(states)} decoders; "
                f"configuration has {len(runtimes)}"
            )
        try:
            for runtime, state in zip(runtimes, states):
                runtime.accumulator.merge_state(state)
            quality_states = doc.get("multiplex")
            if quality_states is not None and self.channel_quality is not None:
                if len(quality_states) != len(self.channel_quality):
                    raise ValueError(
                        f"partial has {len(quality_states)} channels; "
                        f"configuration has {len(self.channel_quality)}"
                    )
                for accumulator, state in zip(
                    self.channel_quality, quality_states
                ):
                    accumulator.merge_state(state)
        except ValueError as error:
            raise ConfigurationError(
                f"partial does not match configuration: {error}"
            ) from error
        self.incoming_count += int(doc.get("incoming count", 0))
        self.incoming_pf_count += int(doc.get("incoming pf count", 0))
        self.outgoing_count += int(doc.get("outgoing count", 0))
        self.outgoing_pf_count += int(doc.get("outgoing pf count", 0))

    # --- report ----------------------------------------------------------------
    def finalize_report(self, include_job: dict | None = None) -> dict:
        from ..report.accumulate import encode_decoder_report

        report: dict = {}
        if include_job is not None:
            report["job"] = include_job
        if self.incoming_count > 0:
            report["incoming"] = {
                "count": self.incoming_count,
                "pf count": self.incoming_pf_count,
                "pf fraction": self.incoming_pf_count / self.incoming_count,
            }
        if self.outgoing_count > 0:
            report["outgoing"] = {
                "count": self.outgoing_count,
                "pf count": self.outgoing_pf_count,
                "pf fraction": self.outgoing_pf_count / self.outgoing_count,
            }
        if self.sample is not None:
            final = self.sample.accumulator.finalize()
            sample_report = encode_decoder_report(final, self.sample.spec)
            self._merge_rg_metadata(sample_report)
            report["sample"] = sample_report
        if self.molecular:
            report["molecular"] = [
                encode_decoder_report(r.accumulator.finalize(), r.spec)
                for r in self.molecular
            ]
        if self.cellular:
            report["cellular"] = [
                encode_decoder_report(r.accumulator.finalize(), r.spec)
                for r in self.cellular
            ]
        if self.channel_quality is not None:
            report["multiplex"] = [
                accumulator.encode() for accumulator in self.channel_quality
            ]
        from ..config.jsonkit import clean_json_object, sort_json

        return sort_json(clean_json_object(report))

    def _merge_rg_metadata(self, sample_report: dict):
        """Attach read-group metadata to the sample report entries
        (reference transcode.cpp:1840-1858)."""
        from ..io.sam import RG_FIELD_ORDER, rg_atoms_from_decoder

        sample = self.ontology.get("sample")
        if not isinstance(sample, dict):
            return
        atoms = rg_atoms_from_decoder(sample)
        if not atoms:
            return
        unclassified = sample_report.get("unclassified")
        if unclassified is None:
            return
        for key in RG_FIELD_ORDER:
            value = atoms[0].get(key)
            if value not in (None, ""):
                unclassified[key] = value
        for entry in sample_report.get("classified", []):
            position = int(entry["index"])
            if position < len(atoms):
                for key in RG_FIELD_ORDER:
                    value = atoms[position].get(key)
                    if value not in (None, ""):
                        entry[key] = value
