"""The device (accelerator) execution engine.

Same host pipeline as the strict engine — feeds, template assembly, SAM
emission, accumulators, report — but classification runs on the
accelerator through the jitted decode step (`pheniqs_tpu.device.step`):
the whole classifier chain (sample, molecular*, cellular*) executes as one
XLA program per batch, in f32, with the likelihood as one matrix product.

Fidelity contract (``--fidelity fast``): classification *decisions*
(barcode assignment, qcfail, filter branches) agree with the strict f64
engine except for reads whose posterior sits within f32 rounding of a
filter threshold; confidences/report statistics are f32-accurate.
The two deliberate semantic divergences from the reference's serial quirks:
no observation-scratch carry for reads shorter than the decoder token
(reference sequence.h:61-67 reads stale buffer bytes there), padding
positions instead contribute nothing (NUL convention).

Batches are padded to a fixed shape signature (batch-size bucket, segment
widths rounded up) so the step compiles once and is reused for the whole
stream.
"""

from __future__ import annotations

import os

import numpy as np

from ..decode.oracle import ClassifyResult
from ..model.batch import ReadBatch
from .strict import ClassifierRuntime, StrictEngine


def _round_up(value: int, multiple: int) -> int:
    return -(-value // multiple) * multiple


def enable_compilation_cache():
    """Persistent XLA compilation cache for accelerator programs.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise accelerator programs cache in the checkout's
    fixed ``.jax_cache`` (device/aot.CHECKOUT_CACHE): the path is part of
    the cache key, so it must not move between runs.

    The CPU backend (the test backend) keeps the cache off: its entries
    are serialized XLA:CPU executables with the compile machine's LLVM
    feature set baked in, and loading one prints the cpu_aot_loader
    feature warning even on the same host, while CPU compiles of these
    programs take seconds."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.default_backend() == "cpu":
        return
    from ..device.aot import CHECKOUT_CACHE

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


class DeviceEngine(StrictEngine):
    """Accelerator classification engine.

    ``hybrid=True`` adds float64 re-resolution: the device step flags reads
    whose f32 posterior lies within rounding distance of an argmax tie or a
    filter threshold (plus reads with observations shorter than the decoder
    token, whose strict semantics depend on the serial scratch carry); those
    rows are re-classified with the exact NumPy oracle, guaranteeing
    reference-identical classification decisions at device throughput.
    """

    def __init__(self, ontology: dict, hybrid: bool = False):
        super().__init__(ontology)
        from ..device.instrument import compile_instrument

        enable_compilation_cache()
        self.hybrid = hybrid
        self.instrument = compile_instrument(ontology)
        # classify order must match device.instrument.compile_instrument:
        # sample, molecular*, cellular* (reference transcode.h:51-65)
        self._runtimes: list[ClassifierRuntime] = []
        if self.sample is not None:
            self._runtimes.append(self.sample)
        self._runtimes.extend(self.molecular)
        self._runtimes.extend(self.cellular)
        self._step_cache: dict[tuple, object] = {}
        self._pad_bucket: int | None = None
        self._width_buckets: list[int] | None = None
        self._mesh_cache = None
        self._current_batch: ReadBatch | None = None
        self._batch_results: list[dict] | None = None
        self._predispatched = None
        # rotating staging buffer sets: packing now runs on the ingest
        # thread up to the prefetch-queue depth (4) ahead of dispatch, and
        # D dispatched batches may still back in-flight transfers (jax can
        # alias host memory on CPU), so keep D + 4 + 2 buffers per shape
        self._staging: dict[tuple, list] = {}
        self._staging_flip = 0
        self._tp = False
        self._tp_shards = None
        self._staging_sets = (
            max(1, int(os.environ.get("PHENIQS_LOOKAHEAD", "4"))) + 6
        )
        # wire v3 quality codebook (device/step.py): sensed from the first
        # batch; lossy rows re-resolve via the f64 oracle, so the codebook
        # wire is hybrid-only unless PHENIQS_QUAL_WIRE forces it
        self._qual_bits = 6
        self._qcb = None
        self._ccb = None
        self._qual_lut = None
        self._qcb_device = None
        self._ccb_device = None
        self._qual_sensed = False

    # --- device dispatch -------------------------------------------------
    def _mesh(self):
        """Data-parallel mesh over this process's addressable devices (>1),
        else None. PHENIQS_TP="R:P" builds a 2-D (reads, panel) mesh
        instead: reads data-parallel over R, large PAMLD panels sharded
        over P (barcode-axis tensor parallelism, device/tp.py). Under
        jax.distributed each host runs its own engine over its input
        slice (PHENIQS_SHARD), so the mesh stays local."""
        if self._mesh_cache is not None:
            return self._mesh_cache or None
        import jax

        devices = jax.local_devices()
        limit = self.ontology.get("devices")
        if limit is not None and int(limit) > 0:
            devices = devices[: int(limit)]
        tp = os.environ.get("PHENIQS_TP")
        if tp:
            reads_size, panel_size = (int(x) for x in tp.split(":"))
            from ..device.tp import tp_mesh

            self._tp = True
            self._mesh_cache = tp_mesh(reads_size, panel_size, devices)
        elif len(devices) > 1:
            from ..device.distributed import reads_mesh

            self._mesh_cache = reads_mesh(devices)
        else:
            self._mesh_cache = False
        return self._mesh_cache or None

    def _get_step(self, signature: tuple):
        step = self._step_cache.get(signature)
        if step is None:
            import jax
            import jax.numpy as jnp

            from ..device.step import make_decode_step, make_sharded_decode_step

            widths = list(signature[1])
            qual_bits = signature[2] if len(signature) > 2 else 6
            mesh = self._mesh()
            if mesh is not None and getattr(self, "_tp", False):
                from ..device.step import make_tp_sharded_decode_step

                threshold = int(
                    os.environ.get("PHENIQS_TP_THRESHOLD", 1 << 14)
                )
                step, shard_panels, positions = make_tp_sharded_decode_step(
                    self.instrument,
                    mesh,
                    want_uncertain=self.hybrid,
                    want_counters=True,
                    pack_outputs=True,
                    h2d_widths=widths,
                    shard_threshold=threshold,
                    qual_bits=qual_bits,
                )
                if self._tp_shards is None:
                    self._tp_shards = shard_panels()
                shards = self._tp_shards
                step = (lambda inner: (lambda batch: inner(batch, shards)))(
                    step
                )
            elif mesh is not None:
                step = make_sharded_decode_step(
                    self.instrument,
                    mesh,
                    want_uncertain=self.hybrid,
                    want_counters=True,
                    pack_outputs=True,
                    h2d_widths=widths,
                    qual_bits=qual_bits,
                )
            else:
                from ..device.aot import aot_jit
                from ..device.step import h2d_blob_bytes

                specs = {
                    "blob": jax.ShapeDtypeStruct(
                        (signature[0], h2d_blob_bytes(widths, qual_bits)),
                        jnp.uint8,
                    )
                }
                if qual_bits != 6:
                    specs["qcb"] = jax.ShapeDtypeStruct(
                        (len(self._qcb),), jnp.int32
                    )
                    if getattr(self, "_ccb", None) is not None:
                        specs["ccb"] = jax.ShapeDtypeStruct(
                            (len(self._ccb),), jnp.int32
                        )
                # stable-key AOT store: a source edit that shifts line
                # numbers no longer re-keys the program (device/aot.py)
                step = aot_jit(
                    make_decode_step(
                        self.instrument,
                        want_uncertain=self.hybrid,
                        want_counters=True,
                        pack_outputs=True,
                        h2d_widths=widths,
                        qual_bits=qual_bits,
                    ),
                    specs,
                    label="decode",
                )
            self._step_cache[signature] = step
        return step

    def _sense_qual_wire(self, used):
        """Pick the wire regime (device/step.py wire v3) from the first
        batch's within-length alphabet. Modern binned basecallers emit
        <=16 distinct (base, quality) pairs (NovaSeq RTA3: {A,C,G,T} x
        {12,23,37} + (N,2)), so both lanes collapse into one 4-bit joint
        lane; a rich quality alphabet over few values rides a 2/4-bit
        quality lane; Sanger-scale data keeps the lossless 6-bit layout.
        Later reads outside the sensed codebook are packed nearest +
        H2D_FORCED, which the hybrid engine re-resolves in exact f64 — so
        the codebook wire is restricted to hybrid mode unless
        PHENIQS_QUAL_WIRE forces it."""
        self._qual_sensed = True
        mode = os.environ.get("PHENIQS_QUAL_WIRE", "auto")
        if mode not in ("auto", "j4", "2", "4", "6"):
            mode = "auto"
        if mode == "auto" and not self.hybrid:
            return  # fast mode never re-resolves forced rows: stay lossless
        from ..device.step import (
            JOINT4,
            sense_joint_codebook,
            sense_qual_codebook,
        )

        values = []
        pair_sets = []
        for code, qual, length in (
            (s.code, s.quality, s.length) for s in used
        ):
            code = np.asarray(code)
            qual = np.asarray(qual)
            keys = (code.astype(np.int64) & 15) << 8 | np.minimum(
                qual.astype(np.int64), 63
            )
            mask = (
                np.arange(qual.shape[1], dtype=np.int32)[None, :]
                < np.asarray(length, dtype=np.int32)[:, None]
            )
            if mask.all():
                values.append(np.unique(qual))
                pair_sets.append(np.unique(keys))
            else:
                values.append(np.unique(qual[mask]))
                pair_sets.append(np.unique(keys[mask]))
        values = np.unique(np.concatenate(values)) if values else np.empty(0)
        pairs = (
            np.unique(np.concatenate(pair_sets))
            if pair_sets
            else np.empty(0, dtype=np.int64)
        )
        if mode in ("auto", "j4"):
            joint = sense_joint_codebook(pairs)
            if joint is not None:
                ccb, qcb, lut_idx, lut_exact = joint
                self._qual_bits = JOINT4
                self._ccb = ccb
                self._qcb = qcb
                self._qual_lut = (lut_idx, lut_exact)
                if os.environ.get("PHENIQS_TRACE") == "1":
                    import sys as sys_mod

                    sys_mod.stderr.write(
                        "[pheniqs-tpu] quality wire: joint 4-bit pair "
                        f"codebook ({np.unique(pairs).size} pairs)\n"
                    )
                return
            if mode == "j4":
                return  # forced joint but alphabet too rich: stay 6-bit
        qual_bits, qcb, lut_idx, lut_exact = sense_qual_codebook(values, mode)
        self._qual_bits = qual_bits
        if qual_bits != 6:
            self._qcb = qcb
            self._qual_lut = (lut_idx, lut_exact)
            if os.environ.get("PHENIQS_TRACE") == "1":
                import sys as sys_mod

                sys_mod.stderr.write(
                    f"[pheniqs-tpu] quality wire: {qual_bits}-bit codebook "
                    f"{sorted(set(int(x) for x in qcb))}\n"
                )

    def _wire_batch(self, device_blob):
        """The step's input dict for one device-resident blob (adds the
        replicated codebooks under wire v3)."""
        if self._qual_bits == 6:
            return {"blob": device_blob}
        if self._qcb_device is None:
            import jax.numpy as jnp

            self._qcb_device = jnp.asarray(self._qcb)
            if getattr(self, "_ccb", None) is not None:
                self._ccb_device = jnp.asarray(self._ccb)
        batch = {"blob": device_blob, "qcb": self._qcb_device}
        if getattr(self, "_ccb", None) is not None:
            batch["ccb"] = self._ccb_device
        return batch

    def _device_batch(self, batch: ReadBatch):
        """Pad to a stable shape signature and ship to device."""
        signature, blob = self._pack_batch(batch)
        return signature, self._wire_batch(self._put_blob(blob))

    def _put_blob(self, blob):
        """Ship one packed host blob to the device(s). Under a mesh the
        blob is placed sharded over the ``reads`` axis, so each card
        receives only its own rows instead of the whole batch staging
        through the first card."""
        import jax
        import jax.numpy as jnp

        mesh = self._mesh()
        if mesh is None:
            return jnp.asarray(blob)
        from jax.sharding import NamedSharding, PartitionSpec

        device_blob = jax.device_put(
            blob, NamedSharding(mesh, PartitionSpec("reads"))
        )
        if not getattr(self, "_placement_traced", False):
            self._placement_traced = True
            if os.environ.get("PHENIQS_TRACE") == "1":
                import sys as sys_mod

                shards = device_blob.addressable_shards
                rows = sorted({shard.data.shape[0] for shard in shards})
                sys_mod.stderr.write(
                    "[pheniqs-tpu] h2d placement:"
                    f" shards={len(shards)}"
                    f" rows={','.join(map(str, rows))}"
                    f" batch={blob.shape[0]}\n"
                )
        return device_blob

    def _pack_batch(self, batch: ReadBatch):
        """Pack the batch into the uint8 wire blob at a stable shape
        signature (host-side only — no device work, so it can run on the
        ingest thread ahead of dispatch)."""
        n = batch.size
        padded_n = max(_round_up(n, 1024), 1024)
        mesh = self._mesh()
        if mesh is not None:
            padded_n = _round_up(padded_n, mesh.devices.size)
        # pin the batch-size bucket after the first (full) batch so the last
        # partial batch reuses the compiled executable instead of paying a
        # fresh XLA compile for a smaller shape
        if self._pad_bucket is None or padded_n > self._pad_bucket:
            self._pad_bucket = padded_n
        padded_n = self._pad_bucket
        widths = []
        if self._width_buckets is None:
            self._width_buckets = [0] * len(self.instrument.used_segments)
        for position, segment_index in enumerate(self.instrument.used_segments):
            segment = batch.segments[segment_index]
            w = _round_up(max(segment.width, 1), 4)
            # sticky width buckets: only grow, so signatures stay stable
            w = max(w, self._width_buckets[position])
            self._width_buckets[position] = w
            widths.append(w)
        used = [
            batch.segments[index] for index in self.instrument.used_segments
        ]
        if not self._qual_sensed:
            self._sense_qual_wire(used)
        signature = (padded_n, tuple(widths), self._qual_bits)
        staging_key = (self._staging_flip, signature)
        self._staging_flip = (self._staging_flip + 1) % self._staging_sets
        from ..device.step import (
            H2D_PAD,
            H2D_QCFAIL,
            h2d_blob_bytes,
            pack_h2d_blob,
        )

        pad_flags = H2D_QCFAIL | H2D_PAD
        blob = self._staging.get(staging_key)
        if blob is None:
            blob = np.zeros(
                (padded_n, h2d_blob_bytes(widths, self._qual_bits)),
                dtype=np.uint8,
            )
            # padding rows arrive qcfail=True and counter-masked
            blob[:, -1] = pad_flags
            self._staging[staging_key] = blob
        # one packed uint8 matrix = ONE host->device transfer per batch
        # (it replaces 3*segments + 1 transfers)
        clock = __import__("time").perf_counter
        mark = clock()
        pack_h2d_blob(
            widths,
            [(s.code, s.quality, s.length) for s in used],
            batch.qcfail,
            out=blob[:n],
            qual_bits=self._qual_bits,
            qual_lut=self._qual_lut,
        )
        if n < padded_n:
            blob[n:] = 0
            blob[n:, -1] = pad_flags
        self._stage_add("pack", clock() - mark)
        return signature, blob

    # --- pipelined execution ---------------------------------------------
    def execute(self, batch_size: int = 16384):
        """One-batch lookahead pipeline: dispatch batch k+1 to the device
        before pulling k's decisions and doing its host work, so transfer
        and decode overlap host processing (the engine analog of the
        reference's feed double-buffering).

        PHENIQS_PROFILE=<dir> wraps the run in a jax.profiler trace —
        device-level observability the reference never had (SURVEY §5)."""
        import time

        profile_dir = os.environ.get("PHENIQS_PROFILE")
        if profile_dir:
            import contextlib

            import jax

            profiler = jax.profiler.trace(profile_dir)
        else:
            import contextlib

            profiler = contextlib.nullcontext()
        with profiler:
            return self._execute_pipeline(batch_size)

    def _prepared_batches(self, batches):
        """Per-batch host preparation, run ahead of the dispatch loop
        (on the ingest thread when prefetch is on): raw accounting counts,
        input filters, wire-blob packing, and worker-slot staging. The
        dispatch/pull loop then touches only the device and the small
        decision arrays."""
        raw_index = -1
        for batch in batches:
            raw_index += 1
            raw_size = batch.size
            raw_pf = int((~batch.qcfail).sum())
            arena = getattr(batch, "_arena", None)
            batch = self._apply_input_filters(batch)
            if arena is not None and getattr(batch, "_arena", None) is not arena:
                # the filters subset the batch (new arrays, copied out of
                # the slot): the zero-copy parse arena goes back to the
                # pool; the filtered batch stages through the copy path
                arena.release()
            batch.raw_index = raw_index
            packed = None
            if batch.size:
                packed = self._pack_batch(batch)
                self._stage_for_workers(batch)
            yield raw_size, raw_pf, batch, packed

    def _stage_for_workers(self, batch: ReadBatch):
        """Hook: the streamed engine pre-writes the batch into a shared
        memory slot here, off the dispatch loop."""

    def _execute_pipeline(self, batch_size: int):
        import collections
        import time

        self._initiate_feeds()
        start = time.perf_counter()
        batches = self.read_batches(batch_size)
        if os.environ.get("PHENIQS_PREFETCH", "1") != "0":
            # two pipelined host stages, each on its own thread: parse
            # (native, GIL-free) | filter + wire-pack + worker staging —
            # so neither serializes behind the other or behind the
            # dispatch/pull loop
            from .strict import _prefetch

            prepared = _prefetch(self._prepared_batches(_prefetch(batches)))
        else:
            prepared = self._prepared_batches(batches)
        # in-flight depth: more than one batch of lookahead hides the
        # transfer and decode latency behind host work; bounded to keep
        # memory finite.
        depth = max(1, int(os.environ.get("PHENIQS_LOOKAHEAD", "4")))
        stages = self._stage_seconds = {
            "ingest_wait": 0.0,
            "stage_dispatch": 0.0,
            "finish": 0.0,
        }
        pending = collections.deque()
        clock = time.perf_counter
        mark = clock()
        iterator = iter(prepared)
        while True:
            try:
                raw_size, raw_pf, batch, packed = next(iterator)
            except StopIteration:
                break
            now = clock()
            stages["ingest_wait"] += now - mark
            mark = now
            # raw accounting happened pre-filter in _prepared_batches so
            # device rows match the filtered batch exactly
            self.incoming_count += raw_size
            self.incoming_pf_count += raw_pf
            if batch.size == 0:
                self._note_skipped_batch(batch.raw_index)
                mark = clock()
                continue
            handles = self._dispatch(batch, packed)
            pending.append((batch, handles))
            now = clock()
            stages["stage_dispatch"] += now - mark
            if len(pending) > depth:
                self._finish(*pending.popleft())
            mark = clock()
            stages["finish"] += mark - now
        while pending:
            now = clock()
            self._finish(*pending.popleft())
            stages["finish"] += clock() - now
        self._close_feeds()
        self._trace_summary(start)

    def _note_skipped_batch(self, raw_index: int):
        """Hook for pipelined consumers tracking the raw batch sequence."""

    def _trace_summary(self, start):
        super()._trace_summary(start)
        resolved = getattr(self, "_resolved_reads", 0)
        if os.environ.get("PHENIQS_TRACE") == "1" and self.hybrid:
            import sys as sys_mod

            fraction = resolved / max(self.incoming_count, 1)
            sys_mod.stderr.write(
                f"[pheniqs-tpu] hybrid f64 re-resolution: {resolved} reads "
                f"({fraction:.3%}) flagged by the derived bound\n"
            )

    def _dispatch(self, batch: ReadBatch, packed=None):
        import time

        if packed is None:
            packed = self._pack_batch(batch)
        signature, blob = packed
        mark = time.perf_counter()
        device_blob = self._put_blob(blob)
        self._stage_add("h2d", time.perf_counter() - mark)
        step = self._get_step(signature)
        handles = step(self._wire_batch(device_blob))
        # start the device->host transfer immediately: by the time the
        # lookahead window drains to this batch the blob is already local
        packed = handles[0]
        blob = packed.get("blob") if isinstance(packed, dict) else None
        for device_array in (blob, handles[1]):
            if device_array is None or isinstance(device_array, list):
                continue
            try:
                device_array.copy_to_host_async()
            except (AttributeError, RuntimeError):
                pass  # sharded global arrays / older jax: pull at finish
        return handles

    def _stage_add(self, key: str, seconds: float):
        """Accumulate a sub-stage duration into the PHENIQS_TRACE pipeline
        breakdown (no-op outside the pipelined execute)."""
        stages = getattr(self, "_stage_seconds", None)
        if stages is not None:
            stages[key] = stages.get(key, 0.0) + seconds

    def _finish(self, batch: ReadBatch, handles):
        self._predispatched = handles
        try:
            self.process_batch(batch, filtered=True)
        finally:
            self._predispatched = None

    def _classify_batch_on_device(self, batch: ReadBatch):
        if self._predispatched is not None:
            packed, counters = self._predispatched
        else:
            signature, device_batch = self._device_batch(batch)
            step = self._get_step(signature)
            packed, counters = step(device_batch)
        n = batch.size
        # one pull: the packed uint8 blob (see step.py d2h_layout)
        from ..device.step import d2h_layout

        layout = d2h_layout(self.instrument, self.hybrid)
        clock = __import__("time").perf_counter
        mark = clock()
        # the device ships the blob flat (dense wire bytes — the 2-D
        # layout pads to lanes and transfers the padding, step.py); the
        # reshape on dense host bytes is free
        blob = np.asarray(packed["blob"]).reshape(-1, layout["total"])[:n]
        self._stage_add("pull_wait", clock() - mark)
        ints = (
            np.ascontiguousarray(blob[:, : layout["int_bytes"]])
            .view(np.int32 if layout["wide"] else np.int16)
            .astype(np.int32)
        )
        floats = (
            np.ascontiguousarray(
                blob[
                    :,
                    layout["float_offset"] : layout["float_offset"]
                    + layout["float_bytes"],
                ]
            )
            .view(np.float32)
            .astype(np.float64)
        )
        qc_bytes = blob[
            :,
            layout["qcfail_offset"] : layout["qcfail_offset"]
            + layout["qcfail_bytes"],
        ]
        decoded_column = {
            position: k
            for k, position in enumerate(layout["decoded_positions"])
        }
        confidence_column = {
            position: k
            for k, position in enumerate(layout["confidence_positions"])
        }
        results = []
        for k in range(len(self.instrument.decoders)):
            zeros = np.zeros(n, dtype=np.int32)
            result = {
                "decoded": (
                    ints[:, decoded_column[k]]
                    if k in decoded_column
                    else zeros
                ),
                "confidence": (
                    floats[:, confidence_column[k]]
                    if k in confidence_column
                    else np.zeros(n, dtype=np.float64)
                ),
                "qcfail": ((qc_bytes[:, k >> 3] >> (k & 7)) & 1).astype(bool),
            }
            results.append(result)

        # device-side statistics: merge the masked counter deltas straight
        # into the runtime accumulators (the psum'd analog of the
        # reference's thread-local collect, transcode.cpp:317-320);
        # hybrid-uncertain rows were excluded on device and are recorded
        # host-side from the oracle in _run_classifier
        self._merge_device_counters(counters)

        if self.hybrid:
            uncertain = blob[:, layout["uncertain_offset"]].astype(bool)
            self._batch_rows = np.flatnonzero(uncertain)
            self._rows_qcfail = batch.qcfail[self._batch_rows].copy()
            self._resolved_reads = (
                getattr(self, "_resolved_reads", 0) + self._batch_rows.size
            )
            # a runaway re-resolution rate silently degrades hybrid to
            # strict-engine throughput (an inaccurate device transcendental
            # widens the bound window until it swallows the whole
            # confidence distribution) — warn loudly instead of quietly
            # crawling
            self._hybrid_seen = getattr(self, "_hybrid_seen", 0) + batch.size
            if (
                not getattr(self, "_hybrid_rate_warned", False)
                and self._hybrid_seen >= 1 << 19
                and self._resolved_reads > 0.2 * self._hybrid_seen
            ):
                self._hybrid_rate_warned = True
                import sys as sys_mod

                sys_mod.stderr.write(
                    "[pheniqs-tpu] WARNING: hybrid f64 re-resolution rate "
                    f"is {self._resolved_reads / self._hybrid_seen:.1%}; "
                    "the f32 error bound is flagging most reads and "
                    "throughput degrades toward the strict engine — check "
                    "device numerics (PHENIQS_TPQ / "
                    "PHENIQS_MATMUL_PRECISION)\n"
                )
        else:
            self._batch_rows = np.empty(0, dtype=np.int64)
            self._rows_qcfail = np.empty(0, dtype=bool)
        return results

    def _merge_device_counters(self, counters):
        """Split the flattened device counter vector (one D2H array per
        batch — see step.counter_layout) into the accumulators."""
        from ..device.step import counter_layout

        clock = __import__("time").perf_counter
        mark = clock()
        flat = np.asarray(counters)
        self._stage_add("counter_pull", clock() - mark)
        offset = 0
        for position, name, size in counter_layout(self.instrument):
            value = flat[offset : offset + size]
            offset += size
            acc = self._runtimes[position].accumulator
            target = getattr(acc, name)
            if target.dtype == np.float64:
                target += value.astype(np.float64)
            else:
                target += np.rint(value).astype(np.int64)

    # --- StrictEngine hook ----------------------------------------------
    def _run_classifier(self, runtime, batch, qcfail):
        from ..decode.oracle import BRANCH_PASS

        if self._current_batch is not batch:
            self._batch_results = self._classify_batch_on_device(batch)
            self._current_batch = batch
        position = self._runtimes.index(runtime)
        device = self._batch_results[position]
        spec = runtime.spec

        observation = []
        if spec.rule is not None and spec.algorithm != "passthrough":
            clock = __import__("time").perf_counter
            mark = clock()
            # the full observation gather is only consumed by local render
            # (the render workers recompute it from shared memory) and by
            # the f64 oracle for flagged rows; when neither applies, the
            # only surviving need is the PAMLD scratch carry — and a batch
            # with zero flagged rows has no short observation (short rows
            # are always flagged uncertain, step.py), so the carry-out is
            # the LAST read's observation alone
            if getattr(self, "_render_local", True) or (
                self.hybrid and self._batch_rows.size > 0
            ):
                observation = spec.rule.apply(batch.segments)
            elif (
                self.hybrid
                and spec.algorithm == "pamld"
                and runtime.scratch is not None
            ):
                from ..transform import SegmentBatch

                tail = [
                    SegmentBatch(
                        code=s.code[-1:],
                        quality=s.quality[-1:],
                        length=s.length[-1:],
                    )
                    for s in batch.segments
                ]
                for j, segment in enumerate(spec.rule.apply(tail)):
                    runtime.scratch.effective(j, segment)
            self._stage_add("host_rules", clock() - mark)

        # this decoder's own qcfail contribution: device chain delta
        previous = (
            self._batch_results[position - 1]["qcfail"]
            if position > 0
            else batch.qcfail
        )
        delta = device["qcfail"] & ~previous

        n = batch.size
        decoded = device["decoded"].astype(np.int32)
        confidence = device["confidence"].copy()
        # distance/argmax/branch live on device only (they feed the
        # counters, computed there); host arrays are filled for the
        # oracle-resolved rows alone
        distance = np.zeros(n, dtype=np.int32)
        branch = np.full(n, BRANCH_PASS, dtype=np.int8)
        argmax = np.zeros(n, dtype=np.int32)
        out_qcfail = qcfail | delta

        if self.hybrid:
            self._resolve_rows(
                runtime, observation,
                decoded, confidence, distance, branch, argmax, out_qcfail,
            )

        result = ClassifyResult(
            decoded=decoded,
            confidence=confidence,
            edit_distance=distance,
            qcfail=out_qcfail,
            branch=branch,
            argmax=argmax,
            observation=observation,
        )
        # statistics for device-resolved rows were merged from the device
        # counters at pull time; only oracle-resolved rows record here
        return result

    def _resolve_rows(
        self, runtime, observation,
        decoded, confidence, distance, branch, argmax, out_qcfail,
    ):
        """Re-resolve the flagged rows of this batch with the exact float64
        oracle and record their statistics host-side (the device counters
        excluded them). The chained qcfail for the flagged rows threads
        through ``self._rows_qcfail`` decoder by decoder."""
        from ..decode.oracle import (
            BRANCH_PASS,
            mdd_classify,
            pamld_classify,
        )
        from ..transform import SegmentBatch

        spec = runtime.spec
        rows = self._batch_rows

        if spec.algorithm == "pamld" and runtime.scratch is not None:
            # scratch carry is serial state: advance it on EVERY batch,
            # even when no rows are flagged
            clock = __import__("time").perf_counter
            mark = clock()
            eff_codes = []
            eff_quals = []
            for segment_index, segment in enumerate(observation):
                code, qual = runtime.scratch.effective(segment_index, segment)
                eff_codes.append(code)
                eff_quals.append(qual)
            self._stage_add("scratch", clock() - mark)
            if rows.size == 0:
                return
            obs_code = np.concatenate([c[rows] for c in eff_codes], axis=1)
            obs_qual = np.concatenate([q[rows] for q in eff_quals], axis=1)
            oracle = pamld_classify(spec, obs_code, obs_qual, self._rows_qcfail)
        elif rows.size == 0:
            return
        elif spec.algorithm == "mdd":
            sub_observation = [
                SegmentBatch(
                    code=segment.code[rows],
                    quality=segment.quality[rows],
                    length=segment.length[rows],
                )
                for segment in observation
            ]
            oracle = mdd_classify(spec, sub_observation, self._rows_qcfail)
        else:
            # naive / passthrough: decoded stays 0, qcfail passes through
            oracle = ClassifyResult(
                decoded=np.zeros(rows.size, dtype=np.int32),
                confidence=np.zeros(rows.size, dtype=np.float64),
                edit_distance=np.zeros(rows.size, dtype=np.int32),
                qcfail=self._rows_qcfail.copy(),
                branch=np.full(rows.size, BRANCH_PASS, dtype=np.int8),
                argmax=np.zeros(rows.size, dtype=np.int32),
            )

        decoded[rows] = oracle.decoded
        confidence[rows] = oracle.confidence
        distance[rows] = oracle.edit_distance
        branch[rows] = oracle.branch
        argmax[rows] = oracle.argmax
        out_qcfail[rows] = oracle.qcfail
        self._rows_qcfail = oracle.qcfail.copy()
        runtime.record(oracle)


class StreamedDeviceEngine(DeviceEngine):
    """Device classification + multiprocess render fan-out.

    The production topology: the parent owns ingest, device dispatch
    (one-batch lookahead), decision pull, hybrid f64 re-resolution and
    statistics; N render workers own template/tag/format work; the writer
    thread streams ordered chunks to the feeds (engine.stream). This keeps
    the device fed at device rate instead of serializing behind host
    rendering — the role the reference's decoding-thread pool plays for
    its CPU pipeline (reference transcode.cpp:1776-1795).
    """

    # statistics are parent-owned (device counters + oracle rows): ship
    # workers only the arrays render consumes (engine/stream.py)
    _payload_fields = ("decoded", "confidence", "qcfail")

    def __init__(self, ontology: dict, hybrid: bool = False, workers: int = 2):
        super().__init__(ontology, hybrid=hybrid)
        self.workers = workers
        self._runner = None
        # render workers recompute observation gathers from shared memory;
        # the parent skips them (and the _classify_batch back-fill)
        self._render_local = False

    def execute(self, batch_size: int = 16384):
        from .stream import StreamRunner

        self._runner = StreamRunner(self, self.workers, batch_size)
        self._runner.start()
        try:
            return super().execute(batch_size)
        except BaseException:
            if self._runner is not None:
                self._runner.abort()
                self._runner = None
            raise

    def _note_skipped_batch(self, raw_index: int):
        self._runner.submit_skip(raw_index)

    def _parse_arena_provider(self, estimate: int):
        """Zero-copy staging: hand the native parser a shared-memory slot
        to write batch matrices into (engine/shm.py SlotArena), deleting
        the stage-time memcpy the round-4 trace measured at 1.9 us/read
        under 4-core contention."""
        runner = self._runner
        if runner is None:
            return None
        return runner.acquire_parse_arena(estimate)

    def _stage_for_workers(self, batch):
        # pre-write the batch into a shared-memory slot from the ingest
        # thread: the submit after classification then appends only the
        # decision arrays (engine/stream.py StreamRunner.stage)
        if self._runner is not None:
            self._runner.stage(batch)

    def _consume_classified(self, batch, results):
        clock = __import__("time").perf_counter
        mark = clock()
        self._runner.submit(batch, results)
        self._stage_add("submit", clock() - mark)

    def _close_feeds(self):
        if self._runner is not None:
            self._runner.finish()
            self._runner = None
        super()._close_feeds()
