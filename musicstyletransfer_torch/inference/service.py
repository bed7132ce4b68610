"""Multi-style micro-batched transfer service (counterpart of
``musicstyletransfer_tpu/inference/service.py``).

Requests (MIDI bytes or token arrays) are collected into micro-batches,
filled up to ``batch_size`` or flushed after ``max_wait_ms``, and each
micro-batch is one encode and one launch of K1 (``ops/fused_decode.py``)
through ``style_transfer_all_classes``: every request into every target
class, at the smallest length bucket that covers the batch's longest
request, with a generation budget of 2 * (bucket + 1).

The JAX package pads a partial batch with its first request, so that every
call has one static shape (the TPU's idiom). K1 takes any row count, so the
port decodes only the real rows: a batch of n requests is n * C rows.

With a ``mesh`` (``parallel/mesh.py``, one process per card) each
micro-batch is one ``sharded_style_transfer_all_classes`` call: its rows are
split over the data axis, each data rank decodes its share (one K1 launch on
the card) and the rows are gathered back. The primary rank owns the queue,
the callbacks, tokenizing and detokenizing; for each micro-batch it
broadcasts a header (rows, bucket, the batch's seed, or stop) and the
padded tokens and lengths over the world, and every rank then makes the
sharded call. The other ranks run ``serve_follower`` (``start`` runs it on a
thread there) until the primary's ``stop`` sends the stop header.

Programmatic use:

    svc = StyleTransferService(model_folder, checkpoint=-1)
    results = svc.submit_midi(midi_bytes)      # blocking convenience call
    # or svc.start(); svc.enqueue(...); svc.stop() for the threaded loop

CLI (one-shot directory mode):
    python -m musicstyletransfer_torch.cli.serve --model-output m/ \\
        --in-dir midis/ --out-samples out/
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import tracing
from ..midi import native_writer, smf
from ..midi.codec import MelodyWriter, melody_from_ids, tokenize_track
from ..midi.vocab import PAD_ID, SOS_ID, note_on_id
from ..parallel.mesh import mesh_device
from .decode import style_transfer_all_classes
from .sampler import load_inference_model
from .sharded import prepare_params, sharded_style_transfer_all_classes

_logger = logging.getLogger(__name__)


def use_card(device: torch.device) -> None:
    """Make ``device`` this thread's current card where it names one (a
    mesh's ``cuda:N``: NCCL's calls on a thread that did not set it would go
    to card 0); a bare ``cuda`` is the current card already."""
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)


def to_signed(value: int) -> int:
    """A 64-bit unsigned value as the int64 that holds its bits."""
    value &= (1 << 64) - 1
    return value - (1 << 64) if value >= 1 << 63 else value


@dataclasses.dataclass
class TransferResult:
    """Per-request result: one output MIDI per target class."""

    midi_by_class: Dict[int, bytes]
    tokens_by_class: Dict[int, np.ndarray]


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile of an ascending list (p in [0, 100]): the
    1-based rank ceil(p * N / 100)."""
    if not sorted_vals:
        return 0.0
    rank = math.ceil(p / 100.0 * len(sorted_vals))
    return sorted_vals[min(len(sorted_vals) - 1, max(0, rank - 1))]


class ServiceStats:
    """Thread-safe serving counters: request latency (enqueue -> callback),
    batch fill and queue depth at batch formation. Latency samples ride a
    bounded deque, so a long-lived service never grows host memory."""

    def __init__(self, max_samples: int = 65536):
        self._lock = threading.Lock()
        self._latencies_ms = collections.deque(maxlen=max_samples)
        self._batch_fills = collections.deque(maxlen=max_samples)
        self._served = 0
        self._batches = 0
        self._max_queue_depth = 0
        self._batch_errors = 0
        self._shed = 0

    def record_error(self) -> None:
        with self._lock:
            self._batch_errors += 1

    def record_shed(self) -> None:
        """A request rejected at admission by a bounded-queue engine
        (``streaming.EngineOverloaded``), counted apart from served requests
        and batch errors."""
        with self._lock:
            self._shed += 1

    def record_batch(self, fill: int, queue_depth_after: int,
                     latencies_ms: List[float],
                     served: Optional[int] = None) -> None:
        """``served`` defaults to ``fill`` (the micro-batch loop: every row
        completes). The streaming engine passes it: there ``fill`` is slot
        occupancy, and only requests whose last unit finished count."""
        with self._lock:
            self._batches += 1
            self._served += fill if served is None else served
            self._batch_fills.append(fill)
            self._latencies_ms.extend(latencies_ms)
            self._max_queue_depth = max(self._max_queue_depth, queue_depth_after)

    def snapshot(self) -> Dict[str, float]:
        """Requests served, batches, mean fill, queue-depth high-water mark,
        p50/p99/max request latency (ms). Safe to call while serving."""
        with self._lock:
            lat = sorted(self._latencies_ms)
            fills = list(self._batch_fills)
            served, batches = self._served, self._batches
            depth, errors, shed = self._max_queue_depth, self._batch_errors, self._shed
        return {
            "requests_served": served,
            "batches": batches,
            "batch_errors": errors,
            "requests_shed": shed,
            "mean_batch_fill": (sum(fills) / len(fills)) if fills else 0.0,
            "max_queue_depth": depth,
            "latency_p50_ms": _percentile(lat, 50),
            "latency_p99_ms": _percentile(lat, 99),
            "latency_max_ms": lat[-1] if lat else 0.0,
        }


def tokens_from_midi(midi_bytes: bytes, max_seq_len: int) -> np.ndarray:
    """The first track with note events, tokenized and cut to max_seq_len."""
    mf = smf.parse_midifile(midi_bytes)
    for track in mf.tracks:
        toks = tokenize_track(track)
        if len(toks):
            return toks[:max_seq_len]
    raise ValueError("no note events in MIDI request")


def results_of(rows: List[Dict[int, np.ndarray]],
               writer: MelodyWriter) -> List[TransferResult]:
    """A ``TransferResult`` a request from each class's generated token row,
    each phase over all the requests at once, so that it is one span. The
    MIDI of every row is written in one call of the native writer
    (``midi/native_writer.py``) where its library loads, else with
    ``writer``; ``results_of.native_rows`` and ``results_of.python_rows``
    count the rows written each way."""
    if native_writer.load_library() is None:
        _count_rows("python_rows", sum(len(r) for r in rows))
        return _results_in_python(rows, writer)
    flat = [row for r in rows for row in r.values()]
    with tracing.span("service.detokenize"):
        tokens, offsets = native_writer.pack(flat)
        ids = native_writer.event_ids(tokens, offsets)
    with tracing.span("service.midi_write"):
        midi = native_writer.write_midi(tokens, offsets)
    _count_rows("native_rows", len(flat))
    out, k = [], 0
    for r in rows:
        out.append(TransferResult(dict(zip(r, midi[k:k + len(r)])),
                                  dict(zip(r, ids[k:k + len(r)]))))
        k += len(r)
    return out


results_of.native_rows = 0
results_of.python_rows = 0
_counts_lock = threading.Lock()


def _count_rows(counter: str, rows: int) -> None:
    """Add to a counter of ``results_of``: it may run on several threads."""
    with _counts_lock:
        setattr(results_of, counter, getattr(results_of, counter) + rows)


def _results_in_python(rows: List[Dict[int, np.ndarray]],
                       writer: MelodyWriter) -> List[TransferResult]:
    """``results_of`` through ``melody_from_ids`` and ``writer``."""
    with tracing.span("service.detokenize"):
        melodies = [{c: melody_from_ids(row) for c, row in r.items()} for r in rows]
    with tracing.span("service.midi_write"):
        midi = [{c: smf.dump_midifile(writer.to_midifile(m)) for c, m in ms.items()}
                for ms in melodies]
    return [TransferResult(mid, {c: m.tokens for c, m in ms.items()})
            for mid, ms in zip(midi, melodies)]


class StyleTransferService:
    def __init__(
        self,
        model_folder: str,
        checkpoint: Optional[int] = -1,
        batch_size: int = 32,
        max_seq_len: int = 64,
        max_wait_ms: float = 10.0,
        seed: int = 0,
        mesh=None,
        buckets: Optional[List[int]] = None,
        device: Optional[torch.device] = None,
        greedy: bool = False,
    ):
        """``buckets``: ascending sequence-length buckets; each micro-batch
        runs at the smallest bucket >= its longest request, with a
        generation budget of 2 * (bucket + 1). The largest must equal
        ``max_seq_len``. None serves every batch at ``max_seq_len``.

        ``seed``: each micro-batch's K1 Philox key is the seed in the high
        32 bits and a counter, taken under a lock, in the low ones; under a
        ``mesh`` that value seeds the generator the data shards' keys are
        drawn from (``inference/sharded.py``).

        ``mesh``: serve every micro-batch sharded over its data axis (the
        module docstring); every rank constructs the service alike.

        ``device``: where the model runs; None is the mesh's device, else
        CUDA, raising without a card (``utils.resolve_device``).

        ``greedy``: decode the argmax instead of sampling (the port's; the
        JAX service samples)."""
        self.mesh = mesh
        self.device = mesh_device(mesh, device)
        self.model = load_inference_model(model_folder, checkpoint, self.device)
        if mesh is not None:
            prepare_params(self.model, mesh)
        self.greedy = bool(greedy)
        self.num_classes = self.model.config.decoder_config.num_classes
        self.batch_size = batch_size
        self.max_seq_len = max_seq_len
        self.max_wait_ms = max_wait_ms
        if buckets:
            bl = sorted(set(int(b) for b in buckets))
            if bl[-1] != max_seq_len:
                raise ValueError(
                    f"largest bucket ({bl[-1]}) must equal max_seq_len ({max_seq_len})")
            self.buckets = bl
        else:
            self.buckets = [max_seq_len]
        self._seed = int(seed)
        self._batches_issued = 0
        # The threaded loop and direct transfer_tokens/submit_midi callers
        # may run at once; the counter must not race.
        self._seed_lock = threading.Lock()
        self.stats = ServiceStats()
        self._writer = MelodyWriter()
        self._queue: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # Under a mesh the primary's micro-batches (the loop's and direct
        # callers') go out one at a time: every rank must see the same
        # sequence of broadcasts.
        self._mesh_lock = threading.Lock()
        self._stopped = False

    @property
    def is_primary(self) -> bool:
        return self.mesh is None or self.mesh.is_primary

    # -- request preparation -------------------------------------------

    def _tokens_from_midi(self, midi_bytes: bytes) -> np.ndarray:
        return tokens_from_midi(midi_bytes, self.max_seq_len)

    def _pick_bucket(self, token_lists: List[np.ndarray]) -> int:
        """Smallest bucket covering the longest request in this batch."""
        longest = max(min(len(t), self.max_seq_len) for t in token_lists)
        for b in self.buckets:
            if b >= longest:
                return b
        return self.buckets[-1]

    def _make_batch(self, token_lists: List[np.ndarray], L: int):
        """SOS-prefixed [n, L+1] tokens and [n] lengths of the n requests
        (no padding rows: K1 takes any row count)."""
        n = len(token_lists)
        tokens = np.full((n, L + 1), PAD_ID, np.int64)
        tokens[:, 0] = SOS_ID
        seq_lens = np.ones((n,), np.int64)
        for i, toks in enumerate(token_lists):
            m = min(len(toks), L)
            tokens[i, 1:m + 1] = toks[:m]
            seq_lens[i] = m + 1
        return tokens, seq_lens

    def _next_seed(self) -> int:
        with self._seed_lock:
            self._batches_issued += 1
            return ((self._seed & 0xFFFFFFFF) << 32) | (self._batches_issued & 0xFFFFFFFF)

    # -- core fused call ------------------------------------------------

    def transfer_tokens(self, token_lists: List[np.ndarray]) -> List[TransferResult]:
        """Run one micro-batch; returns a result per request."""
        return self._finish(self._dispatch(token_lists), len(token_lists))

    def _dispatch(self, token_lists: List[np.ndarray]) -> torch.Tensor:
        """Issue the encode and K1 launch without waiting for them: returns
        the device tensor of sequences [C, n, 2 * (bucket + 1)]; ``_finish``
        copies it to the host and detokenizes."""
        if not 0 < len(token_lists) <= self.batch_size:
            raise ValueError(f"{len(token_lists)} requests for a batch of {self.batch_size}")
        with tracing.span("service.dispatch"):
            with tracing.span("service.batch"):
                bucket = self._pick_bucket(token_lists)
                tokens, seq_lens = self._make_batch(token_lists, bucket)
            if self.mesh is not None:
                if not self.is_primary:
                    raise RuntimeError("only the mesh's primary rank takes requests; the "
                                       "others run serve_follower()")
                with self._mesh_lock:
                    if self._stopped:
                        raise RuntimeError("the sharded service was stopped")
                    packed = np.concatenate([tokens, seq_lens[:, None]], axis=1)
                    return self._sharded(*self._broadcast(
                        len(token_lists), bucket, self._next_seed(), packed))
            seqs, _scores = style_transfer_all_classes(
                self.model,
                torch.as_tensor(tokens, device=self.device),
                torch.as_tensor(seq_lens, device=self.device),
                2 * (bucket + 1), self.num_classes, self._next_seed(), greedy=self.greedy,
            )
        return seqs

    # -- the mesh: the primary's broadcasts and every rank's sharded call ----

    def _broadcast(self, rows: int = 0, bucket: int = 0, seed: int = 0,
                   packed: Optional[np.ndarray] = None, stop: bool = False):
        """One micro-batch's header [rows, bucket, seed, stop] and its packed
        [rows, bucket + 2] tokens and lengths, from the primary to every
        rank (a follower passes nothing and receives them). Returns (packed
        device tensor, bucket, seed), or None on the stop header."""
        header = torch.tensor([rows, bucket, to_signed(seed), int(stop)], dtype=torch.int64,
                              device=self.device)
        dist.broadcast(header, src=0)
        rows, bucket, seed, stop = header.tolist()
        if stop:
            return None
        if packed is None:
            batch = torch.empty((rows, bucket + 2), dtype=torch.int64, device=self.device)
        else:
            batch = torch.as_tensor(packed, dtype=torch.int64).to(self.device)
        dist.broadcast(batch, src=0)
        return batch, bucket, seed & ((1 << 64) - 1)

    def _sharded(self, batch: torch.Tensor, bucket: int, seed: int) -> torch.Tensor:
        """Every rank's share of one micro-batch: [C, n, 2 * (bucket + 1)]."""
        generator = torch.Generator().manual_seed(seed)
        seqs, _scores = sharded_style_transfer_all_classes(
            self.model, batch[:, :-1], batch[:, -1], 2 * (bucket + 1), self.num_classes,
            generator, self.mesh, params_on_mesh=True, greedy=self.greedy)
        return seqs

    def serve_follower(self) -> None:
        """A non-primary rank's loop: receive each micro-batch the primary
        broadcasts and make its share of the sharded call, until the stop
        header."""
        if self.mesh is None or self.is_primary:
            raise RuntimeError("serve_follower runs on the mesh's non-primary ranks")
        use_card(self.device)
        while True:
            message = self._broadcast()
            if message is None:
                return
            self._sharded(*message)

    def _finish(self, seqs: torch.Tensor, n_requests: int) -> List[TransferResult]:
        with tracing.span("service.finish"):
            with tracing.span("service.copy_back"):
                seqs = seqs.cpu().numpy()  # [C, n, T]; waits for the device
            return results_of([{c: seqs[c, i] for c in range(self.num_classes)}
                               for i in range(n_requests)], self._writer)

    def submit_midi(self, midi_bytes: bytes) -> TransferResult:
        """Blocking single-request convenience path."""
        return self.transfer_tokens([self._tokens_from_midi(midi_bytes)])[0]

    # -- continuous threaded loop ---------------------------------------

    def start(self) -> None:
        """Warm up with a one-note request (on CUDA: K1's weight pack, the
        libraries' handles; ~2 s that the first requests would otherwise
        wait), then start the serving loop. On a non-primary rank of a mesh:
        start ``serve_follower`` on a thread."""
        if not self.is_primary:
            self._thread = threading.Thread(target=self.serve_follower, daemon=True)
            self._thread.start()
            return
        self.transfer_tokens([np.asarray([note_on_id(60)])])
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """End the serving loop. On a mesh's primary also send the stop
        header, which ends every follower; a follower's ``stop`` waits for
        it."""
        self._running = False
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None and self.is_primary:
            with self._mesh_lock:
                if not self._stopped:
                    self._stopped = True
                    self._broadcast(stop=True)

    def is_serving(self) -> bool:
        """True while the threaded loop is alive (liveness probes)."""
        return self._thread is not None and self._thread.is_alive()

    def enqueue(self, midi_bytes: bytes, callback) -> None:
        """Queue a request; ``callback(TransferResult)`` fires when served.
        If the batch fails, the callback receives the ``Exception`` instead
        (check ``isinstance(r, Exception)``)."""
        self._queue.put((self._tokens_from_midi(midi_bytes), callback, time.perf_counter()))

    def _collect_batch(self) -> Optional[List]:
        """Up to batch_size requests, flushed after max_wait_ms; None on an
        idle-poll timeout."""
        batch: List = []
        try:
            batch.append(self._queue.get(timeout=0.05))
        except queue.Empty:
            return None
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _deliver(self, seqs: torch.Tensor, batch: List) -> None:
        results = self._finish(seqs, len(batch))
        now = time.perf_counter()
        self.stats.record_batch(
            fill=len(batch), queue_depth_after=self._queue.qsize(),
            latencies_ms=[(now - t0) * 1e3 for _, _, t0 in batch])
        for (_, callback, _), result in zip(batch, results):
            # One requester's raising callback must not reach _loop's batch
            # handler, which would call every callback of the batch again
            # with the exception.
            try:
                callback(result)
            except Exception:
                self.stats.record_error()
                _logger.exception("result callback raised; other requests unaffected")

    def _loop(self) -> None:
        """Collect a micro-batch, dispatch, deliver. A request's latency is
        queue wait + device + detokenize."""
        use_card(self.device)
        while self._running:
            batch = self._collect_batch()
            if not batch:
                continue
            # A failing batch must not kill the serving thread: the error is
            # counted and the loop keeps serving.
            try:
                self._deliver(self._dispatch([t for t, _, _ in batch]), batch)
            except Exception as exc:
                self.stats.record_error()
                _logger.exception("serving batch of %d failed; loop continues", len(batch))
                # Fail the waiters fast: each callback receives the
                # exception, so HTTP handlers answer 500 at once instead of
                # blocking until their client's timeout.
                for _, callback, _ in batch:
                    try:
                        callback(exc)
                    except Exception:
                        _logger.exception("failure callback raised")
