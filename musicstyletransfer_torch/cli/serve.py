"""Micro-batched style-transfer service CLI of the PyTorch port (the flags
of ``python -m musicstyletransfer_tpu.cli.serve``, with ``--gpu``).

One-shot mode: transfer every ``.mid`` in ``--in-dir`` into every style
class, writing ``<name>.class-{c}.mid`` files to ``--out-samples``. Watch
mode (``--watch``): keep polling the directory and serve new files as they
appear.

    python -m musicstyletransfer_torch.cli.serve \\
        --model-output models/guitar_bass --in-dir midis/ --out-samples out/

HTTP mode (``--http PORT``, 0 picks a free port): a threaded endpoint over
the same service, concurrent clients' requests micro-batched together into
one K1 launch; ``--streaming`` serves them through the slot engine
(``inference/streaming.py``) instead:

    POST /transfer            MIDI bytes in -> JSON {class: base64 MIDI}
    POST /transfer?class=N    MIDI bytes in -> raw transferred MIDI bytes
    GET  /stats               ServiceStats snapshot (p50/p99, fill, queue)
    GET  /healthz             liveness probe

Runs on CUDA, and fails when there is no card, unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import glob
import os
import threading
import time
from typing import Optional

from ..inference.service import StyleTransferService
from ..inference.streaming import EngineOverloaded, StreamingTransferEngine
from ..utils import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-output", "-m", required=True)
    p.add_argument("--checkpoint", "-c", type=int, default=-1)
    p.add_argument("--in-dir", default=None,
                   help="directory of .mid requests (required unless --http)")
    p.add_argument("--out-samples", "-o", default=None,
                   help="output directory (required unless --http)")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-seq-len", type=int, default=64)
    p.add_argument("--watch", action="store_true")
    p.add_argument("--poll-seconds", type=float, default=1.0)
    p.add_argument("--buckets", default="",
                   help="comma-separated length buckets (e.g. '16,32,64'; the largest "
                        "must equal --max-seq-len): each batch is served at the smallest "
                        "bucket covering its longest request, with a generation budget "
                        "of 2 x (bucket + 1)")
    p.add_argument("--stats", action="store_true",
                   help="print serving stats (p50/p99 latency, batch fill, queue depth) "
                        "on exit / every watch poll")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (tests/dev)")
    p.add_argument("--gpu", action="store_true", help="run on CUDA (the default)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve an HTTP endpoint instead of reading --in-dir (POST "
                        "/transfer, GET /stats); 0 binds a free port")
    p.add_argument("--http-host", default="127.0.0.1",
                   help="bind address for --http (default loopback)")
    p.add_argument("--streaming", action="store_true",
                   help="continuous batching (--http only): the slot engine admits "
                        "requests between decode segments instead of between "
                        "micro-batches")
    p.add_argument("--slots", type=int, default=128,
                   help="--streaming: concurrent generation lanes")
    p.add_argument("--segment-steps", type=int, default=32,
                   help="--streaming: decode steps per cycle (the admission granularity)")
    p.add_argument("--admit-size", type=int, default=0,
                   help="--streaming: most (request x class) units encoded into free "
                        "slots per cycle; 0 = full width (= --slots)")
    p.add_argument("--max-queue", type=int, default=0,
                   help="--streaming: bound on the host request queue; at the bound new "
                        "requests are shed with an immediate EngineOverloaded error "
                        "(HTTP 503) (0 = unbounded)")
    p.add_argument("--harvest-delay-ms", type=float, default=None,
                   help="--streaming: harvest a cycle's readout only once it is this old "
                        "(and its copy has landed); default: as soon as the copy's CUDA "
                        "event completes")
    return p


def serve_http(svc, host: str, port: int):
    """Threaded HTTP front end over the service's (or engine's) loop.

    Binds, starts the serving loop and returns the ThreadingHTTPServer (the
    caller runs ``serve_forever()``, or drives it from a thread in tests).
    Every POST blocks its handler thread on the request's callback while
    the loop batches concurrent requests together."""
    import base64
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        # MIDI requests are KB-scale; cap the body so a hostile or broken
        # Content-Length cannot buffer gigabytes into the serving process.
        MAX_BODY = 16 * 1024 * 1024

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/stats"):
                self._send(200, "application/json", json.dumps(svc.stats.snapshot()).encode())
            elif self.path.startswith("/healthz"):
                # Green only while the serving loop's thread is alive.
                if svc.is_serving():
                    self._send(200, "text/plain", b"ok")
                else:
                    self._send(503, "text/plain", b"serving loop dead")
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            if not self.path.startswith("/transfer"):
                return self._send(404, "text/plain", b"not found")
            # Validate ?class before enqueueing, so a bad selector costs no
            # device work; a blank '?class=' is a 400 too.
            query = parse_qs(urlparse(self.path).query, keep_blank_values=True)
            cls = None
            if "class" in query:
                try:
                    cls = int(query["class"][0])
                    if not 0 <= cls < svc.num_classes:
                        raise ValueError(cls)
                except ValueError:
                    return self._send(
                        400, "text/plain",
                        f"unknown class (have 0..{svc.num_classes - 1})".encode())
            try:
                length = int(self.headers.get("Content-Length", "0"))
                if length > self.MAX_BODY:
                    return self._send(413, "text/plain",
                                      f"body too large (max {self.MAX_BODY} bytes)".encode())
                data = self.rfile.read(length)
                done = threading.Event()
                box = {}

                def cb(result):
                    box["result"] = result
                    done.set()

                svc.enqueue(data, cb)
            except Exception as exc:  # malformed MIDI, no note events
                return self._send(400, "text/plain", f"bad request: {exc}".encode())
            if not done.wait(timeout=120.0):
                return self._send(504, "text/plain", b"transfer timed out")
            result = box["result"]
            if isinstance(result, EngineOverloaded):
                # a bounded queue shed it: back off and retry elsewhere
                return self._send(503, "text/plain", f"overloaded: {result}".encode())
            if isinstance(result, Exception):  # a failed batch, failed fast
                return self._send(500, "text/plain", f"transfer failed: {result}".encode())
            if cls is not None:
                return self._send(200, "audio/midi", result.midi_by_class[cls])
            payload = {str(c): base64.b64encode(m).decode()
                       for c, m in result.midi_by_class.items()}
            self._send(200, "application/json", json.dumps(payload).encode())

        def log_message(self, *args):  # quiet: the stats carry the signal
            pass

    # Bind first: if the port is taken, fail before the serving loop starts.
    server = ThreadingHTTPServer((host, port), Handler)
    svc.start()
    return server


def serve_dir(svc: StyleTransferService, in_dir: str, out_dir: str, watch: bool = False,
              poll_seconds: float = 1.0, stats: bool = False,
              stop: Optional[threading.Event] = None) -> None:
    """Directory mode: every ``.mid`` of ``in_dir`` into every class, in
    micro-batches of the service's batch size; with ``watch``, poll for new
    files until ``stop`` is set (forever when there is none)."""
    os.makedirs(out_dir, exist_ok=True)
    seen = set()

    def flush(batch_tokens, names):
        t0 = time.perf_counter()
        results = svc.transfer_tokens(batch_tokens)
        dt = (time.perf_counter() - t0) * 1e3
        svc.stats.record_batch(fill=len(names), queue_depth_after=0,
                               latencies_ms=[dt] * len(names))
        for name, result in zip(names, results):
            for c, midi in result.midi_by_class.items():
                with open(os.path.join(out_dir, f"{name}.class-{c}.mid"), "wb") as fh:
                    fh.write(midi)
        print(f"served {len(names)} files x {svc.num_classes} classes in {dt:.1f}ms")

    def process(files):
        batch_tokens, names = [], []
        for f in files:
            with open(f, "rb") as fh:
                data = fh.read()
            try:
                batch_tokens.append(svc._tokens_from_midi(data))
            except ValueError as exc:
                print(f"skipping {f}: {exc}")
                continue
            names.append(os.path.splitext(os.path.basename(f))[0])
            if len(batch_tokens) == svc.batch_size:
                flush(batch_tokens, names)
                batch_tokens, names = [], []
        if batch_tokens:
            flush(batch_tokens, names)

    def print_stats():
        s = svc.stats.snapshot()
        print(f"stats: served={s['requests_served']} batches={s['batches']} "
              f"fill={s['mean_batch_fill']:.1f} p50={s['latency_p50_ms']:.1f}ms "
              f"p99={s['latency_p99_ms']:.1f}ms max_queue={s['max_queue_depth']}")

    while True:
        files = [f for f in sorted(glob.glob(os.path.join(in_dir, "*.mid"))) if f not in seen]
        seen.update(files)
        if files:
            process(files)
            if stats and watch:
                print_stats()
        if not watch or (stop is not None and stop.wait(poll_seconds)):
            break
        if stop is None:
            time.sleep(poll_seconds)
    if stats and not watch:
        print_stats()


def main(argv=None, stop: Optional[threading.Event] = None) -> None:
    """``stop`` ends the watch and HTTP modes when set (tests)."""
    parser = build_parser()
    args = parser.parse_args(argv)
    http = args.http is not None
    if not http and not (args.in_dir and args.out_samples):
        parser.error("--in-dir and --out-samples are required without --http")
    if args.streaming and not http:
        parser.error("--streaming applies to --http serving (directory modes are "
                     "throughput-bound; the micro-batch loop wins there)")
    device = resolve_device(gpu=args.gpu, cpu=args.cpu)
    if args.streaming:
        svc = StreamingTransferEngine(
            args.model_output, checkpoint=args.checkpoint, slots=args.slots,
            max_seq_len=args.max_seq_len, segment_steps=args.segment_steps,
            admit_size=args.admit_size,
            harvest_delay_s=(None if args.harvest_delay_ms is None
                             else args.harvest_delay_ms / 1e3),
            max_queue=args.max_queue, device=device)
    else:
        buckets = [int(b) for b in args.buckets.split(",") if b.strip()] or None
        svc = StyleTransferService(
            args.model_output, checkpoint=args.checkpoint, batch_size=args.batch_size,
            max_seq_len=args.max_seq_len, buckets=buckets, device=device)
    if not http:
        serve_dir(svc, args.in_dir, args.out_samples, args.watch, args.poll_seconds,
                  args.stats, stop)
        return
    server = serve_http(svc, args.http_host, args.http)
    print(f"serving HTTP on {args.http_host}:{server.server_port} "
          "(POST /transfer, GET /stats)", flush=True)
    if stop is not None:
        threading.Thread(target=lambda: (stop.wait(), server.shutdown()), daemon=True).start()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()  # shutdown() leaves the listening socket open
        svc.stop()


if __name__ == "__main__":
    main()
