"""PyTorch port, the micro-batched service and ``cli.serve`` (CPU): the
counterparts of ``tests/test_service.py`` on the same tiny model, whose
weights go into the port through its converter (``torch/params.npz``
exported from the JAX checkpoint).

``test_mesh_sharded_service`` has no counterpart: the port has no mesh
until ROADMAP queue 1 item 9b, and ``mesh=`` raises naming that item
(``test_mesh_is_not_ported``). The port decodes only a partial batch's real
rows where the JAX package pads with its first request; the token layout
of those rows is held to the JAX package's.

Every wait, join and HTTP request carries a timeout; services and servers
stop in ``finally``; the HTTP server binds port 0.
"""

import base64
import importlib.util
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from musicstyletransfer_torch.cli import serve
from musicstyletransfer_torch.inference import decode
from musicstyletransfer_torch.inference.service import StyleTransferService, _percentile
from musicstyletransfer_torch.inference.streaming import StreamingTransferEngine
from musicstyletransfer_torch.midi import smf
from musicstyletransfer_torch.midi.codec import Melody, MelodyWriter
from musicstyletransfer_torch.midi.vocab import note_on_id, timeshift_id
from tests.test_model import tiny_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def export_to_torch(folder: str) -> None:
    """Write ``<folder>/torch/`` from the folder's JAX checkpoint with
    ``scripts/export-torch-weights.py``."""
    spec = importlib.util.spec_from_file_location(
        "export_torch_weights", os.path.join(REPO, "scripts", "export-torch-weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.export_params(folder)


def jax_model_folder(tmp_path_factory, name: str, **config) -> str:
    """A JAX checkpoint of ``tiny_config(**config)`` (as the JAX tests make
    it) and its export for the port, in one folder."""
    from musicstyletransfer_tpu.models import init_params, make_model
    from musicstyletransfer_tpu.training import (OptimizerConfig, build_optimizer,
                                                 create_train_state, save_checkpoint)

    folder = str(tmp_path_factory.mktemp(name))
    cfg = tiny_config(**config)
    cfg.save(os.path.join(folder, "config"))
    model = make_model(cfg)
    params = init_params(model, jax.random.key(0), max_seq_len=8)
    tx = build_optimizer(OptimizerConfig("adam", "", 1e-3))
    save_checkpoint(folder, 1, create_train_state(params, tx, jax.random.key(0)))
    export_to_torch(folder)
    return folder


@pytest.fixture(scope="module")
def model_folder(tmp_path_factory):
    return jax_model_folder(tmp_path_factory, "svc-model", vocab=293, classes=3, latent=8,
                            size=16, heads=2, layers=1)


def _midi_bytes(pitches=(60, 62, 64)):
    tokens = []
    for p in pitches:
        tokens += [note_on_id(p), timeshift_id(120), note_on_id(p)]
    melody = Melody(tokens=np.asarray(tokens, np.int32))
    return smf.dump_midifile(MelodyWriter().to_midifile(melody))


def service(folder, **kw):
    kw.setdefault("batch_size", 4)
    kw.setdefault("max_seq_len", 8)
    return StyleTransferService(folder, checkpoint=-1, device=CPU, **kw)


def wait_for(cond, timeout):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


class TestService:
    def test_submit_midi(self, model_folder):
        result = service(model_folder).submit_midi(_midi_bytes())
        assert set(result.midi_by_class) == {0, 1, 2}
        for midi in result.midi_by_class.values():
            assert smf.parse_midifile(midi).resolution > 0

    def test_micro_batch_partial_fill(self, model_folder, monkeypatch):
        """Two requests in a batch of four: two results, and only the real
        rows are decoded (2 requests x 3 classes), laid out as the JAX
        service lays out its first two rows."""
        from musicstyletransfer_tpu.inference.service import StyleTransferService as JaxService

        svc = service(model_folder)
        toks = [svc._tokens_from_midi(_midi_bytes((60 + i,))) for i in range(2)]
        seen = []
        real = decode.style_transfer_all_classes

        def spy(model, tokens, seq_lens, max_len, num_classes, seed, *a, **k):
            seen.append((tuple(tokens.shape), max_len, num_classes))
            return real(model, tokens, seq_lens, max_len, num_classes, seed, *a, **k)

        monkeypatch.setattr("musicstyletransfer_torch.inference.service."
                            "style_transfer_all_classes", spy)
        results = svc.transfer_tokens(toks)
        assert len(results) == 2
        assert seen == [((2, 9), 18, 3)]
        jsvc = JaxService.__new__(JaxService)
        jsvc.batch_size, jsvc.max_seq_len = 4, 8
        jtokens, jlens = jsvc._make_batch(toks, 8)
        tokens, lens = svc._make_batch(toks, 8)
        np.testing.assert_array_equal(tokens, jtokens[:2])
        np.testing.assert_array_equal(lens, jlens[:2])

    def test_dispatch_is_one_transfer_at_the_bucket(self, model_folder):
        """A micro-batch's tokens are those of style_transfer_all_classes
        on its rows at max_len 2 * (bucket + 1), with the batch's seed."""
        svc = service(model_folder, buckets=[4, 8])
        toks = [svc._tokens_from_midi(_midi_bytes((60, 62, 64)))[:3],
                svc._tokens_from_midi(_midi_bytes((65,)))]
        seqs = svc._dispatch(toks)
        tokens, lens = svc._make_batch(toks, 4)
        ref, _ = decode.style_transfer_all_classes(
            svc.model, torch.as_tensor(tokens), torch.as_tensor(lens), 10, 3, (0 << 32) | 1)
        assert seqs.shape == (3, 2, 10)
        np.testing.assert_array_equal(seqs.numpy(), ref.numpy())
        assert svc._next_seed() == 2  # one seed a batch, counted under the lock

    def test_threaded_loop(self, model_folder):
        svc = service(model_folder, max_wait_ms=20)
        svc.start()
        got = []
        try:
            for i in range(3):
                svc.enqueue(_midi_bytes((60 + i,)), got.append)
            assert wait_for(lambda: len(got) >= 3, 60)
        finally:
            svc.stop()
        assert len(got) == 3
        assert all(set(r.midi_by_class) == {0, 1, 2} for r in got)
        assert not svc.is_serving()

    def test_concurrent_producers_stress(self, model_folder):
        """Many threads enqueueing at once: every request is served exactly
        once, no callback lost under contention."""
        svc = service(model_folder, max_wait_ms=5)
        svc.start()
        got = []
        lock = threading.Lock()

        def record(result):
            with lock:
                got.append(result)

        def producer(base):
            for i in range(4):
                svc.enqueue(_midi_bytes((60 + (base + i) % 24,)), record)

        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=producer, args=(t * 4,)) for t in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            assert not any(t.is_alive() for t in threads)
            assert wait_for(lambda: len(got) >= 16, 120)
        finally:
            sys.setswitchinterval(switch)
            svc.stop()
        assert len(got) == 16
        assert all(set(r.midi_by_class) == {0, 1, 2} for r in got)

    def test_rejects_empty_midi(self, model_folder):
        svc = service(model_folder, batch_size=2)
        track = [smf.SetTempo.from_bpm(120.0), smf.EndOfTrack(tick=1)]
        empty = smf.dump_midifile(smf.MidiFile(format=1, resolution=220, tracks=[track]))
        with pytest.raises(ValueError, match="no note events"):
            svc.submit_midi(empty)

    def test_mesh_is_not_ported(self, model_folder):
        with pytest.raises(NotImplementedError, match="item 9b"):
            service(model_folder, mesh=object())

    def test_runs_on_cuda_unless_told_otherwise(self, model_folder, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--cpu"):
            StyleTransferService(model_folder, checkpoint=-1, batch_size=2, max_seq_len=8)


class TestServiceStats:
    def test_stats_snapshot_counts_and_latency(self, model_folder):
        svc = service(model_folder, max_wait_ms=20)
        svc.start()
        got = []
        try:
            for i in range(5):
                svc.enqueue(_midi_bytes((60 + i,)), got.append)
            assert wait_for(lambda: len(got) >= 5, 60)
        finally:
            svc.stop()
        s = svc.stats.snapshot()
        assert s["requests_served"] == 5
        assert s["batches"] >= 2  # batch_size 4 cannot hold 5
        assert 0 < s["latency_p50_ms"] <= s["latency_p99_ms"]
        assert s["latency_p99_ms"] <= s["latency_max_ms"]
        assert 0 < s["mean_batch_fill"] <= 4

    def test_percentile_nearest_rank(self):
        """Nearest rank = 1-based ceil(p*N/100): p50 of 1..100 is 50, p99 is
        99, not the max; the same values as the JAX package's."""
        from musicstyletransfer_tpu.inference.service import _percentile as jax_percentile

        vals = sorted(float(i) for i in range(1, 101))
        assert _percentile(vals, 50) == 50.0
        assert _percentile(vals, 99) == 99.0
        assert _percentile(vals, 100) == 100.0
        assert _percentile([], 50) == 0.0
        assert _percentile([7.0], 99) == 7.0
        rng = np.random.default_rng(0)
        for n in (1, 2, 7, 100, 1001):
            v = sorted(rng.normal(size=n).tolist())
            for p in (0, 1, 50, 90, 99, 100):
                assert _percentile(v, p) == jax_percentile(v, p)


class TestServiceBuckets:
    def test_bucket_pick_and_shapes(self, model_folder):
        svc = service(model_folder, buckets=[4, 8])
        short = svc._tokens_from_midi(_midi_bytes((60,)))[:3]
        long = svc._tokens_from_midi(_midi_bytes((60, 62, 64)))[:8]
        assert svc._pick_bucket([short]) == 4
        assert svc._pick_bucket([short, long]) == 8
        r_short = svc.transfer_tokens([short])
        r_long = svc.transfer_tokens([long])
        assert len(r_short) == 1 and len(r_long) == 1
        for r in (r_short[0], r_long[0]):
            assert set(r.midi_by_class) == {0, 1, 2}
        short_len = max(len(t) for t in r_short[0].tokens_by_class.values())
        assert short_len <= 2 * (4 + 1)  # the small bucket's generation cap

    def test_bucket_validation(self, model_folder):
        with pytest.raises(ValueError):
            service(model_folder, batch_size=2, buckets=[4, 16])


class TestServeCLI:
    def test_one_shot_with_buckets_and_stats(self, model_folder, tmp_path, capsys):
        in_dir, out_dir = tmp_path / "in", tmp_path / "out"
        in_dir.mkdir()
        for i in range(3):
            (in_dir / f"req{i}.mid").write_bytes(_midi_bytes((60 + i,)))
        serve.main(["--model-output", model_folder, "--checkpoint", "-1",
                    "--in-dir", str(in_dir), "--out-samples", str(out_dir),
                    "--batch-size", "4", "--max-seq-len", "8",
                    "--buckets", "4,8", "--stats", "--cpu"])
        outs = sorted(p.name for p in out_dir.iterdir())
        assert len(outs) == 9, outs  # 3 inputs x 3 classes
        assert "req0.class-0.mid" in outs
        captured = capsys.readouterr().out
        assert "stats: served=3" in captured
        assert "p99=" in captured

    def test_watch_mode_serves_new_files(self, model_folder, tmp_path):
        """--watch serves the files present, then the ones that appear."""
        in_dir, out_dir = tmp_path / "in", tmp_path / "out"
        in_dir.mkdir()
        (in_dir / "a.mid").write_bytes(_midi_bytes((60,)))
        stop = threading.Event()
        errors = []

        def run():
            try:
                serve.main(["--model-output", model_folder, "--in-dir", str(in_dir),
                            "--out-samples", str(out_dir), "--batch-size", "4",
                            "--max-seq-len", "8", "--watch", "--poll-seconds", "0.05",
                            "--stats", "--cpu"], stop=stop)
            except Exception as exc:  # surfaced below
                errors.append(exc)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        try:
            assert wait_for(lambda: (out_dir / "a.class-2.mid").exists(), 60)
            (in_dir / "b.mid").write_bytes(_midi_bytes((62, 64)))
            assert wait_for(lambda: (out_dir / "b.class-2.mid").exists(), 60)
        finally:
            stop.set()
            t.join(timeout=30)
        assert not t.is_alive() and not errors
        assert sorted(p.name for p in out_dir.iterdir()) == [
            f"{n}.class-{c}.mid" for n in "ab" for c in range(3)]

    def test_flags_and_device(self, model_folder, tmp_path, monkeypatch):
        """The JAX CLI's flags parse alike; --streaming needs --http; no
        card and no --cpu raises."""
        from musicstyletransfer_tpu.cli.serve import build_parser as jax_parser

        argv = ["--model-output", "m", "--in-dir", "i", "--out-samples", "o", "--watch",
                "--poll-seconds", "2", "--buckets", "16,32,64", "--stats", "--slots", "64",
                "--segment-steps", "16", "--admit-size", "8", "--max-queue", "5",
                "--harvest-delay-ms", "3", "--batch-size", "16", "--http-host", "0.0.0.0",
                "--http", "8080", "--streaming"]
        ours, theirs = vars(serve.build_parser().parse_args(argv)), vars(
            jax_parser().parse_args(argv))
        assert {k: v for k, v in ours.items() if k != "gpu"} == theirs
        with pytest.raises(SystemExit):
            serve.main(["--model-output", model_folder, "--in-dir", "i", "--out-samples",
                        str(tmp_path), "--streaming", "--cpu"])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="--cpu"):
            serve.main(["--model-output", model_folder, "--in-dir", str(tmp_path),
                        "--out-samples", str(tmp_path / "o")])


def post(url, data, timeout=60):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


@pytest.fixture()
def http_server(model_folder):
    """--http over the service on an ephemeral port; a generous coalescing
    window, so concurrent posts share batches even on a slow host."""
    svc = service(model_folder, max_wait_ms=200)
    server = serve.serve_http(svc, "127.0.0.1", 0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{server.server_port}", svc
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
        t.join(timeout=30)


class TestHTTPServing:
    def test_transfer_json_and_raw(self, http_server):
        url, _svc = http_server
        status, _, body = post(f"{url}/transfer", _midi_bytes())
        assert status == 200
        payload = json.loads(body)
        assert set(payload) == {"0", "1", "2"}
        for midi_b64 in payload.values():
            assert smf.parse_midifile(base64.b64decode(midi_b64)).resolution > 0
        status, ctype, body = post(f"{url}/transfer?class=1", _midi_bytes())
        assert status == 200 and ctype == "audio/midi"
        assert smf.parse_midifile(body).resolution > 0

    def test_concurrent_posts_micro_batch(self, http_server):
        """Simultaneous clients share batches (fewer batches than requests)."""
        url, _svc = http_server
        errors = []

        def one(i):
            try:
                assert post(f"{url}/transfer?class=0", _midi_bytes((60 + i,)))[0] == 200
            except Exception as exc:  # surfaced below
                errors.append(exc)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not any(t.is_alive() for t in threads) and not errors
        with urllib.request.urlopen(f"{url}/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["requests_served"] >= 4
        assert stats["batches"] < stats["requests_served"]

    def test_bad_request_and_health(self, http_server):
        url, _svc = http_server
        with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
            assert resp.read() == b"ok"
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            post(f"{url}/transfer", b"not midi", timeout=30)
        assert exc_info.value.code == 400
        for bad in ("?class=99", "?class=", "?class=x"):
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                post(f"{url}/transfer{bad}", _midi_bytes(), timeout=30)
            assert exc_info.value.code == 400, bad

    def test_failed_batch_fails_fast(self, http_server):
        """A failing batch answers 500 at once through the exception
        callback, and the loop survives."""
        url, svc = http_server

        def boom(toks):
            raise RuntimeError("injected device failure")

        orig = svc._dispatch
        svc._dispatch = boom
        try:
            t0 = time.perf_counter()
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                post(f"{url}/transfer", _midi_bytes(), timeout=60)
            assert exc_info.value.code == 500
            assert time.perf_counter() - t0 < 30
            assert svc.stats.snapshot()["batch_errors"] >= 1
            assert svc.is_serving()
        finally:
            svc._dispatch = orig


class TestHTTPStreaming:
    def test_engine_serves_and_sheds_with_503(self, model_folder):
        """--http over the slot engine: a post is served; once the engine
        stops draining its bounded queue (max_queue 1) and one request waits
        in it, a post is shed with 503."""
        eng = StreamingTransferEngine(model_folder, checkpoint=-1, slots=6, max_seq_len=8,
                                      segment_steps=4, max_queue=1, device=CPU)
        server = serve.serve_http(eng, "127.0.0.1", 0)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        url = f"http://127.0.0.1:{server.server_port}"
        try:
            status, _, body = post(f"{url}/transfer", _midi_bytes())
            assert status == 200 and set(json.loads(body)) == {"0", "1", "2"}
            with urllib.request.urlopen(f"{url}/healthz", timeout=10) as resp:
                assert resp.read() == b"ok"
            eng.stop()  # nothing drains the queue now
            eng._queue.put((np.asarray([60]), lambda r: None, time.perf_counter()))
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                post(f"{url}/transfer", _midi_bytes(), timeout=30)
            assert exc_info.value.code == 503
            assert eng.stats.snapshot()["requests_shed"] >= 1
        finally:
            server.shutdown()
            server.server_close()
            eng.stop()
            t.join(timeout=30)
