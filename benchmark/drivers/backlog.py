"""A backlog converted back to back: a folder of MIDI files transferred
``batch_size`` files a call, each call tokenizing its files and then one
``StyleTransferService.transfer_tokens`` (encode, one K1 launch, and the
MIDI of every class for every file), with no queue, thread or wait.

Traffic parameters: the files (the corpus's ``max_seq_len`` chunks with at
least ``min_tokens`` tokens, written as MIDI), ``batch_size``, the
service's ``buckets``. ``--seed`` orders the backlog; it is cycled until
the window closes, and every call started in the window completes in it.
"""

from __future__ import annotations

import time

import numpy as np

import transfer
from harness import log, sync


def setup(ctx) -> None:
    from musicstyletransfer_torch.inference.service import tokens_from_midi

    ctx.tokens_from_midi = tokens_from_midi
    with ctx.phase("requests"):
        ctx.pool = transfer.requests(ctx.traffic)
    ctx.svc = transfer.load_service(ctx.cfg, ctx.traffic, ctx.seed, ctx.device, ctx)
    ctx.tap = transfer.Tap(ctx.svc, ctx.spans, ctx.seed, ctx.device)
    with ctx.phase("warmup"):
        transfer.warm_up(ctx.svc, ctx.pool, ctx.traffic)
        sync(ctx.device)
    ctx.order = np.random.default_rng(ctx.seed).permutation(len(ctx.pool))
    ctx.warm_batches = len(ctx.tap.batches)


def window(ctx) -> None:
    svc, spans, bs = ctx.svc, ctx.spans, ctx.traffic["batch_size"]
    L = ctx.traffic["max_seq_len"]
    ctx.results, ctx.midi = {}, []
    k = 0
    with ctx.measured():
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < ctx.seconds:
            ids = [k + j for j in range(bs)]
            files = [ctx.pool[ctx.order[i % len(ctx.order)]] for i in ids]
            with spans("tokenize"):
                toks = [ctx.tokens_from_midi(m, L) for m in files]
            results = svc.transfer_tokens(toks)
            ctx.tap.batches[-1].request_ids = ids
            for i, m, r in zip(ids, files, results):
                ctx.results[i] = transfer.compact(r)
                ctx.midi.append(m)
            k += bs
        sync(ctx.device)
        wall = time.perf_counter() - t_start
    batches = ctx.tap.batches[ctx.warm_batches:]
    ctx.tap.host_rows(batches)
    ctx.work = transfer.microbatch_work(ctx.cfg, batches)
    ctx.work["window_s"] = wall
    ctx.attempted, ctx.failed, ctx.missing = k, 0, 0
    ctx.e2e = {"note_events_per_s": ctx.work["note_events"] / wall}
    ctx.window_batches = batches
    log(f"backlog: {k} files in {len(batches)} calls over {wall:.3f} s, "
        f"{ctx.work['note_events']} note events")


def release(ctx) -> None:
    ctx.svc = None
    ctx.tap.svc = None


def check(ctx) -> None:
    picked = transfer.sample(ctx.results, ctx.window_batches, ctx.seed,
                             ctx.traffic["check_tokens"])
    found = transfer.compare(ctx.cfg, ctx.traffic, picked, ctx.midi, ctx.results, ctx.device)
    ctx.found = found
    ctx.checks = transfer.checks_of(found, ctx.limits, ctx.missing)
