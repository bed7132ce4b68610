"""What the transfer cells share: the requests, the service under test with
the harness's spans around its micro-batches, and the comparison of what
it served with the plain reference.

The service is ``inference.service.StyleTransferService`` on the shipped
weights. The harness wraps two of the instance's calls, changing nothing
they do: ``_dispatch`` (encode and one K1 launch for a micro-batch; the
harness keeps the batch's sources and the device rows it returns) and
``_finish`` (the wait for those rows, then detokenizing). Micro-batch
k of a service (warm-ups counted) decodes under the Philox key
(seed << 32) | k, row c * n + i holding request i's transfer into class c,
as the service documents; the reference works the noise out again from
that key (``reference/noise.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

import counts
from harness import ROOT, log, sync
from reference import model as ref
from reference import noise, smf


def requests(traffic: dict) -> List[bytes]:
    """The corpus's chunks of ``max_seq_len`` tokens with at least
    ``min_tokens`` of them and a note, each written as a MIDI file, in the
    corpus's order."""
    chunks, _ = smf.corpus_chunks(str(ROOT / traffic["data"]), traffic["max_seq_len"])
    out = []
    for row in chunks:
        toks = row[row != smf.PAD]
        if len(toks) >= traffic["min_tokens"] and ((toks >= 3) & (toks < 259)).any():
            out.append(smf.write_midi(toks))
    return out


@dataclasses.dataclass
class MicroBatch:
    key: int  # the K1 Philox key
    sources: List[np.ndarray]  # the service's own tokens of each request
    seqs: object  # device rows [C, n, T]
    request_ids: Optional[List[int]] = None
    rows: Optional[np.ndarray] = None  # on the host, after the window


class Tap:
    """The harness's wrappers around one service instance."""

    def __init__(self, svc, spans, seed: int, device):
        self.svc, self.spans, self.device = svc, spans, device
        self.seed = seed & 0xFFFFFFFF
        self.dispatched = 0
        self.batches: List[MicroBatch] = []
        self._dispatch, self._finish = svc._dispatch, svc._finish
        svc._dispatch, svc._finish = self.dispatch, self.finish

    def dispatch(self, token_lists):
        with self.spans("dispatch"):
            seqs = self._dispatch(token_lists)
        self.dispatched += 1
        self.batches.append(MicroBatch((self.seed << 32) | self.dispatched,
                                       [np.asarray(t) for t in token_lists], seqs))
        return seqs

    def finish(self, seqs, n_requests: int):
        """The wait for the rows, then detokenizing them."""
        with self.spans("wait"):
            sync(self.device)
        with self.spans("results"):
            return self._finish(seqs, n_requests)

    def host_rows(self, batches: List[MicroBatch]) -> None:
        for b in batches:
            if b.rows is None:
                b.rows = b.seqs.cpu().numpy()
                b.seqs = None


def compact(result) -> tuple:
    """A served result kept for the check as a tuple of bytes and arrays,
    which the garbage collector does not track: (each class's MIDI, each
    class's tokens). Tens of thousands of results kept as objects would
    slow every collection in the window."""
    classes = sorted(result.midi_by_class)
    return (tuple(result.midi_by_class[c] for c in classes),
            tuple(np.asarray(result.tokens_by_class[c]) for c in classes))


def last_position(row: np.ndarray) -> int:
    """The last position a row computed: its EOS, else its end."""
    eos = np.nonzero(row == smf.EOS)[0]
    return int(eos[0]) if len(eos) else len(row) - 1


def request_events(b: MicroBatch, i: int) -> int:
    """Note events of request ``i`` of a micro-batch whose rows are on the
    host: its source tokens, once a target class, and the tokens each class's
    row generated before its EOS."""
    C = b.rows.shape[0]
    lasts = [last_position(b.rows[c, i]) for c in range(C)]
    return C * len(b.sources[i]) + sum(lasts) - sum(
        int(b.rows[c, i, lasts[c]] == smf.EOS) for c in range(C))


def microbatch_work(cfg: dict, batches: List[MicroBatch]) -> dict:
    """Model FLOPs, K1's bound and the note events of micro-batches whose
    rows are on the host."""
    flops, k1_bound, events, rows_n = 0, 0.0, 0, 0
    for b in batches:
        C, n, T = b.rows.shape
        lasts = [[last_position(b.rows[c, i]) for c in range(C)] for i in range(n)]
        for i in range(n):
            flops += counts.transfer_flops(cfg, len(b.sources[i]) + 1, lasts[i])
            events += request_events(b, i)
        k1_flops = sum(counts.decoder_flops(cfg, t + 1) for ls in lasts for t in ls)
        k1_flops -= C * n * 2 * cfg["latent_dim"] * cfg["decoder"]["model_size"]
        k1_bound += counts.bound_s(k1_flops, counts.k1_bytes(cfg, C * n, T), cfg["dtype"])
        rows_n += C * n
    return {"model_flops": flops, "k1_bound_s": k1_bound, "note_events": events,
            "rows": rows_n}


def sample(results: Dict[int, object], batches: List[MicroBatch], seed: int,
           tokens: int) -> List[tuple]:
    """Finished requests drawn from the seed, the longest first, until they
    hold ``tokens`` served tokens: (request id, micro-batch, index in it)."""
    where = {}
    for b in batches:
        for i, rid in enumerate(b.request_ids or []):
            if rid in results:
                where[rid] = (b, i)
    served = {rid: sum(last_position(b.rows[c, i]) for c in range(b.rows.shape[0]))
              for rid, (b, i) in where.items()}
    if not served:
        return []
    longest = max(served, key=lambda r: (served[r], -r))
    rng = np.random.default_rng(seed)
    order = [longest] + [r for r in rng.permutation(sorted(served)).tolist() if r != longest]
    out, total = [], 0
    for rid in order:
        out.append((rid,) + where[rid])
        total += served[rid]
        if total >= tokens:
            break
    return out


def served_rows(picked: List[tuple], traffic: dict, midi: List[bytes], device):
    """Each served row of the ``picked`` requests: (request id, micro-batch,
    index in it, class, the reference's own tokens of the request, the
    source [1, L+1] with SOS, the row, its last position)."""
    import torch

    for rid, b, i in picked:
        src = smf.request_tokens(midi[rid], traffic["max_seq_len"])
        source = torch.tensor(np.concatenate([[smf.SOS], src]), device=device)[None]
        for c in range(b.rows.shape[0]):
            row = b.rows[c, i].astype(np.int64)
            yield rid, b, i, c, src, source, row, last_position(row)


def perturbed_logits(p, cfg, b: MicroBatch, i: int, c: int, source, row: np.ndarray,
                     last: int, numerics):
    """(the decoder's logits along a served row through its last position,
    computed by ``numerics``, plus the sampling noise of that row worked out
    again from its micro-batch's key; the row's tokens [last], on the
    device)."""
    import torch

    device = source.device
    rows = torch.tensor(row[:last + 1], device=device)[None]
    cls = torch.tensor([c], device=device)
    n = b.rows.shape[1]
    g = torch.tensor(noise.gumbel(b.key, c * n + i, last, cfg["vocab_size"]), device=device)
    return ref.transfer_logits(p, cfg, source, rows, cls, numerics)[0] + g, rows[0, 1:last + 1]


def shipped_params(cfg: dict, device):
    return ref.load_params(str(ROOT / cfg["shipped_model"] / "torch" / "params.npz"), cfg, device)


def compare(cfg: dict, traffic: dict, picked: List[tuple], midi: List[bytes],
            results: Dict[int, tuple], device) -> dict:
    """The served transfers of ``picked`` against the float32 reference on
    the shipped weights: the widest gap by which a served token's perturbed
    logit lies below the reference's best, and its mean; requests whose
    sources the service tokenized otherwise than the reference; rows whose
    returned tokens are not the row's events; MIDI files that do not hold
    those tokens' notes. ``results`` are ``compact`` ones."""
    p = shipped_params(cfg, device)
    out = {"logit_gap": 0.0, "source_mismatch": 0, "token_mismatch": 0, "midi_mismatch": 0,
           "tokens_compared": 0, "gap_sum": 0.0}
    with ref.no_tf32():
        for rid, b, i, c, src, source, row, last in served_rows(picked, traffic, midi, device):
            if c == 0 and (len(src) != len(b.sources[i]) or (src != b.sources[i]).any()):
                out["source_mismatch"] += 1
            want = row[row >= 3]
            got = results[rid][1][c]
            if len(got) != len(want) or (got != want).any():
                out["token_mismatch"] += 1
            if smf.note_messages(results[rid][0][c]) != smf.expected_messages(want):
                out["midi_mismatch"] += 1
            if last < 1:
                continue
            lg, served = perturbed_logits(p, cfg, b, i, c, source, row, last, ref.Numerics())
            gaps = lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]
            out["logit_gap"] = max(out["logit_gap"], float(gaps.max()))
            out["gap_sum"] += float(gaps.sum())
            out["tokens_compared"] += last
    out["gap_mean"] = out.pop("gap_sum") / max(1, out["tokens_compared"])
    return out


def load_service(cfg: dict, traffic: dict, seed: int, device, ctx):
    """The service on the shipped weights; its widths must be the
    configuration's."""
    from musicstyletransfer_torch.inference.service import StyleTransferService

    with ctx.phase("weights"):
        svc = StyleTransferService(
            str(ROOT / cfg["shipped_model"]), checkpoint=-1,
            batch_size=traffic["batch_size"], max_seq_len=traffic["max_seq_len"],
            max_wait_ms=traffic["max_wait_ms"], seed=seed & 0xFFFFFFFF,
            buckets=traffic["buckets"], device=device)
        mc = svc.model.config
        got = {"encoder": mc.encoder_config.transformer_config.model_size,
               "decoder": mc.decoder_config.transformer_config.model_size,
               "latent_dim": mc.decoder_config.latent_dim, "dtype": mc.dtype}
        want = {"encoder": cfg["encoder"]["model_size"], "decoder": cfg["decoder"]["model_size"],
                "latent_dim": cfg["latent_dim"], "dtype": cfg["dtype"]}
        if got != want:
            raise SystemExit(f"the shipped model is {got}, the configuration {want}")
    return svc


def warm_up(svc, pool: List[bytes], traffic: dict) -> None:
    """Every bucket at one request and at a full batch."""
    from musicstyletransfer_torch.inference.service import tokens_from_midi

    buckets = traffic["buckets"]
    toks = [tokens_from_midi(m, traffic["max_seq_len"]) for m in pool]
    full = [t for t in toks if len(t) >= buckets[-1]]
    for bucket in buckets:
        for n in (1, traffic["batch_size"]):
            svc.transfer_tokens([t[:bucket] for t in full[:n]])
    log(f"warm-up: buckets {buckets} at 1 and {traffic['batch_size']} requests")


def checks_of(found: dict, limits: dict, missing: int) -> List[tuple]:
    """(name, value, limit, holds) of a transfer cell."""
    return [("logit_gap", found["logit_gap"], limits["logit_gap"],
             found["logit_gap"] <= limits["logit_gap"]),
            ("gap_mean", found["gap_mean"], limits["gap_mean"],
             found["gap_mean"] <= limits["gap_mean"]),
            ("source_mismatch", found["source_mismatch"], 0, found["source_mismatch"] == 0),
            ("token_mismatch", found["token_mismatch"], 0, found["token_mismatch"] == 0),
            ("midi_mismatch", found["midi_mismatch"], 0, found["midi_mismatch"] == 0),
            ("missing", missing, 0, missing == 0),
            ("tokens_compared_min", found["tokens_compared"], limits["tokens_compared_min"],
             found["tokens_compared"] >= limits["tokens_compared_min"])]
