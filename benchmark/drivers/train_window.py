"""Training throughput: the recipe's trainer stepping through the corpus.

Set-up builds one trainer (``training.trainer.Trainer``: the model from
seeded weights, Adam, the recipe's loss; on CUDA each group of
``steps_per_dispatch`` steps one graph replay) and one feed (the corpus's
chunks of the recipe's length, their order drawn from ``--seed``, cycled,
through ``data.prefetch.PrefetchingDataset``). It drives the trainer
through its first steps in the window's own groups, so through the graph
the window replays. Stage A, from the seeded weights: whole groups of
``steps_per_dispatch`` steps until three steps or more are done (three
groups of one step, or one group of eight); it reads each group's summed
loss, Adam's bias-corrected moments after the first group (the first
clipped gradient where a group is one step) and each leaf's change. Stage
B, three groups more, each from the program's own state at its start: the
loss, the moments' increments over each group and each leaf's change over
each group. Adam's
first step moves every parameter by the learning rate times the sign of
its gradient, so from fresh weights later steps amplify rounding; stage B
starts after that step and keeps the precision's signal. Then the warm-up
groups. The window hands groups of the same feed to
``Trainer.train_batches`` as ``Trainer._run_group`` stages them, and ends
in a synchronize. Tokens are the non-PAD targets of every step completed.
After the window the plain reference follows stage A from the same
weights and batches, and each group of stage B from the program's state
at its start, its dropout and noise drawn again from the trainer's seed in the program's
order, and reads the same numbers.
"""

from __future__ import annotations

import statistics
import time

import numpy as np

import counts
from harness import ROOT, log, sync
from reference import model as ref
from reference import smf


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from musicstyletransfer_torch.models.config import (DecoderConfig, EncoderConfig,
                                                        ModelConfig, TransformerConfig)

    def stack(w):
        return TransformerConfig(
            model_size=w["model_size"], dropout=w["dropout"], num_layers=w["num_layers"],
            num_heads=w["num_heads"], vocab_size=cfg["vocab_size"],
            ffn_multiplier=w["ffn_multiplier"], use_flash_attention=cfg["use_flash_attention"],
            norm_scheme=cfg["norm_scheme"], ring_attention=cfg["ring_attention"],
            sequence_sharding=cfg["ring_attention"])

    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=stack(cfg["encoder"]),
                                     latent_dim=cfg["latent_dim"],
                                     num_classes=cfg["num_classes"], input_dim=cfg["vocab_size"]),
        decoder_config=DecoderConfig(transformer_config=stack(cfg["decoder"]),
                                     latent_dim=cfg["latent_dim"],
                                     num_classes=cfg["num_classes"],
                                     output_dim=cfg["vocab_size"],
                                     class_conditioning=cfg["class_conditioning"]),
        dtype=cfg["dtype"])


class Feed:
    """The corpus's training rows in an order drawn from the seed: one
    permutation after another, cut into batches."""

    def __init__(self, rows: dict, classes: np.ndarray, batch_size: int, seed: int, keep: int):
        self.rows, self.classes, self.bs, self.keep = rows, classes, batch_size, keep
        self.rng = np.random.default_rng(seed)
        self.handed = []  # the first ``keep`` host batches handed out, in order

    def __iter__(self):
        from musicstyletransfer_torch.data.dataset import Batch

        n = len(self.classes)
        pending = np.zeros(0, np.int64)
        while True:
            while len(pending) < self.bs:
                pending = np.concatenate([pending, self.rng.permutation(n)])
            idx, pending = pending[:self.bs], pending[self.bs:]
            b = Batch(tokens=self.rows["tokens"][idx].astype(np.int32),
                      seq_lens=self.rows["seq_lens"][idx].astype(np.int32),
                      classes=self.classes[idx].astype(np.int32),
                      labels=self.rows["labels"][idx].astype(np.int32))
            if len(self.handed) < self.keep:
                self.handed.append(b)
            yield b


def load_weights(model, params: dict) -> None:
    """The seeded weights (flax paths, kernels [in, out]) into the port's
    model."""
    import torch
    from musicstyletransfer_torch.convert import flax_names

    with torch.no_grad():
        for name, p in zip(flax_names(model), model.parameters()):
            w = params[name]
            p.copy_(w.t() if name.endswith("/kernel") else w)


B_GROUPS = 3  # stage B's groups: each group's error is noisy from seed to seed


def check_groups(t: dict) -> tuple:
    """(steps a group, groups of stage A) of the check: the window's group
    length, in whole groups until three steps or more are done; stage B is
    ``B_GROUPS`` groups more."""
    n = max(1, t["steps_per_dispatch"])
    return n, -(-3 // n)


def snapshot(opt) -> dict:
    """The optimizer's state in the check's form, on the host."""
    return {"flat": opt.flat.to("cpu", copy=True), "mu": opt.state["mu"].to("cpu", copy=True),
            "nu": opt.state["nu"].to("cpu", copy=True), "count": int(opt.state["count"])}


def b_starts(run: dict) -> list:
    """The states each group of a run's stage B started from."""
    return [g["start"] for g in run["b"]]


def norms(opt, flat) -> list:
    """Each leaf's norm of a vector in the program's flat layout."""
    return [float(v.norm()) for v in opt.views(flat)]


def setup(ctx) -> None:
    from musicstyletransfer_torch.convert import flax_names
    from musicstyletransfer_torch.data.prefetch import PrefetchingDataset
    from musicstyletransfer_torch.models.vae import StyleVAE
    from musicstyletransfer_torch.training.optimizer import OptimizerConfig
    from musicstyletransfer_torch.training.trainer import TrainConfig, Trainer

    cfg, t = ctx.cfg, ctx.cfg["train"]
    n, groups = check_groups(t)
    with ctx.phase("data"):
        chunks, classes = smf.corpus_chunks(str(ROOT / ctx.traffic["data"]), t["max_seq_len"])
        ctx.feed = Feed(smf.layout(chunks), classes, t["batch_size"], ctx.seed,
                        n * (groups + B_GROUPS))
    with ctx.phase("weights"):
        model = StyleVAE(model_config(cfg)).to(ctx.device)
        load_weights(model, ref.init_params(cfg, ctx.seed, ctx.device))
        trainer = Trainer(TrainConfig(
            batch_size=t["batch_size"], optimizer=OptimizerConfig(
                t["optimizer"], t["optimizer_params"], t["learning_rate"]),
            kl_loss_weight=t["kl_loss"], kl_anneal_steps=t["kl_anneal_steps"],
            free_bits=t["free_bits"], label_smoothing=t["label_smoothing"],
            logdir=str(ROOT / "build" / "bench"), seed=ctx.seed + 1,
            steps_per_dispatch=t["steps_per_dispatch"], prefetch=ctx.traffic["prefetch"]),
            model)
        ctx.trainer = trainer
        ctx.it = iter(PrefetchingDataset(ctx.feed, ctx.traffic["prefetch"], ctx.device))
    opt = trainer.optimizer
    extra = ref.optimizer_params(cfg)
    b1, b2 = extra.get("beta1", 0.9), extra.get("beta2", 0.999)
    ctx.prog = {"loss": []}
    with ctx.phase("check_steps"):
        sync(ctx.device)
        start = opt.flat.detach().clone()
        total = trainer.state.names.index("total_loss")
        ctx.prog["b"] = []
        for k in range(groups + B_GROUPS):
            if k == groups:
                ctx.prog["change"] = norms(opt, opt.flat - start)
            if k >= groups:  # a group of stage B starts from the program's state here
                a = snapshot(opt)
            trainer.state.reset_metrics()
            trainer.train_batches([next(ctx.it).tensors for _ in range(n)])
            sync(ctx.device)
            loss = float(trainer.state.sums[total])
            if k < groups:
                ctx.prog["loss"].append(loss)
            else:
                ctx.prog["b"].append({
                    "start": a, "loss": loss, "dmu": opt.state["mu"].cpu() - b1 ** n * a["mu"],
                    "dnu": opt.state["nu"].cpu() - b2 ** n * a["nu"],
                    "change": norms(opt, opt.flat.cpu() - a["flat"])})
            if k == 0:
                first = opt.state["mu"] / (1 - b1 ** n)
                ctx.prog["grad"] = norms(opt, first)
                ctx.prog["grad_vec"] = first.cpu()
                ctx.prog["grad2_vec"] = (opt.state["nu"] / (1 - b2 ** n)).cpu()
        del start
    with ctx.phase("warmup"):
        for _ in range(ctx.traffic["warmup_groups"]):
            trainer.train_batches([next(ctx.it).tensors for _ in range(n)])
        sync(ctx.device)
    ctx.names = flax_names(model)
    log(f"train set-up: {len(classes)} rows of {t['max_seq_len']}, batch {t['batch_size']}, "
        f"{n} steps a group; the check's group losses {ctx.prog['loss']}")


def window(ctx) -> None:
    trainer, spans, it = ctx.trainer, ctx.spans, ctx.it
    n = ctx.cfg["train"]["steps_per_dispatch"]
    tokens, steps, flops, flash = 0, 0, 0, 0.0
    lens = []
    with ctx.measured():
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < ctx.seconds:
            with spans("stage"):
                group = [next(it) for _ in range(n)]
            with spans("dispatch"):
                trainer.train_batches([b.tensors for b in group])
            with spans("count"):
                for b in group:
                    tokens += int(b.batch.seq_lens.sum())
                    lens.append(b.batch.seq_lens)
                steps += n
        with spans("wait"):
            sync(ctx.device)
        wall = time.perf_counter() - t_start
    cfg = ctx.cfg
    for sl in lens:
        flops += counts.train_step_flops(cfg, sl.tolist())
        if cfg["use_flash_attention"]:
            flash += counts.flash_bound_s(cfg, sl.tolist(), (sl + 1).tolist())
    ctx.work = {"steps": steps, "tokens": tokens, "model_flops": flops, "flash_bound_s": flash,
                "window_s": wall}
    ctx.attempted = steps
    ctx.e2e = {"train_tokens_per_s": tokens / wall}
    log(f"train window: {steps} steps, {tokens} tokens in {wall:.3f} s")


def release(ctx) -> None:
    ctx.it.close()
    ctx.it = None
    ctx.trainer = None


def reference_run(cfg, batches, seed, names, numerics, device, start_b=None) -> dict:
    """The plain reference's readings of the check's steps, in the
    program's form. Stage A from the seeded weights: each group's summed
    loss, each leaf's bias-corrected first moment after the first group
    and its change over stage A, both moments whole. Stage B, each group
    from the state of ``start_b`` (states in the check's form, the
    program's) or on from its own: its loss, the moments' increments over
    it and each leaf's change over it. Dropout and noise are drawn on from
    one generator seeded as the trainer's."""
    import torch

    n, groups = check_groups(cfg["train"])
    extra = ref.optimizer_params(cfg)
    b1, b2 = extra.get("beta1", 0.9), extra.get("beta2", 0.999)
    p0 = ref.init_params(cfg, seed, device)

    def flat(leaves):  # the program's layout: kernels [out, in]
        return torch.cat([(leaves[k].t() if k.endswith("/kernel") else leaves[k]).reshape(-1)
                          for k in names]).cpu()

    def leaves(vec):
        out, at = {}, 0
        for k in names:
            shape = p0[k].shape
            piece = vec[at:at + p0[k].numel()].to(device)
            at += p0[k].numel()
            out[k] = piece.reshape(shape[::-1]).t() if k.endswith("/kernel") else \
                piece.reshape(shape)
        return out

    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    with ref.no_tf32():
        r = ref.train_steps(p0, cfg, batches[:n * groups], gen, numerics, moment_after=n)
        out = {"loss": [sum(r["loss"][g * n:(g + 1) * n]) for g in range(groups)],
               "grad": [float(r["grad"][k].norm()) for k in names],
               "change": [float((r["params"][k] - p0[k]).norm()) for k in names],
               "grad_vec": flat(r["grad"]), "grad2_vec": flat(r["grad2"]), "b": []}
        for g in range(B_GROUPS):
            own = {"flat": flat(r["params"]), "mu": flat(r["m"]), "nu": flat(r["v"]),
                   "count": n * (groups + g)}
            sb = own if start_b is None else start_b[g]
            pb = leaves(sb["flat"])
            at = n * (groups + g)
            r = ref.train_steps(pb, cfg, batches[at:at + n], gen, numerics, step0=sb["count"],
                                m0=leaves(sb["mu"]), v0=leaves(sb["nu"]))
            out["b"].append({"start": sb, "loss": sum(r["loss"]),
                             "dmu": flat(r["m"]) - b1 ** n * sb["mu"],
                             "dnu": flat(r["v"]) - b2 ** n * sb["nu"],
                             "change": [float((r["params"][k] - pb[k]).norm()) for k in names]})
    return out


def rel_gaps(prog, ref_norms):
    """Per leaf |program - reference| / max(reference, the median leaf's)."""
    med = statistics.median(ref_norms)
    return [abs(p - r) / max(r, med) for p, r in zip(prog, ref_norms)]


def rel_error(prog, refr) -> float:
    """|program - reference| / |reference| over whole vectors, of one
    vector or of a list of them taken as one."""
    if isinstance(prog, list):
        return float(sum((p - r).norm() ** 2 for p, r in zip(prog, refr)) ** 0.5
                     / sum(r.norm() ** 2 for r in refr) ** 0.5)
    return float((prog - refr).norm() / refr.norm())


def gaps(prog: dict, refr: dict, names) -> dict:
    """The numbers compared. Stage A: the first group's relative loss gap,
    the worst leaf's gap of the first moment's norm and of the change's
    norm, and the first and second moments' errors over the whole vector.
    Stage B: its loss gap, the errors of the moments' increments over its
    groups, all taken as one vector, and the worst leaf's gap of a group's
    change. Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of the
    changes: they move by round-off alone. Beside them, for the record, the
    worst group's loss gap and the median leaf's gaps."""
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], refr["loss"])]
    med_g = statistics.median(refr["grad"])
    moved = [i for i, g in enumerate(refr["grad"]) if g >= 1e-3 * med_g]
    g_gaps = rel_gaps(prog["grad"], refr["grad"])
    c_gaps = rel_gaps([prog["change"][i] for i in moved], [refr["change"][i] for i in moved])
    b_gaps = [gap for pg, rg in zip(prog["b"], refr["b"])
              for gap in rel_gaps([pg["change"][i] for i in moved],
                                  [rg["change"][i] for i in moved])]
    b_loss = [sum(g["loss"] for g in run["b"]) for run in (prog, refr)]
    worst_g = max(range(len(g_gaps)), key=g_gaps.__getitem__)
    worst_c = moved[max(range(len(c_gaps)), key=c_gaps.__getitem__)]
    return {"loss1_gap": losses[0], "grad_gap": g_gaps[worst_g], "change_gap": max(c_gaps),
            "grad_error": rel_error(prog["grad_vec"], refr["grad_vec"]),
            "moment2_error": rel_error(prog["grad2_vec"], refr["grad2_vec"]),
            "b_loss_gap": abs(b_loss[0] - b_loss[1]) / abs(b_loss[1]),
            "b_grad_error": rel_error([g["dmu"] for g in prog["b"]], [g["dmu"] for g in refr["b"]]),
            "b_moment2_error": rel_error([g["dnu"] for g in prog["b"]],
                                         [g["dnu"] for g in refr["b"]]),
            "b_change_gap": max(b_gaps),
            "loss_gap_worst_group": max(losses), "grad_gap_median_leaf": statistics.median(g_gaps),
            "change_gap_median_leaf": statistics.median(c_gaps),
            "grad_worst_leaf": names[worst_g], "change_worst_leaf": names[worst_c],
            "left_out": [n for i, n in enumerate(names) if i not in moved]}


def host_batches(ctx) -> list:
    """The check's batches, as the feed handed them out, on the device."""
    import torch

    return [{k: torch.as_tensor(np.asarray(getattr(b, k)), dtype=torch.long, device=ctx.device)
             for k in ("tokens", "seq_lens", "classes", "labels")} for b in ctx.feed.handed]


def check(ctx) -> None:
    refr = reference_run(ctx.cfg, host_batches(ctx), ctx.seed, ctx.names, ref.Numerics(),
                         ctx.device, start_b=b_starts(ctx.prog))
    found = gaps(ctx.prog, refr, ctx.names)
    ctx.found = found
    lim = ctx.limits
    ctx.checks = [(k, found[k], lim[k], found[k] <= lim[k]) for k in lim]
