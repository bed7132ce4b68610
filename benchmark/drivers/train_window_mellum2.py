"""Training throughput of the VAE with one Mellum2 period as its decoder:
``train_window``'s feed, stages A/B and window, with this configuration's
``model_config``, reference (``reference/mellum2.py``) and counts
(``counts_mellum2``).

The port's ``ModelConfig`` is built with keyword arguments: a program
without the decoder's fields fails at set-up with a ``TypeError`` (a
dictionary through ``from_dict`` would drop the unknown keys and train the
old block).

The check keeps to the host's memory at 1.69B parameters (6.8 GB a float32
vector): stage B has ``B_GROUPS`` = 2 one-step groups, each started from
the program's whole state (parameters and moments, held on the host), and
the whole-vector errors (``grad_error``, ``moment2_error``,
``b_grad_error``, ``b_moment2_error``) are taken over every ``STRIDE``-th
coordinate of the program's flat layout, from an offset drawn from the
seed (a uniform eighth of 1.69B coordinates). Every per-leaf norm is taken
whole. After the window the run also reads the experts' load
(``MoE.load``) and the flash launches of the window's steps.
"""

from __future__ import annotations

import counts_mellum2
from harness import BENCH, ROOT, load_module, log, sync
from reference import mellum2 as mref
from reference import smf

tw = load_module(BENCH / "drivers" / "train_window.py", "train_window_for_mellum2")
tw.counts = counts_mellum2  # the window's FLOP and flash counts

B_GROUPS = 2
STRIDE = 8

host_batches = tw.host_batches
b_starts = tw.b_starts
gaps = tw.gaps
release_base = tw.release


def model_config(cfg: dict):
    """The port's ``ModelConfig`` of the configuration file."""
    from musicstyletransfer_torch.models.config import (DecoderConfig, EncoderConfig,
                                                        ModelConfig, TransformerConfig)

    e = cfg["encoder"]
    encoder = TransformerConfig(
        model_size=e["model_size"], dropout=e["dropout"], num_layers=e["num_layers"],
        num_heads=e["num_heads"], vocab_size=cfg["vocab_size"],
        ffn_multiplier=e["ffn_multiplier"], use_flash_attention=cfg["use_flash_attention"],
        norm_scheme=e["norm_scheme"])
    full, sliding = (cfg["rope_parameters"][k] for k in ("full_attention", "sliding_attention"))
    assert sliding["rope_type"] == "default" and full["rope_type"] == "yarn"
    assert full["rope_theta"] == sliding["rope_theta"] and cfg["norm_topk_prob"]
    decoder = TransformerConfig(
        model_size=cfg["hidden_size"], dropout=0.0, num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], vocab_size=cfg["vocab_size"],
        use_flash_attention=cfg["use_flash_attention"], norm_scheme="pre",
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        layer_types=tuple(cfg["layer_types"]), sliding_window=cfg["sliding_window"],
        bias=cfg["attention_bias"], norm="rmsnorm", ffn="moe",
        num_experts=cfg["num_experts"], experts_per_token=cfg["num_experts_per_tok"],
        expert_width=cfg["moe_intermediate_size"],
        positions="rope", rope_theta=float(full["rope_theta"]),
        yarn_factor=float(full["factor"]),
        yarn_original_max_positions=full["original_max_position_embeddings"],
        yarn_beta_fast=float(full["beta_fast"]), yarn_beta_slow=float(full["beta_slow"]),
        yarn_attention_factor=float(full["attention_factor"]))
    return ModelConfig(
        encoder_config=EncoderConfig(transformer_config=encoder, latent_dim=cfg["latent_dim"],
                                     num_classes=cfg["num_classes"], input_dim=cfg["vocab_size"]),
        decoder_config=DecoderConfig(transformer_config=decoder, latent_dim=cfg["latent_dim"],
                                     num_classes=cfg["num_classes"],
                                     output_dim=cfg["vocab_size"],
                                     class_conditioning=cfg["class_conditioning"]),
        dtype=cfg["dtype"])


def pick(vec, offset: int):
    """Every ``STRIDE``-th coordinate of a flat vector from ``offset``, on
    the host."""
    return vec[offset::STRIDE].to("cpu", copy=True)


def change_norms(opt, start) -> list:
    """Each leaf's norm of the optimizer's parameters less ``start`` (the
    flat parameters on the host), a leaf at a time on the device: the card
    has no room for a whole vector beside the captured step."""
    out, at = [], 0
    for view in opt.views(opt.flat):
        n = view.numel()
        out.append(float((view - start[at:at + n].to(view.device).view_as(view)).norm()))
        at += n
    return out


def moe_layers(model) -> list:
    from musicstyletransfer_torch.models.moe import MoE

    return [m for m in model.modules() if isinstance(m, MoE)]


def setup(ctx) -> None:
    from musicstyletransfer_torch.convert import flax_names
    from musicstyletransfer_torch.data.prefetch import PrefetchingDataset
    from musicstyletransfer_torch.models.vae import StyleVAE
    from musicstyletransfer_torch.training.optimizer import OptimizerConfig
    from musicstyletransfer_torch.training.trainer import TrainConfig, Trainer

    cfg, t = ctx.cfg, ctx.cfg["train"]
    n, groups = tw.check_groups(t)
    with ctx.phase("data"):
        chunks, classes = smf.corpus_chunks(str(ROOT / ctx.traffic["data"]), t["max_seq_len"])
        ctx.feed = tw.Feed(smf.layout(chunks), classes, t["batch_size"], ctx.seed,
                           n * (groups + B_GROUPS))
    with ctx.phase("weights"):
        model = StyleVAE(model_config(cfg)).to(ctx.device)
        params = mref.init_params(cfg, ctx.seed, ctx.device)
        tw.load_weights(model, params)
        del params
        trainer = Trainer(TrainConfig(
            batch_size=t["batch_size"], optimizer=OptimizerConfig(
                t["optimizer"], t["optimizer_params"], t["learning_rate"]),
            kl_loss_weight=t["kl_loss"], kl_anneal_steps=t["kl_anneal_steps"],
            free_bits=t["free_bits"], label_smoothing=t["label_smoothing"],
            logdir=str(ROOT / "build" / "bench"), seed=ctx.seed + 1,
            steps_per_dispatch=t["steps_per_dispatch"], prefetch=ctx.traffic["prefetch"]),
            model)
        ctx.trainer, ctx.model = trainer, model
        ctx.it = iter(PrefetchingDataset(ctx.feed, ctx.traffic["prefetch"], ctx.device))
    opt = trainer.optimizer
    extra = mref.optimizer_params(cfg)
    b1, b2 = extra.get("beta1", 0.9), extra.get("beta2", 0.999)
    ctx.offset = int(ctx.seed) % STRIDE
    ctx.prog = {"loss": [], "b": []}
    with ctx.phase("check_steps"):
        sync(ctx.device)
        start = opt.flat.to("cpu", copy=True)
        total = trainer.state.names.index("total_loss")
        for k in range(groups + B_GROUPS):
            if k == groups:
                ctx.prog["change"] = change_norms(opt, start)
                del start
            if k >= groups:  # a group of stage B starts from the program's state here
                a = tw.snapshot(opt)
            trainer.state.reset_metrics()
            trainer.train_batches([next(ctx.it).tensors for _ in range(n)])
            sync(ctx.device)
            loss = float(trainer.state.sums[total])
            if k < groups:
                ctx.prog["loss"].append(loss)
            else:
                ctx.prog["b"].append({
                    "start": a, "loss": loss,
                    "dmu": pick(opt.state["mu"], ctx.offset) - b1 ** n * a["mu"][ctx.offset::STRIDE],
                    "dnu": pick(opt.state["nu"], ctx.offset) - b2 ** n * a["nu"][ctx.offset::STRIDE],
                    "change": change_norms(opt, a["flat"])})
            if k == 0:  # the bias-corrected moments, scaled on the host
                c1, c2 = 1 - b1 ** n, 1 - b2 ** n
                ctx.prog["grad"] = [x / c1 for x in tw.norms(opt, opt.state["mu"])]
                ctx.prog["grad_vec"] = pick(opt.state["mu"], ctx.offset) / c1
                ctx.prog["grad2_vec"] = pick(opt.state["nu"], ctx.offset) / c2
    with ctx.phase("warmup"):
        for _ in range(ctx.traffic["warmup_groups"]):
            trainer.train_batches([next(ctx.it).tensors for _ in range(n)])
        sync(ctx.device)
    ctx.names = flax_names(model)
    log(f"train set-up: {len(classes)} rows of {t['max_seq_len']}, batch {t['batch_size']}, "
        f"{n} steps a group; the check's group losses {ctx.prog['loss']}")


def window(ctx) -> None:
    layers = moe_layers(ctx.model)
    for m in layers:
        m.load.zero_()
    launches = {k: getattr(fn, a) for k, (fn, a) in _launch_counters().items()}
    tw.window(ctx)
    loads = [m.load.tolist() for m in layers]
    ctx.work["expert_load"] = max(max(c) / (sum(c) / len(c)) for c in loads if sum(c) > 0)
    ctx.work["flash_launches"] = {k: getattr(fn, a) - launches[k]
                                  for k, (fn, a) in _launch_counters().items()}
    t, cfg = ctx.cfg["train"], ctx.cfg
    rows = t["batch_size"] * (t["max_seq_len"] + 2) * cfg["num_experts_per_tok"]
    ctx.work["expert_gemm_bound_s"] = ctx.work["steps"] * counts_mellum2.expert_gemm_bound_s(
        cfg, rows)
    log(f"window: experts' load, busiest over mean by layer "
        f"{[round(max(c) / max(1e-9, sum(c) / len(c)), 3) for c in loads]}; flash "
        f"launches {ctx.work['flash_launches']}")


def _launch_counters() -> dict:
    from musicstyletransfer_torch.ops import flash_attention as fa

    return {f"{name} {attr}": (fn, attr) for name, fn in (("K4", fa.flash_forward),
                                                          ("K5", fa.flash_backward))
            for attr in ("launches", "tc_launches", "windowed_launches", "grouped_launches")}


def release(ctx) -> None:
    release_base(ctx)
    ctx.model = None


def reference_run(cfg, batches, seed, names, numerics, device, start_b=None) -> dict:
    """``train_window.reference_run`` in this check's form: stage A from the
    seeded weights; each group of stage B from ``start_b`` (the program's
    states) or on from its own; whole vectors as every ``STRIDE``-th
    coordinate from the seed's offset."""
    import torch

    n, groups = tw.check_groups(cfg["train"])
    extra = mref.optimizer_params(cfg)
    b1, b2 = extra.get("beta1", 0.9), extra.get("beta2", 0.999)
    offset = int(seed) % STRIDE

    def flat(leaves):  # the program's layout: kernels [out, in]
        return torch.cat([(leaves[k].t() if k.endswith("/kernel") else leaves[k]).reshape(-1)
                          for k in names])

    def picked(leaves):
        return pick(flat(leaves), offset)

    shapes = mref.shapes(cfg)

    def leaves(vec):
        out, at = {}, 0
        vec = vec.to(device)
        for k in names:
            shape, size = shapes[k], 1
            for s in shape:
                size *= s
            piece = vec[at:at + size]
            at += size
            out[k] = piece.reshape(shape[::-1]).t() if k.endswith("/kernel") else \
                piece.reshape(shape)
        return out

    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    with mref.no_tf32():
        p0 = mref.init_params(cfg, seed, device)
        r = mref.train_steps(p0, cfg, batches[:n * groups], gen, numerics, moment_after=n)
        out = {"loss": [sum(r["loss"][g * n:(g + 1) * n]) for g in range(groups)],
               "grad": [float(r["grad"][k].norm()) for k in names],
               "change": [float((r["params"][k] - p0[k]).norm()) for k in names],
               "grad_vec": picked(r["grad"]), "grad2_vec": picked(r["grad2"]), "b": []}
        del p0
        r.pop("grad"), r.pop("grad2")
        for g in range(B_GROUPS):
            if start_b is None:
                pb, m0, v0, step0 = r["params"], r["m"], r["v"], n * (groups + g)
            else:
                sb = start_b[g]
                pb, m0, v0, step0 = (leaves(sb["flat"]), leaves(sb["mu"]), leaves(sb["nu"]),
                                     sb["count"])
            del r
            at = n * (groups + g)
            r = mref.train_steps(pb, cfg, batches[at:at + n], gen, numerics, moment_after=None,
                                 step0=step0, m0=m0, v0=v0)
            out["b"].append({"start": None, "loss": sum(r["loss"]),
                             "dmu": picked(r["m"]) - b1 ** n * picked(m0),
                             "dnu": picked(r["v"]) - b2 ** n * picked(v0),
                             "change": [float((r["params"][k] - pb[k]).norm()) for k in names]})
            del pb, m0, v0
        del r
    return out


def check(ctx) -> None:
    refr = reference_run(ctx.cfg, host_batches(ctx), ctx.seed, ctx.names, mref.Numerics(),
                         ctx.device, start_b=b_starts(ctx.prog))
    found = gaps(ctx.prog, refr, ctx.names)
    ctx.found = found
    lim = ctx.limits
    ctx.checks = [(k, found[k], lim[k], found[k] <= lim[k]) for k in lim]
    log(f"check: {({k: v for k, v in found.items() if k != 'left_out'})}")

