"""Style-transfer quality statistics: the port's own copy of
``musicstyletransfer_tpu/inference/quality.py`` (no reference equivalent —
the reference never measures its outputs; SURVEY.md §6).

Host-side, distribution-level checks of generated token streams:

- termination rate: fraction of sequences that emit EOS before the cap
  (a collapsed or runaway decoder shows up here first);
- generated length stats;
- pitch-class fit: Jensen-Shannon divergence between the pitch-class
  (pitch mod 12) histogram of transfers INTO a class and that class's
  corpus histogram — and, for contrast, the source classes' histogram.
  A working transfer sits closer to the target distribution than to the
  source one.
- content preservation: mean per-row JS between each transfer and ITS OWN
  source sequence, against the same statistic on a ROTATED source row
  (``pitch_js_to_shuffled_source``, the null): a decoder that ignores z
  scores the same on both, a content-preserving one scores own < shuffled.

``transfer_stats`` decodes through the port's ``style_transfer_all_classes``
(K1 on the card, its plain version on the CPU), seeded by an integer: the
batch index added to ``seed``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

import torch

from ..midi.vocab import EOS_ID, PAD_ID, is_note_on, token_pitch


def pitch_class_histogram(token_rows) -> np.ndarray:
    """Normalized pitch-class (mod 12) histogram over note-ON tokens."""
    hist = np.zeros(12, dtype=np.float64)
    for row in token_rows:
        for tok in np.asarray(row).tolist():
            if is_note_on(tok):
                hist[token_pitch(tok) % 12] += 1
    total = hist.sum()
    return hist / total if total else np.full(12, 1.0 / 12)


def octave_histogram(token_rows) -> np.ndarray:
    """Normalized octave (pitch // 12) histogram over note-ON tokens.

    The register complement of ``pitch_class_histogram``: classes like the
    bundled guitar/bass corpus are nearly identical in pitch-class space
    (JS 0.014) but ~19 semitones apart in register — conditioning on such
    classes is only measurable here."""
    hist = np.zeros(11, dtype=np.float64)
    for row in token_rows:
        for tok in np.asarray(row).tolist():
            if is_note_on(tok):
                hist[token_pitch(tok) // 12] += 1
    total = hist.sum()
    return hist / total if total else np.full(11, 1.0 / 11)


def js_divergence(p: np.ndarray, q: np.ndarray, eps: float = 1e-12) -> float:
    """Jensen-Shannon divergence (natural log; 0 <= JS <= ln 2)."""
    p = np.asarray(p, np.float64) + eps
    q = np.asarray(q, np.float64) + eps
    p /= p.sum()
    q /= q.sum()
    m = 0.5 * (p + q)
    kl = lambda a, b: float(np.sum(a * np.log(a / b)))  # noqa: E731
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def transfer_stats(
    model,
    dataset,
    num_classes: int,
    max_batches: int = 4,
    seed: int = 0,
) -> Dict[str, float]:
    """Run all-classes transfer over up to ``max_batches`` batches and
    summarize output quality. Returns flat floats (JSON-ready). ``model``
    is a ``StyleVAE`` on its device (the transfers run there)."""
    from .decode import style_transfer_all_classes

    # ONE pass over the dataset (works for single-pass iterables): the
    # corpus pitch-class profile accumulates over every batch; transfers
    # run on the first ``max_batches``. Wrap-padded duplicate rows
    # (Batch.n_valid) are masked out of both, so the statistics are
    # invariant to --batch-size.
    class_rows: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    n_seqs = 0
    n_terminated = 0
    lengths: List[int] = []
    transfer_rows: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    source_hists: List[np.ndarray] = []
    own_source_js: List[float] = []
    shuffled_source_js: List[float] = []
    device = model.device
    for bi, batch in enumerate(dataset):
        b = batch.to_batch() if hasattr(batch, "to_batch") else batch
        nv = getattr(b, "num_valid", None)
        nv = int(nv) if nv is not None else int(b.tokens.shape[0])
        tokens_np = np.asarray(b.tokens)
        for row, cls in zip(tokens_np[:nv], np.asarray(b.classes)[:nv]):
            class_rows[int(cls)].append(row)
        if bi >= max_batches:
            continue  # keep accumulating the corpus profile
        seqs, _ = style_transfer_all_classes(
            model,
            torch.as_tensor(tokens_np, dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(b.seq_lens), dtype=torch.long, device=device),
            max_len=2 * int(b.tokens.shape[1]),
            num_classes=num_classes, seed=seed + bi,
        )
        seqs = seqs.cpu().numpy()  # [C, B, T]
        for c in range(num_classes):
            for i, row in enumerate(seqs[c, :nv]):
                n_seqs += 1
                if np.any(row == EOS_ID):
                    n_terminated += 1
                lengths.append(int(np.sum(row != PAD_ID)) - 1)  # minus SOS
                transfer_rows[c].append(row)
                row_hist = pitch_class_histogram([row])
                own_source_js.append(js_divergence(
                    row_hist, pitch_class_histogram([tokens_np[i]])
                ))
                # Null for content preservation: the same statistic
                # against a DIFFERENT (rotated) source row. z carrying
                # row-specific content shows up as own < shuffled.
                shuffled_source_js.append(js_divergence(
                    row_hist,
                    pitch_class_histogram([tokens_np[(i + 1) % nv]]),
                ))
        source_hists.append(pitch_class_histogram(tokens_np[:nv]))
    corpus_hist = [pitch_class_histogram(rows) for rows in class_rows]
    corpus_oct = [octave_histogram(rows) for rows in class_rows]

    source_hist = (
        np.mean(source_hists, axis=0) if source_hists
        else np.full(12, 1.0 / 12)
    )
    target_js, source_js, target_oct_js, other_oct_js = [], [], [], []
    for c in range(num_classes):
        h = pitch_class_histogram(transfer_rows[c])
        target_js.append(js_divergence(h, corpus_hist[c]))
        source_js.append(js_divergence(h, source_hist))
        # Octave (register) fit: classes like the bundled guitar/bass are
        # nearly identical in pitch-class space (JS 0.014) but ~19
        # semitones apart in register — class-conditioning quality on such
        # corpora is only measurable here.
        ho = octave_histogram(transfer_rows[c])
        target_oct_js.append(js_divergence(ho, corpus_oct[c]))
        others = [js_divergence(ho, corpus_oct[o])
                  for o in range(num_classes) if o != c]
        if others:
            other_oct_js.append(float(np.mean(others)))
    return {
        "transfer_sequences": float(n_seqs),
        "termination_rate": n_terminated / max(n_seqs, 1),
        "mean_generated_len": float(np.mean(lengths)) if lengths else 0.0,
        "pitch_js_to_target_class": float(np.mean(target_js)),
        "pitch_js_to_source_mix": float(np.mean(source_js)),
        "pitch_js_to_own_source": (
            float(np.mean(own_source_js)) if own_source_js else 0.0
        ),
        "pitch_js_to_shuffled_source": (
            float(np.mean(shuffled_source_js)) if shuffled_source_js else 0.0
        ),
        "octave_js_to_target_class": float(np.mean(target_oct_js)),
        "octave_js_to_other_classes": (
            float(np.mean(other_oct_js)) if other_oct_js else 0.0
        ),
    }


def class_conditional_stats(
    generated: Dict[int, List[np.ndarray]],
    corpus: Dict[int, List[np.ndarray]],
) -> Dict[str, float]:
    """Unconditional-generation quality (the GAN family's analogue of
    ``transfer_stats``): per class, the JS divergence between generated
    samples' pitch-class histogram and (a) the SAME class's corpus profile
    vs (b) the other classes' profiles. Class conditioning works iff
    own-class JS < other-class JS. Also reports note-event structure
    (note-on fraction, mean token length) — a degenerate generator (all
    timeshifts, or no notes at all) shows up there."""
    corpus_hist = {c: pitch_class_histogram(rows)
                   for c, rows in corpus.items()}
    corpus_oct = {c: octave_histogram(rows) for c, rows in corpus.items()}
    own_js, other_js, lengths, note_on_frac = [], [], [], []
    own_oct, other_oct = [], []
    for c, rows in generated.items():
        h = pitch_class_histogram(rows)
        own_js.append(js_divergence(h, corpus_hist[c]))
        others = [js_divergence(h, corpus_hist[o])
                  for o in corpus_hist if o != c]
        if others:
            other_js.append(float(np.mean(others)))
        ho = octave_histogram(rows)
        own_oct.append(js_divergence(ho, corpus_oct[c]))
        others_o = [js_divergence(ho, corpus_oct[o])
                    for o in corpus_oct if o != c]
        if others_o:
            other_oct.append(float(np.mean(others_o)))
        for row in rows:
            row = np.asarray(row)
            lengths.append(int(row.size))
            if row.size:
                ons = sum(1 for t in row.tolist() if is_note_on(int(t)))
                note_on_frac.append(ons / row.size)
    return {
        "gen_sequences": float(sum(len(r) for r in generated.values())),
        "gen_mean_len": float(np.mean(lengths)) if lengths else 0.0,
        "gen_note_on_fraction": (
            float(np.mean(note_on_frac)) if note_on_frac else 0.0
        ),
        "gen_pitch_js_to_own_class": float(np.mean(own_js)),
        "gen_pitch_js_to_other_classes": (
            float(np.mean(other_js)) if other_js else 0.0
        ),
        "gen_octave_js_to_own_class": float(np.mean(own_oct)),
        "gen_octave_js_to_other_classes": (
            float(np.mean(other_oct)) if other_oct else 0.0
        ),
    }
