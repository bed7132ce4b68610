"""PyTorch port, the small modules against the JAX package (CPU):

- the piano roll (``utils.melody_to_piano_roll``) equals the JAX function's
  on every corpus melody, and ``cli.sample --visualize-samples`` writes a
  ``<file>.mid.png`` beside each MIDI file it writes (ROADMAP queue 3,
  fault 2);
- no sampler entry point falls back to the CPU: without a device and
  without a card each raises ``resolve_device``'s message (fault 1);
- a training run's TensorBoard scalars equal its ``scalars.jsonl``, under
  the JAX trainer's tags (fault 3);
- ``midi.roundtrip`` and ``midi.splitter`` write the JAX CLIs' files byte
  for byte on corpus files;
- ``examples/torch_style_transfer.py --cpu`` writes one MIDI file a class
  that parses back.
"""

import glob
import json
import os
import runpy
import shutil

import numpy as np
import pytest
import torch

from musicstyletransfer_tpu import utils as jutils
from musicstyletransfer_tpu.midi import codec as jcodec
from musicstyletransfer_tpu.midi import roundtrip as jroundtrip
from musicstyletransfer_tpu.midi import splitter as jsplitter
from musicstyletransfer_torch import utils
from musicstyletransfer_torch.cli import main as cli_main
from musicstyletransfer_torch.cli import sample as cli_sample
from musicstyletransfer_torch.inference import sampler
from musicstyletransfer_torch.midi import codec, roundtrip, smf, splitter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
MODEL = os.path.join(REPO, "models", "guitar_bass")
CORPUS_FILES = sorted(glob.glob(os.path.join(CORPUS, "*", "*.mid")))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The suite runs several workers on one host; two torch threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_piano_roll_matches_jax_on_the_corpus():
    """Every melody of every corpus file: the same [128, T] roll."""
    reader, jreader = codec.EventBasedMIDIReader(), jcodec.EventBasedMIDIReader()
    n = 0
    for path in CORPUS_FILES:
        for m, jm in zip(reader.read_file(path), jreader.read_file(path)):
            want = jutils.melody_to_piano_roll(jm)
            got = utils.melody_to_piano_roll(m)
            assert np.array_equal(got, want), path
            n += 1
    assert n >= len(CORPUS_FILES) == 37


def tiny_corpus(tmp_path, files=1):
    """A corpus of ``files`` short files a class (the first 40 events of
    the class's first corpus files), for a short CPU run."""
    data = tmp_path / "data"
    reader, writer = codec.EventBasedMIDIReader(), codec.MelodyWriter()
    for cls in ("bass", "guitar"):
        (data / cls).mkdir(parents=True)
        for i, path in enumerate(sorted(glob.glob(os.path.join(CORPUS, cls, "*.mid")))[:files]):
            melody = reader.read_file(path)[0]
            writer.write_to_file(str(data / cls / f"short{i}.mid"),
                                 codec.melody_from_ids(melody.tokens[:40]))
    return str(data)


def note_ons(path):
    return sum(isinstance(ev, smf.NoteOn) and ev.velocity > 0
               for track in smf.read_midifile(path).tracks for ev in track)


def test_cli_sample_visualize_samples_writes_pngs(tmp_path):
    """``cli.sample --cpu --visualize-samples`` on the shipped model writes a
    piano-roll PNG beside each MIDI file that holds notes (and beside no
    other file), and none without the flag."""
    pytest.importorskip("matplotlib")
    data = tiny_corpus(tmp_path)
    for flag, out in (([], tmp_path / "plain"), (["--visualize-samples"], tmp_path / "png")):
        cli_sample.main(["--cpu", "--model-output", MODEL, "--data", data, "--out-samples",
                         str(out), "--max-seq-len", "16", "--batch-size", "8", *flag])
        mids = sorted(glob.glob(str(out / "*.mid")))
        assert len(mids) >= 6
        pngs = set(glob.glob(str(out / "*.mid.png")))
        if not flag:
            assert not pngs
            continue
        assert pngs <= {m + ".png" for m in mids}
        with_notes = {m + ".png" for m in mids if note_ons(m)}
        assert with_notes and with_notes <= pngs
        for png in pngs:
            with open(png, "rb") as f:
                assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_sampler_entry_points_need_a_card_or_a_device(monkeypatch):
    """ROADMAP queue 3, fault 1: without ``device`` and without a card, each
    sampler entry point raises instead of decoding on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = cli_sample.get_config(["--beam-size", "2"])
    calls = [lambda: sampler.load_inference_model(MODEL, -1),
             lambda: sampler.get_sampler("sampling", MODEL, -1, args),
             lambda: sampler.get_sampler("beam-search", MODEL, -1, args),
             lambda: sampler.SamplerBase(MODEL, -1),
             lambda: sampler.Sampling(MODEL, -1),
             lambda: sampler.BeamSearchSampler(MODEL, -1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            call()
    model = sampler.load_inference_model(MODEL, -1, torch.device("cpu"))
    assert sampler.Sampling(None, None, model=model).device == torch.device("cpu")


def test_tensorboard_scalars_equal_scalars_jsonl(tmp_path):
    """ROADMAP queue 3, fault 3: a tiny ``cli.main --cpu`` run writes
    TensorBoard event files where tensorboardX imports, under the JAX
    trainer's tags (the scalar names), whose values equal
    ``scalars.jsonl``'s line for line."""
    pytest.importorskip("tensorboardX")
    event_accumulator = pytest.importorskip(
        "tensorboard.backend.event_processing.event_accumulator")
    logdir = tmp_path / "log"
    cli_main.main(["--cpu", "--data", tiny_corpus(tmp_path, 2), "--model-output",
                   str(tmp_path / "m"), "--logdir", str(logdir), "--batch-size", "4",
                   "--max-seq-len", "16", "--epochs", "1", "--e-rnn-hidden-dim", "16",
                   "--e-num-heads", "2", "--latent-dim", "8", "--d-rnn-hidden-dim", "16",
                   "--log-every", "1", "--checkpoint-frequency", "2",
                   "--validation-split", "0.5"])
    acc = event_accumulator.EventAccumulator(str(logdir))
    acc.Reload()
    events = {(tag, e.step): e.value for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}
    lines = [json.loads(x) for x in (logdir / "scalars.jsonl").read_text().splitlines()]
    want = {(k, line["step"]): v for line in lines for k, v in line.items() if k != "step"}
    assert any(k[0] == "ce_loss" for k in want) and any(k[0].startswith("validation_")
                                                        for k in want)
    assert set(events) == set(want)
    for key, v in want.items():
        assert events[key] == pytest.approx(v, rel=1e-6), key


@pytest.mark.parametrize("path", CORPUS_FILES[::9])
def test_roundtrip_cli_writes_the_jax_clis_bytes(tmp_path, path, capsys):
    """``midi.roundtrip FILE OUT``: the file and the printed lines of the
    JAX CLI."""
    outs = {}
    for name, cli in (("jax", jroundtrip), ("torch", roundtrip)):
        out = tmp_path / f"{name}.mid"
        cli.main([path, str(out)])
        outs[name] = (out.read_bytes(), capsys.readouterr().out.replace(str(out), "OUT"))
    assert outs["torch"] == outs["jax"]
    smf.parse_midifile(outs["torch"][0])


def test_splitter_cli_writes_the_jax_clis_bytes(tmp_path, capsys):
    """``midi.splitter IN OUT`` on a corpus class folder: the same file
    names and bytes as the JAX CLI; an unreadable file is skipped by both."""
    src = tmp_path / "in"
    shutil.copytree(os.path.join(CORPUS, "bass"), src)
    (src / "broken.mid").write_bytes(b"MThd\x00")
    written = {}
    for name, cli in (("jax", jsplitter), ("torch", splitter)):
        out = tmp_path / name
        cli.main([str(src), str(out)])
        assert "Skipping" in capsys.readouterr().out
        written[name] = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    assert written["torch"] == written["jax"]
    assert len(written["torch"]) >= 4


def test_style_transfer_example_on_the_cpu(tmp_path, capsys):
    """``examples/torch_style_transfer.py --cpu``: one MIDI file a class of
    the shipped model, each parsing back with events."""
    example = os.path.join(REPO, "examples", "torch_style_transfer.py")
    mod = runpy.run_path(example)
    mod["main"]([CORPUS_FILES[0], MODEL, str(tmp_path), "--cpu"])
    files = sorted(tmp_path.glob("*.class-*.mid"))
    assert len(files) == 2
    for f in files:
        assert len(codec.EventBasedMIDIReader().read_file(str(f))[0]) > 0
    assert capsys.readouterr().out.count("class ") == 2
