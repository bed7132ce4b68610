"""PyTorch port, host layers: its own copies of ``midi``, ``data`` and
``cli.flags`` give the JAX package's results exactly, and nothing in the
port (or in ``chip_smoke.py``) imports JAX or the JAX package."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from musicstyletransfer_tpu.cli import flags as jflags
from musicstyletransfer_tpu.data import dataset as jdataset
from musicstyletransfer_tpu.midi import codec as jcodec
from musicstyletransfer_tpu.midi import smf as jsmf
from musicstyletransfer_torch.cli import flags as tflags
from musicstyletransfer_torch.data import dataset as tdataset
from musicstyletransfer_torch.data.loader import Loader
from musicstyletransfer_torch.midi import codec as tcodec
from musicstyletransfer_torch.midi import smf as tsmf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "work", "data", "guitar_bass")
PORT = os.path.join(REPO, "musicstyletransfer_torch")


def corpus_files():
    return sorted(os.path.join(CORPUS, c, f) for c in sorted(os.listdir(CORPUS))
                  if os.path.isdir(os.path.join(CORPUS, c))
                  for f in os.listdir(os.path.join(CORPUS, c)) if f.endswith(".mid"))


@pytest.fixture(scope="module")
def melodies():
    """Both packages' readers over the whole bundled corpus, class by class."""
    out = {}
    for name, codec in (("jax", jcodec), ("torch", tcodec)):
        reader = codec.EventBasedMIDIReader()
        per_class = {}
        for path in corpus_files():
            per_class.setdefault(os.path.basename(os.path.dirname(path)), []).append(
                reader.read_file(path)[0])
        out[name] = per_class
    return out


def test_tokenizers_identical_on_the_corpus():
    files = corpus_files()
    assert len(files) == 37
    jr, tr = jcodec.EventBasedMIDIReader(), tcodec.EventBasedMIDIReader()
    for path in files:
        jm, tm = jr.read_file(path), tr.read_file(path)
        assert len(jm) == len(tm), path
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(a.tokens, b.tokens, err_msg=path)
            assert (a.bpm, a.resolution) == (b.bpm, b.resolution), path
        jtracks, ttracks = jsmf.read_midifile(path).tracks, tsmf.read_midifile(path).tracks
        assert len(jtracks) == len(ttracks), path
        for jt, tt in zip(jtracks, ttracks):
            np.testing.assert_array_equal(jcodec.tokenize_track(jt), tcodec.tokenize_track(tt),
                                          err_msg=path)


def test_writers_write_the_same_bytes(melodies):
    for jm, tm in zip(melodies["jax"]["guitar"][:5], melodies["torch"]["guitar"][:5]):
        jb = jsmf.dump_midifile(jcodec.MelodyWriter().to_midifile(jm))
        tb = tsmf.dump_midifile(tcodec.MelodyWriter().to_midifile(tm))
        assert jb == tb


@pytest.mark.parametrize("L", [16, 64, 512])
def test_layout_and_batches_equal(melodies, L):
    jchunks, jclasses = jdataset.chunk_melodies(melodies["jax"], L)
    tchunks, tclasses = tdataset.chunk_melodies(melodies["torch"], L)
    np.testing.assert_array_equal(jchunks, tchunks)
    np.testing.assert_array_equal(jclasses, tclasses)
    for a, b in zip(jdataset.layout_chunks(jchunks), tdataset.layout_chunks(tchunks)):
        np.testing.assert_array_equal(a, b)
    for layout in (False, True):
        jd = jdataset.MelodyDataset(8, L, melodies["jax"], device_layout=layout)
        td = tdataset.MelodyDataset(8, L, melodies["torch"], device_layout=layout)
        for _ in range(2):  # two epochs: the shuffles stay in step
            for jb, tb in zip(jd, td, strict=True):
                if layout:
                    jb, tb = jb.to_batch(), tb.to_batch()
                for f in ("tokens", "seq_lens", "classes", "labels"):
                    np.testing.assert_array_equal(getattr(jb, f), getattr(tb, f))
                assert jb.num_valid == tb.num_valid


def test_load_dataset_splits_equal(melodies):
    class Loaded:
        def __init__(self, m):
            self.melodies, self.max_sequence_length = m, 64

    jt, jv = jdataset.load_dataset(Loaded(melodies["jax"]), 8, 0.1)
    tt, tv = tdataset.load_dataset(Loaded(melodies["torch"]), 8, 0.1)
    for a, b in ((jt, tt), (jv, tv)):
        np.testing.assert_array_equal(a.chunks, b.chunks)
        np.testing.assert_array_equal(a.classes, b.classes)


def test_loader_reads_the_corpus_and_refuses_the_native_reader():
    """The Loader reads the corpus; by default through the C++ tokenizer
    (it no longer refuses it), with use_native=False through the codec."""
    from musicstyletransfer_torch.midi.native import NativeMIDIReader

    loader = Loader(CORPUS, 64)
    assert sorted(loader.melodies) == ["bass", "guitar"]
    assert sum(len(m) for m in loader.melodies.values()) == 37
    assert isinstance(loader.midi_reader, NativeMIDIReader)
    assert isinstance(Loader(CORPUS, 64, use_native=False).midi_reader,
                      tcodec.EventBasedMIDIReader)


@pytest.mark.parametrize("argv", [
    [],
    ["--batch-size", "8", "--max-seq-len", "512", "--use-flash-attention", "--norm-scheme",
     "pre", "--optimizer-params", "clip_gradient:1.0,skip_nonfinite:10", "--gpu"],
    ["--cpu", "--steps-per-dispatch", "4", "--kl-anneal-steps", "2000", "unknown-arg"],
])
def test_flags_parse_alike(argv):
    assert vars(tflags.get_config(argv)) == vars(jflags.get_config(argv))


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "musicstyletransfer_tpu")


def imported_modules(path):
    """Every module an ``import`` statement of the file names."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


EXAMPLES = [os.path.join(REPO, "examples", f) for f in ("torch_style_transfer.py",
                                                         "torch_gan_generation.py")]


def test_no_jax_import_statement():
    sources = [os.path.join(REPO, "chip_smoke.py")] + EXAMPLES + [
        os.path.join(root, f) for root, _, files in os.walk(PORT) for f in files
        if f.endswith(".py")]
    for path in sources:
        for mod in imported_modules(path):
            assert mod.split(".")[0] not in FORBIDDEN, f"{path} imports {mod}"


def test_port_and_chip_smoke_import_without_jax():
    """In a process where JAX and the JAX package cannot be imported, every
    port module (the serving, sharding, pipeline, native tokenizer, dry-run
    and MIDI CLI modules named among them), every import of chip_smoke.py and the port's two examples
    succeed."""
    code = textwrap.dedent(f"""
        import ast, importlib, importlib.abc, pkgutil, sys
        FORBIDDEN = {FORBIDDEN!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in FORBIDDEN:
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import musicstyletransfer_torch
        for m in pkgutil.walk_packages(musicstyletransfer_torch.__path__,
                                       "musicstyletransfer_torch."):
            importlib.import_module(m.name)
        tree = ast.parse(open({os.path.join(REPO, "chip_smoke.py")!r}).read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), {{}})
        import chip_smoke
        import importlib.util
        for i, path in enumerate({EXAMPLES!r}):
            spec = importlib.util.spec_from_file_location(f"example{{i}}", path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m.split(".")[0] in FORBIDDEN]
        assert not bad, bad
        serving = ("models.transformer", "inference.service", "inference.streaming",
                   "cli.serve", "inference.sharded", "midi.roundtrip", "midi.splitter",
                   "utils", "parallel.pipeline", "parallel.transformer_pipeline",
                   "midi.native", "dryrun")
        missing = [m for m in serving if "musicstyletransfer_torch." + m not in sys.modules]
        assert not missing, missing
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr[-3000:]
