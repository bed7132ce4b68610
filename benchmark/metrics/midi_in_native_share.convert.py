"""Share of the request files that the program tokenized in its native
request tokenizer, of all the files its ``tokens_from_midi`` tokenized in
the run (warm-up and window), in %: the counters
``tokens_from_midi.native_files`` and ``tokens_from_midi.python_files``. A
program without those counters gives nothing to read."""


def read(ctx):
    try:
        from musicstyletransfer_torch.inference.service import tokens_from_midi
    except ImportError:
        return None
    native = getattr(tokens_from_midi, "native_files", None)
    python = getattr(tokens_from_midi, "python_files", None)
    if native is None or python is None or native + python == 0:
        return None
    return 100.0 * native / (native + python)
