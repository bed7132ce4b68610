"""Share of the result rows (a request's transfer into one class) whose
MIDI the program wrote in its native batched writer, of all the rows its
``results_of`` wrote in the run (warm-up and window), in %: the counters
``results_of.native_rows`` and ``results_of.python_rows``. A program
without those counters gives nothing to read."""


def read(ctx):
    try:
        from musicstyletransfer_torch.inference.service import results_of
    except ImportError:
        return None
    native = getattr(results_of, "native_rows", None)
    python = getattr(results_of, "python_rows", None)
    if native is None or python is None or native + python == 0:
        return None
    return 100.0 * native / (native + python)
