"""Share of the optimizer steps on the card that took Adam's update kernel,
of all the run's optimizer steps on the card (warm-up, check steps and
window), in %: the program's counters "adam" (the kernel's launches) and
"adam plain" (steps through the optimizer's chain of torch ops on CUDA
buffers) in ``musicstyletransfer_torch.ops.counters``, which graph replays
count too. A program without those counters gives nothing to read."""


def read(ctx):
    try:
        from musicstyletransfer_torch.ops import counters
    except ImportError:
        return None
    values = counters.read()
    kernel, chain = values.get("adam"), values.get("adam plain")
    if kernel is None or chain is None or kernel + chain == 0:
        return None
    return 100.0 * kernel / (kernel + chain)
