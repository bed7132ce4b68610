"""What the readers of the program's own spans share. The port records
spans at its layer boundaries while a profiler runs
(``musicstyletransfer_torch.tracing``); these are the ones that started in
the traced window, their seconds in it summed by name. A program without that
recorder, or a run without a trace, gives nothing to read."""

from __future__ import annotations

from typing import Dict, Optional, Sequence


def recorded(ctx) -> Optional[list]:
    """The program's spans that started in the traced window, each cut at
    the window's end (a producer thread's span may outlast it), or None."""
    if ctx.trace is None:
        return None
    try:
        from musicstyletransfer_torch import tracing
    except ImportError:  # a program that records no spans
        return None
    end = ctx.trace.end_ns
    return [s._replace(end_ns=min(s.end_ns, end))
            for s in tracing.spans(ctx.trace.start_ns, end)]


def seconds_by_name(ctx) -> Optional[Dict[str, float]]:
    """Seconds of the program's spans in the traced window, by name."""
    spans = recorded(ctx)
    if spans is None:
        return None
    out: Dict[str, float] = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e9
    return out


def us_per(ctx, names: Sequence[str], count) -> Optional[float]:
    """Microseconds of the spans named ``names`` a unit of ``count`` (files,
    steps), or None where none of them was recorded."""
    by = seconds_by_name(ctx)
    if not by or not count or not any(n in by for n in names):
        return None
    return 1e6 * sum(by.get(n, 0.0) for n in names) / count
