"""Host microseconds a file in the program's detokenizing and MIDI writing
(its ``service.detokenize`` and ``service.midi_write`` spans in
``StyleTransferService._finish``) over the traced window."""

import program_spans


def read(ctx):
    return program_spans.us_per(ctx, ("service.detokenize", "service.midi_write"),
                                ctx.attempted)
