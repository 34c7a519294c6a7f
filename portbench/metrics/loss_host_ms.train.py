"""The median host milliseconds a train step spends in its ``S|assign`` and
``S|loss`` spans together (target assignment; the loss terms, L2 and the
metrics), over the steps that ran with no profiler
(``program_spans.phase_ms``)."""

from portbench import program_spans


def read(rec):
    return program_spans.phase_ms(program_spans.records(), ("S|assign", "S|loss"))
