"""The median host milliseconds a train step spends in its ``S|forward``
span (the mixed-precision casts through the model's heads), over the steps
that ran with no profiler (``program_spans.phase_ms``)."""

from portbench import program_spans


def read(rec):
    return program_spans.phase_ms(program_spans.records(), ("S|forward",))
