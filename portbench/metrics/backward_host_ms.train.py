"""The median host milliseconds a train step spends in its ``S|backward``
span (``torch.autograd.grad`` until it returns), over the steps that ran
with no profiler (``program_spans.phase_ms``)."""

from portbench import program_spans


def read(rec):
    return program_spans.phase_ms(program_spans.records(), ("S|backward",))
