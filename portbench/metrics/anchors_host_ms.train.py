"""The median host milliseconds a train step spends in its ``S|anchors``
span, over the steps that ran with no profiler (``program_spans.phase_ms``):
the anchors' copy to the card from pageable host memory, which returns only
once the device has run what was queued before it, so it holds the host's
wait for the previous step."""

from portbench import program_spans


def read(rec):
    return program_spans.phase_ms(program_spans.records(), ("S|anchors",))
