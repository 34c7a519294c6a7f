"""The share of the traced stretch in which no kernel ran on the device."""

from portbench.records import idle_pct


def read(rec):
    return idle_pct(rec)
