"""device_idle_pct: the share of the traced part of a search window in which
no device activity ran: 1 - (union of device intervals) / (traced span)."""

from portbench.devtrace import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
