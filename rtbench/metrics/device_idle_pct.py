"""device_idle_pct.*: the share of the traced slice in which no kernel,
copy or set ran on the card, in %."""

from rtbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
