"""Share of the traced window in which no operation ran on the card, in %."""

from benchmark import readers


def read(ctx):
    return readers.idle_share(ctx)
