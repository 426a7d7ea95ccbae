"""The whole step's FLOPs over the traced window, against the card's peak for its arithmetic, in %."""

from benchmark import readers


def read(ctx):
    return readers.mfu(ctx)
