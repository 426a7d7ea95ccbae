"""Kernel launches per pair or training step in the traced window."""

from benchmark import readers


def read(ctx):
    return readers.launches(ctx)
