"""dccl_level_lookup (kernel 1, grid route): its bytes bound over its device time, in %."""

from benchmark import readers


def read(ctx):
    return readers.lookup_roofline(ctx)
