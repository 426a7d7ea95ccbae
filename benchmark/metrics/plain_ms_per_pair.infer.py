"""Device ms per pair or step in every other kernel but the port's own (samplers, warps, elementwise, copies by kernel)."""

from benchmark import readers


def read(ctx):
    return readers.plain_ms(ctx)
