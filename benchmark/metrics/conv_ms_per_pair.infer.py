"""Device ms per pair or step in convolution and matrix-product kernels (cuDNN, cuBLAS)."""

from benchmark import readers


def read(ctx):
    return readers.conv_ms(ctx)
