"""kernel_roofline.serve: perfbench/readers.py ``kernel_roofline`` for a
``predict`` mix at a fixed rate."""

from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "predict")
