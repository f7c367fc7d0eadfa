"""kernel_roofline.train: perfbench/readers.py ``kernel_roofline`` for the
``adam`` mix."""

from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "adam")
