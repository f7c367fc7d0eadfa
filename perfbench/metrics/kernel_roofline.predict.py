"""kernel_roofline.predict: perfbench/readers.py ``kernel_roofline`` for the
``predict`` mix."""

from perfbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "predict")
