"""mfu.serve: perfbench/readers.py ``mfu`` for a
``predict`` mix at a fixed rate."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, "predict")
