"""mfu.predict: perfbench/readers.py ``mfu`` for the ``predict`` mix."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, "predict")
