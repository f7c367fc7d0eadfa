"""mfu.train: perfbench/readers.py ``mfu`` for the ``adam`` mix."""

from perfbench.readers import mfu


def read(ctx):
    return mfu(ctx, "adam")
