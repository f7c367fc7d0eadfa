"""idle_share.serve: perfbench/readers.py ``idle_share`` for a
``predict`` mix at a fixed rate."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "predict")
