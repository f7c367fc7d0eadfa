"""idle_share.predict: perfbench/readers.py ``idle_share`` for the
``predict`` mix."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "predict")
