"""idle_share.train: perfbench/readers.py ``idle_share`` for the
``adam`` mix."""

from perfbench.readers import idle_share


def read(ctx):
    return idle_share(ctx, "adam")
