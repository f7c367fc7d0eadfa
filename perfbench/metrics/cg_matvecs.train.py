"""cg_matvecs.train: perfbench/readers.py ``cg_matvecs`` for the
``adam`` mix."""

from perfbench.readers import cg_matvecs


def read(ctx):
    return cg_matvecs(ctx, "adam")
