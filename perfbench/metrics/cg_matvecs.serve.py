"""cg_matvecs.serve: perfbench/readers.py ``cg_matvecs`` for a
``predict`` mix at a fixed rate."""

from perfbench.readers import cg_matvecs


def read(ctx):
    return cg_matvecs(ctx, "predict")
