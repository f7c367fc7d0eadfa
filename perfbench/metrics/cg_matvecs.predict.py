"""cg_matvecs.predict: perfbench/readers.py ``cg_matvecs`` for the
``predict`` mix."""

from perfbench.readers import cg_matvecs


def read(ctx):
    return cg_matvecs(ctx, "predict")
