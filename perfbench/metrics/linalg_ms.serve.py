"""linalg_ms.serve: perfbench/readers.py ``linalg_ms`` for a
``predict`` mix at a fixed rate."""

from perfbench.readers import linalg_ms


def read(ctx):
    return linalg_ms(ctx, "predict")
