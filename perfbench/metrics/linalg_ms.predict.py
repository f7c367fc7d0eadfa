"""linalg_ms.predict: perfbench/readers.py ``linalg_ms`` for the
``predict`` mix."""

from perfbench.readers import linalg_ms


def read(ctx):
    return linalg_ms(ctx, "predict")
