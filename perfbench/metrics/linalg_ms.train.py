"""linalg_ms.train: perfbench/readers.py ``linalg_ms`` for the ``adam`` mix."""

from perfbench.readers import linalg_ms


def read(ctx):
    return linalg_ms(ctx, "adam")
