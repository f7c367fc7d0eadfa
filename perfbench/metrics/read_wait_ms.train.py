"""read_wait_ms.train: perfbench/spans.py ``read_wait_ms`` for the ``adam``
mix."""

from perfbench.spans import read_wait_ms


def read(ctx):
    return read_wait_ms(ctx, "adam")
