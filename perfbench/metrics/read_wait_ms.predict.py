"""read_wait_ms.predict: perfbench/spans.py ``read_wait_ms`` for the
``predict`` mix."""

from perfbench.spans import read_wait_ms


def read(ctx):
    return read_wait_ms(ctx, "predict")
