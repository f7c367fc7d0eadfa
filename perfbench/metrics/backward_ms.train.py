"""backward_ms.train: perfbench/spans.py device ms per step launched in
``cglb.backward``."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "adam", "cglb.backward")
