"""cg_ms.train: perfbench/spans.py device ms per step launched in
``cglb.cg``."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "adam", "cglb.cg")
