"""precond_ms.train: perfbench/spans.py device ms per step launched in
``cglb.precond``."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "adam", "cglb.precond")
