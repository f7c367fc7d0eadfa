"""cg_ms.serve: perfbench/spans.py device ms per request launched in
``cglb.cg``."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "predict", "cglb.cg")
