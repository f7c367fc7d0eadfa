"""prepare_ms.predict: perfbench/spans.py device ms per request launched in
``cglb.predict.prepare``."""

from perfbench.spans import span_ms


def read(ctx):
    return span_ms(ctx, "predict", "cglb.predict.prepare")
