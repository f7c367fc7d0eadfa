"""comm_ms.mesh: rank 0's device ms per step launched inside
``cglb.mesh.exchange`` (the NCCL kernels of the mesh's collectives and
their copies; perfbench/spans.py ``span_ms``).  None on one card, and for a
program without the span."""

from perfbench.spans import span_ms, timeline

SPAN = "cglb.mesh.exchange"


def read(ctx):
    tl = timeline(ctx, "adam")
    if ctx.chips < 2 or tl is None or not tl.counts[SPAN]:
        return None
    return span_ms(ctx, "adam", SPAN)
