"""exchanges.mesh: ``cglb.mesh.exchange`` spans per step in rank 0's
traced slice: the mesh's collectives a step.  None on one card, and for a
program without the span."""

from perfbench.spans import timeline

SPAN = "cglb.mesh.exchange"


def read(ctx):
    tl = timeline(ctx, "adam")
    if ctx.chips < 2 or tl is None or not tl.counts[SPAN]:
        return None
    return tl.counts[SPAN] / ctx.slice_units
