"""host_reads.serve: perfbench/spans.py ``host_reads`` for the ``predict``
mix."""

from perfbench.spans import host_reads


def read(ctx):
    return host_reads(ctx, "predict")
