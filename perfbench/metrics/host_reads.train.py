"""host_reads.train: perfbench/spans.py ``host_reads`` for the ``adam`` mix."""

from perfbench.spans import host_reads


def read(ctx):
    return host_reads(ctx, "adam")
