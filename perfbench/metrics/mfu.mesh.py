"""mfu.mesh: the operations the window's Adam steps need, counted as
``mfu.train`` counts one card's step of the same configuration, over the
window's host-clock time, ``ctx.chips`` cards and 67 TFLOP/s, in %.

What the ranks launch does not enter: a rank's kernels 1-2 run the general
path over all N rows against its N / R columns, where one card's symmetric
path takes each pair once.  So each of rank 0's kernel 1-2 calls counts as
one card's symmetric call at the whole N (its batch width and D), Kuf counts
once a step at M x N, and the dense algebra is ``counts.
cglb_step_dense_flops`` with the preconditioner applies of one card's step:
one a CG matvec (every matvec of the step but the bound's own) and two
more.  A change that splits the work better over the ranks then reads as a
gain, and a rank's redundant work never does."""

from collections import defaultdict

from perfbench import counts


def step_flops(calls, n: int, m: int) -> float:
    """The operations one step needs, from one rank's kernel calls in it."""
    flops = 0.0
    matvecs = 0
    kuf_d = None
    for c in calls:
        if c.kind == "matvec":
            matvecs += 1
            flops += counts.matvec_flops(n, n, c.d, c.b, symmetric=True)
        elif c.kind == "ls_grad":
            flops += counts.ls_grad_flops(n, n, c.d, c.b, symmetric=True)
        else:
            kuf_d = c.d
    if kuf_d is not None:
        flops += counts.kuf_flops(m, n, kuf_d)
    # one card: CG's matvecs are the step's matvecs but the bound's own
    return flops + counts.cglb_step_dense_flops(n, m, matvecs - 1 + 2)


def read(ctx):
    if (ctx.kind != "adam" or ctx.chips < 2 or not ctx.unit_calls
            or ctx.seconds <= 0 or ctx.config["model"] != "cglb"):
        return None
    by_step = defaultdict(list)
    for unit, c in ctx.unit_calls:
        by_step[unit].append(c)
    n, m = ctx.config["n_train"], ctx.config["num_inducing"]
    flops = sum(step_flops(calls, n, m) for calls in by_step.values())
    return 100.0 * flops / (ctx.seconds * ctx.chips
                            * counts.STEP_PEAK_FLOPS)
