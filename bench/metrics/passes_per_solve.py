"""convergence engine: mean ``PageRankResult.iterations`` of the window's
solves (passes of the variant's sweep to its stop rule)."""


def read(ctx):
    its = ctx["iterations"]
    return sum(its) / len(its) if its else None
