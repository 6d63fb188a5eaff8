"""device: the share of the traced slice of the solves in which no kernel,
copy or fill ran on the card, in % (1 − busy / wall, profiler timeline)."""


def read(ctx):
    r = ctx["reading"]
    return None if r is None else 100.0 * (1.0 - r.busy_s / r.window_s)
