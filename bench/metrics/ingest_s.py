"""ingest: seconds of the program's ingest in set-up (``Graph.from_edges``
and the device bundle that ``build_variant`` builds), by the host's clock
around those calls."""


def read(ctx):
    return ctx["ingest_s"]
