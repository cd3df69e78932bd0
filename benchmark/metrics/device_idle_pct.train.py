"""The cards' mean share of the traced slice in which no device operation
runs, in % (torch.profiler's device trace)."""


def read(ctx):
    return ctx.trace.idle_pct() if ctx.trace is not None else None
