"""setup_s: seconds from the harness's start to the window's first call:
imports, the cards, the inputs and weights, the program's set-up, its
kernels' load (and, in a checkout's first run, their build), warm-up and
graph capture (host clock)."""


def read(ctx):
    return ctx.setup_s
