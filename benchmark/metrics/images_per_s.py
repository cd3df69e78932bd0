"""images_per_s: the window's useful (non-sentinel) images over its time;
the window runs whole calls (host clock)."""


def read(ctx):
    w = ctx.window
    return w["images"] / w["seconds"] if w.get("images") else None
