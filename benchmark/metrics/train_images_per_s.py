"""train_images_per_s: batch x the window's training steps over its time;
the window runs whole steps between two synchronizes (host clock)."""


def read(ctx):
    w = ctx.window
    return w["images"] / w["seconds"] if w.get("steps") else None
