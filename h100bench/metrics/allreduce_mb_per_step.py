"""Megabytes a rank all-reduces a training step: the change of the
program's ``mesh.collective_bytes`` counter over the window, over its
steps (nothing on one chip)."""


def read(ctx):
    if ctx.get("chips", 1) < 2 or not ctx.get("steps"):
        return None
    return ctx["bytes_per_step"] / 1e6
