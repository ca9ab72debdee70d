"""OASIS kernel launches a served batch: the change of the program's
``oasis_cuda.launches`` counter over the window, over its batches (1 when
the first rung of the ladder holds every trace)."""


def read(ctx):
    if "oasis_launches" not in ctx or not ctx["batches"]:
        return None
    return ctx["oasis_launches"] / ctx["batches"]
