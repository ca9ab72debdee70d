"""The training step's share of its GPUs' bf16 peak: the work FLOPs of a
global step (``work.train_step_flops``, counted from the reference's
shapes) times the window's steps, over the window and the chips' peak."""

from h100bench import work


def read(ctx):
    if "step_flops" not in ctx or not ctx["steps"]:
        return None
    return (100.0 * ctx["step_flops"] * ctx["steps"] / ctx["window_s"]
            / (ctx["chips"] * work.PEAKS["bf16_flops"]))
