"""sweep_sample_steps_s: all sample-steps (grid points or seeds x denoising
steps) of the window's passes over all their time."""

from benchmark.harness.window import units_per_second


def read(ctx):
    if ctx.unit != "sample-step":
        return None
    return units_per_second(ctx.window_s, ctx.calls * ctx.units_per_call)
