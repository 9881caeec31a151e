"""image_s: all the window's time over all the images its calls finished."""

from benchmark.harness.window import seconds_per_unit


def read(ctx):
    if ctx.unit != "image":
        return None
    return seconds_per_unit(ctx.window_s, ctx.calls * ctx.units_per_call)
