"""guided_step_ms: host milliseconds of `edit_image` (the guided loop and
the final decode), ended by a synchronisation, over its guided steps, in
the traced run's window."""


def read(ctx):
    t = ctx.timings.get("edit_s") if ctx.timings else None
    if not t or not ctx.timings["guided_steps"]:
        return None
    return sum(t) / ctx.timings["guided_steps"] * 1e3
