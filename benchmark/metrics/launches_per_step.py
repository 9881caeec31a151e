"""launches_per_step: kernels the profiler saw on the device in the traced
calls (copies and fills apart) over their denoising steps."""


def read(ctx):
    steps = ctx.timings_traced["guided_steps"]
    kernels = sum(1 for name, *_ in ctx.trace.ops
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / steps if steps else None
