"""device_idle: 1 - (union of the device's operation intervals in the
traced calls) / (the time the same number of untraced calls took in the
window, at their mean), in %. The traced calls' own wall time holds the
profiler's host overhead, which would read as idle; the window's calls run
the same traffic without it."""


def read(ctx):
    wall = ctx.window_s / ctx.calls * ctx.trace_calls
    return 100.0 * (1.0 - ctx.trace.busy_s() / wall)
