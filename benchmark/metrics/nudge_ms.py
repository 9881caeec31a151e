"""nudge_ms: device milliseconds a guided step in the guidance nudge (the
`bench.nudge` range around the attribute function's call: decode, loss and
the gradient back through the decoder), in the traced calls."""

from benchmark.harness.ranges import NUDGE


def read(ctx):
    n = ctx.trace.range_count(NUDGE)
    return ctx.trace.range_device_s(NUDGE) / n * 1e3 if n else None
