"""gn_roofline: the analytic bound time of the traced calls' forward
GroupNorms (bytes at HBM's peak, or operations at the float32 peak) over
the device time launched inside their `bench.gn` ranges, in %."""

from benchmark.harness.flops import PEAK_F32_FLOPS, bound_s
from benchmark.harness.ranges import GN


def read(ctx):
    spent = ctx.trace.range_device_s(GN)
    if not ctx.work.gn or spent <= 0:
        return None
    return 100.0 * sum(bound_s(f, b, PEAK_F32_FLOPS) for f, b in ctx.work.gn) / spent
