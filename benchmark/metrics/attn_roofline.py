"""attn_roofline: the analytic bound time of the traced calls' forward
attentions (operations at the bf16 peak or bytes at HBM's, whichever binds,
from each call's shapes) over the device time launched inside their
`bench.attn` ranges, in %."""

from benchmark.harness.flops import bound_s
from benchmark.harness.ranges import ATTN


def read(ctx):
    spent = ctx.trace.range_device_s(ATTN)
    if not ctx.work.attn or spent <= 0:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b in ctx.work.attn) / spent
