"""mfu: the model FLOPs of all the work the window's calls finished
(counted on the plain reference modules) over the window's seconds times
the H100's dense bf16 peak, 989e12 FLOP/s, in %."""

from benchmark.harness.flops import PEAK_BF16_FLOPS


def read(ctx):
    return 100.0 * ctx.flops_per_call * ctx.calls / (ctx.window_s * PEAK_BF16_FLOPS)
