"""xfmr_ms: device milliseconds a call of the denoiser closure (both halves
of a CFG pair) launched inside the UNet's Transformer2D stacks (the
`bench.xfmr` ranges that a family module opens, the program's span
`models.unet.transformer`), in the traced calls. None where no stack ran
in a range."""

from benchmark.families.sdxl import XFMR
from benchmark.harness.ranges import UNET


def read(ctx):
    n = ctx.trace.range_count(UNET)
    if not n or not ctx.trace.range_count(XFMR):
        return None
    return ctx.trace.range_device_s(XFMR) / n * 1e3
