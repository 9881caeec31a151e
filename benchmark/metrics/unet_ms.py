"""unet_ms: device milliseconds a call of the denoiser closure (the UNet,
both halves of a CFG pair in one call), in the traced calls."""

from benchmark.harness.ranges import UNET


def read(ctx):
    n = ctx.trace.range_count(UNET)
    return ctx.trace.range_device_s(UNET) / n * 1e3 if n else None
