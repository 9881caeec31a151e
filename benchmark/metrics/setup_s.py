"""setup_s: process start to the first timed call (imports, the kernels'
build or load, weights made on the device, warm-up of the cell's shapes)."""


def read(ctx):
    return ctx.setup_s
