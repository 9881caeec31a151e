"""invert_s: host seconds of `prepare_real_image_edit` (encode and
inversion), ended by a synchronisation, averaged over the traced run's
window calls."""


def read(ctx):
    t = ctx.timings.get("invert_s") if ctx.timings else None
    return sum(t) / len(t) if t else None
