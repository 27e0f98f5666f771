"""unet_ms: device milliseconds of the kernels of one UNet forward, the
kernels between the markers that the benchmark puts before and after each
forward in the traced window, averaged over the traced forwards."""


def read(name, ctx):
    t = ctx.get("trace")
    fwd = t.get("forward_s") if t else None
    if not fwd or sum(fwd) <= 0:
        return None
    return 1e3 * sum(fwd) / len(fwd)
