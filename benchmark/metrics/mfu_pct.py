"""mfu_pct: the window's UNet FLOPs (counted from shapes,
`harness.counts.unet_flops`, for every forward the window ran) over the
window's wall seconds, as a percent of the card's dense peak in the
configuration's precision (float32: 67 TFLOP/s on an H100 SXM)."""

from benchmark.harness import counts


def read(name, ctx):
    peak = counts.peaks(ctx.get("device_name", ""))
    if peak is None or ctx["window_s"] <= 0 or not ctx["model_flops"]:
        return None
    return 100.0 * ctx["model_flops"] / ctx["window_s"] / peak[ctx["precision"]]
