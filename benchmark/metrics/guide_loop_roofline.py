"""guide_loop_roofline: the guide-loop kernel's share of its roofline, in
percent: the least time its launches could take (the larger of their bytes
over the HBM bandwidth and their operations over the configuration
precision's peak, `harness.counts.guide_loop_work`) over their device time
in the trace. The launches' distinct grid cells are counted by the
reference on the checked calls of the same run, each guided step's own."""

from benchmark.harness import counts

TAG = "guide_loop_kernel"


def read(name, ctx):
    t = ctx.get("trace")
    cells = ctx.get("loop_cells")
    peak = counts.peaks(ctx.get("device_name", ""))
    if not t or not cells or peak is None:
        return None
    hits = [v for n, v in t["by_name"].items() if TAG in n]
    count = sum(c for _, c in hits)
    device_s = sum(s for s, _ in hits)
    if not count or device_s <= 0:
        return None
    G, B, H = ctx["loop_shape"]
    bound = sum(counts.bound_s(counts.guide_loop_work(G, B, H, ctx["n_guide"], c,
                                                      ctx["hard_values"]),
                               peak, ctx["precision"]) for c in cells) / len(cells)
    return 100.0 * bound * count / device_s
