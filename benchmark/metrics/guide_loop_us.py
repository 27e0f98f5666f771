"""guide_loop_us: device microseconds a launch of the guide-loop kernel
(`guide_loop_kernel`), averaged over the traced launches."""

TAG = "guide_loop_kernel"


def read(name, ctx):
    t = ctx.get("trace")
    if not t:
        return None
    hits = [v for n, v in t["by_name"].items() if TAG in n]
    count = sum(c for _, c in hits)
    return 1e6 * sum(s for s, _ in hits) / count if count else None
