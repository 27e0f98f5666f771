"""device_idle_pct: the share of the traced window in which no operation
ran on the card, in percent (all processes' device activity, merged)."""


def read(name, ctx):
    t = ctx.get("trace")
    if not t or t.get("window_s", 0) <= 0 or t.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
