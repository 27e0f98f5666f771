"""kernels_per_call: device kernels a batched sampler call launches (copies
and sets left out), counted in the traced calls."""


def read(name, ctx):
    t = ctx.get("trace")
    if not t or not t.get("calls") or not t["kernels"]:
        return None
    return t["kernels"] / t["calls"]
