"""Device time of the operations launched inside the expert layer (router,
dispatch and combine products, the expert products), as a share of the
device's busy time in the trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ranges("bench.moe") or tr.busy_s <= 0:
        return None
    return 100.0 * tr.device_s_launched_in("bench.moe") / tr.busy_s
