"""launches_per_call: device activities (kernels, copies, sets; each one
launch) per traced ``search_sync`` call, counted from the profiler's device
events. A count: it repeats exactly for one program."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or not tr["device_events"]:
        return None
    return tr["device_events"] / tr["steps"]
