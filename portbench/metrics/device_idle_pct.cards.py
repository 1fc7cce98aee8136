"""device_idle_pct.cards: the idle share of the idlest of the cell's cards
over the traced part of a search window: 100 x (1 - min(busy_s_by_device) /
window_s) (``devtrace.reduce``'s summary: each card's union of device
activity alone). None where no device activity was traced."""


def read(ctx):
    summary = ctx["trace"]
    if not summary or not summary.get("device_events") or not summary.get("busy_s_by_device"):
        return None
    return 100.0 * (1.0 - min(summary["busy_s_by_device"]) / summary["window_s"])
