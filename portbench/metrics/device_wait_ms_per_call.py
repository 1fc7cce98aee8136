"""device_wait_ms_per_call: milliseconds a traced ``search_sync`` call blocks
on the card: the port's ``search.to_host`` span (the copy back of D and the
rows, which waits for the card's remaining work and then copies) over the
number of root ``search`` spans (``vector_indexer_tpu_torch.utils.tracing.
phase_report``, host clock). The port records spans only while the profiler
runs, so the registry holds exactly the traced calls; None where it holds
no ``search`` span (a port without search spans)."""

from vector_indexer_tpu_torch.utils import tracing


def read(ctx):
    phases = tracing.phase_report()
    root = phases.get("search")
    if not root or not root["count"]:
        return None
    return 1e3 * phases.get("search.to_host", {}).get("total_s", 0.0) / root["count"]
