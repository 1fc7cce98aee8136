"""host_ms_per_call: the host's own milliseconds in a traced ``search_sync``
call: the port's root ``search`` span less its ``search.to_host`` span (the
blocking copy back, where the host waits on the card), over the number of
``search`` spans (``vector_indexer_tpu_torch.utils.tracing.phase_report``,
host clock). The port records spans only while the profiler runs, so the
registry holds exactly the traced calls; None where it holds no ``search``
span (a port without search spans)."""

from vector_indexer_tpu_torch.utils import tracing


def read(ctx):
    phases = tracing.phase_report()
    root = phases.get("search")
    if not root or not root["count"]:
        return None
    wait = phases.get("search.to_host", {}).get("total_s", 0.0)
    return 1e3 * (root["total_s"] - wait) / root["count"]
