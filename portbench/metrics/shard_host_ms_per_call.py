"""shard_host_ms_per_call: the host's own milliseconds in a traced sharded
search call: the port's root ``sharded.search`` span less its
``sharded.to_host`` span (the copy back of the merged lists, where the host
waits on the cards), over the number of ``sharded.search`` spans
(``vector_indexer_tpu_torch.utils.tracing.phase_report``, host clock). The
port records spans only while the profiler runs, so the registry holds
exactly the traced calls; None where it holds no ``sharded.search`` span."""

from vector_indexer_tpu_torch.utils import tracing


def read(ctx):
    phases = tracing.phase_report()
    root = phases.get("sharded.search")
    if not root or not root["count"]:
        return None
    wait = phases.get("sharded.to_host", {}).get("total_s", 0.0)
    return 1e3 * (root["total_s"] - wait) / root["count"]
