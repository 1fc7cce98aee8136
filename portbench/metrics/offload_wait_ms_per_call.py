"""offload_wait_ms_per_call: the host's milliseconds blocked on the card in a
traced ``search_sync`` call of an offloaded index: the port's
``offload.wait`` spans (the host waiting for a half's shortlist to reach
pinned host memory) summed, over the number of its root ``search`` spans
(``vector_indexer_tpu_torch.utils.tracing.phase_report``, host clock). None
where the registry holds no ``offload.wait`` or no ``search`` span."""

from vector_indexer_tpu_torch.utils import tracing

SPAN = "offload.wait"


def read(ctx):
    phases = tracing.phase_report()
    root, span = phases.get("search"), phases.get(SPAN)
    if not root or not root["count"] or not span or not span["count"]:
        return None
    return 1e3 * span["total_s"] / root["count"]
