"""offload_rerank_ms_per_call: the host's milliseconds of exact re-rank in a
traced ``search_sync`` call of an offloaded index: the port's
``offload.rerank`` spans (each half's gather from the host mirror, its exact
float32 distances and its top-k) summed, over the number of its root
``search`` spans (``vector_indexer_tpu_torch.utils.tracing.phase_report``,
host clock). None where the registry holds no ``offload.rerank`` or no
``search`` span (a port without these spans, or an index not offloaded)."""

from vector_indexer_tpu_torch.utils import tracing

SPAN = "offload.rerank"


def read(ctx):
    phases = tracing.phase_report()
    root, span = phases.get("search"), phases.get(SPAN)
    if not root or not root["count"] or not span or not span["count"]:
        return None
    return 1e3 * span["total_s"] / root["count"]
