"""shard_graph_replay_share: the share of traced sharded search calls that
the port answered by replaying each card's captured CUDA graph: its counter
``sharded.graph.replay`` (``vector_indexer_tpu_torch.utils.tracing.count``,
summed on the host in every traced call that replays) over the number of
its root ``sharded.search`` spans (``tracing.phase_report``). Both record
only while the profiler runs, so they cover the same traced calls. None
where the port keeps no such counter or no ``sharded.search`` span was
traced."""

from vector_indexer_tpu_torch.utils import tracing

COUNTER = "sharded.graph.replay"


def read(ctx):
    report = getattr(tracing, "counter_report", None)
    replays = (report() if report else {}).get(COUNTER)
    root = tracing.phase_report().get("sharded.search")
    if replays is None or not root or not root["count"]:
        return None
    return replays / root["count"]
