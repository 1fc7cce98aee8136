"""shard_imbalance: how unevenly a traced sharded search's probed rows fall
over the cards: the most rows any card probed over the mean over the cards
(1 is even). Each card sums the rows of the cells it probes in every traced
call on the card itself, in the port's counters ``sharded.probed_rows.<card>``
(``vector_indexer_tpu_torch.utils.tracing.counter_report``, read after the
window). None where the port keeps no such counter or none counted a row."""

from vector_indexer_tpu_torch.utils import tracing

PREFIX = "sharded.probed_rows."


def read(ctx):
    report = getattr(tracing, "counter_report", None)
    rows = [v for name, v in (report() if report else {}).items() if name.startswith(PREFIX)]
    if not rows or sum(rows) <= 0:
        return None
    return max(rows) * len(rows) / sum(rows)
