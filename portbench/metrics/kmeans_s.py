"""kmeans_s: seconds of the port's ``fit.kmeans`` span per traced build
(``vector_indexer_tpu_torch.utils.tracing.phase_report``; host clock, and the
Lloyd loop reads its shift every iteration, so the span ends near the
device)."""


def read(ctx):
    phases = ctx["window"].get("phases") or {}
    span = phases.get("fit.kmeans")
    return None if not span or not span["count"] else span["mean_s"]
