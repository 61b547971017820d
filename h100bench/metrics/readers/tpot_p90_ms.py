"""90th percentile over every request of the window of (finish - first
token) / (emitted - 1), on the engine's clock, in ms."""
from h100bench.metrics.stats import percentile, request_metrics


def read(ctx):
    tpot = request_metrics(ctx.window.requests)["tpot"]
    return percentile(tpot, 90) * 1e3 if len(tpot) else None
