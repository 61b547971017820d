"""90th percentile of time to first token over every request of the window,
on the engine's clock (measured model time, plus jumps to the next arrival
when idle), in ms."""
from h100bench.metrics.stats import percentile, request_metrics


def read(ctx):
    ttft = request_metrics(ctx.window.requests)["ttft"]
    return percentile(ttft, 90) * 1e3 if len(ttft) else None
