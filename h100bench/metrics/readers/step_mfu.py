"""Model FLOPs of the work served while the profiler collected (the
chunks' prompt tokens and the decode tokens, ``metrics/work.token_flops``)
over the traced window's wall seconds at the card's bf16 peak, in %.
Nothing where the trace shows no card."""
from h100bench.metrics.work import token_flops


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_device or not t.window_s:
        return None
    m = ctx.model
    flops = sum(token_flops(m, p, p + 1, 1) for p in ctx.traced_decodes)
    flops += sum(token_flops(m, s, s + n, int(last)) for s, n, last in ctx.traced_chunks)
    return 100.0 * flops / (t.window_s * ctx.peaks["bf16_flops"])
