"""Total measured model time of the iterations that carry a prefill chunk,
per 1000 chunk tokens (bucket padding not counted), in ms."""


def read(ctx):
    its = [r for r in ctx.window.records if r.n_chunks]
    tokens = sum(r.n_prefill_tokens for r in its)
    return sum(r.model_s for r in its) / tokens * 1e6 if tokens else None
