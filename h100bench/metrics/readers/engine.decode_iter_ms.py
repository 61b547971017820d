"""Total measured model time of the decode-only iterations over their
count, in ms (``IterationRecord.model_s``)."""


def read(ctx):
    its = [r.model_s for r in ctx.window.records if r.n_decodes and not r.n_chunks]
    return sum(its) / len(its) * 1e3 if its else None
