"""Mean decode rows of the window's iterations that decode
(``IterationRecord.n_decodes``)."""


def read(ctx):
    rows = [r.n_decodes for r in ctx.window.records if r.n_decodes]
    return sum(rows) / len(rows) if rows else None
