"""Every token the window's requests emitted, over the window's wall
seconds."""


def read(ctx):
    return sum(g for _, g in ctx.lengths) / ctx.window.wall_s
