"""Share of the traced window's wall time in which nothing ran on the card,
in %.  Nothing without a device trace."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.n_device or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
