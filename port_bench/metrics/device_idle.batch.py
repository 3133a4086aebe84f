"""The device's idle share of the traced window, % (device; batch cells)."""


def read(ctx):
    return ctx.trace.idle_pct()
