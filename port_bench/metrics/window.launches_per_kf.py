"""Kernel launches in the traced window per keyframe (sliding-window step)."""


def read(ctx):
    return ctx.trace.launches() / ctx.units if ctx.units else None
