"""Kernel launches in the traced window per batch solve (batch)."""


def read(ctx):
    return ctx.trace.launches() / ctx.units if ctx.units else None
