"""Host milliseconds of ``build_problem`` per solve, over a traced run's
unprofiled units (batch)."""


def read(ctx):
    times = getattr(ctx.driver, "host_build_s", None)
    return 1e3 * sum(times) / len(times) if times else None
