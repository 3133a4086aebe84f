from . import checkpoint, coords, profiling, quat, so3  # noqa: F401
