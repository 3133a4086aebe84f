from . import pointcloud, skyplot, trajectory  # noqa: F401
