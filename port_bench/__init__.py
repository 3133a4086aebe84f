"""The benchmark of ``glio_tpu_torch`` on an NVIDIA H100 (see README.md)."""
