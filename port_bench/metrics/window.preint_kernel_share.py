"""The share of the program's IMU preintegrations that ran as the CUDA
kernel, % (sliding-window step): 100 × kernel ÷ (kernel + loop), from the
program's process-wide tallies (``imu.preintegrate.kernel`` and
``imu.preintegrate.loop``, set-up included). None where the program keeps no
such tallies, or made no call."""


def read(ctx):
    try:
        from glio_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    got = tallies()
    kernel, loop = got.get("imu.preintegrate.kernel", 0), got.get("imu.preintegrate.loop", 0)
    return 100.0 * kernel / (kernel + loop) if kernel + loop else None
