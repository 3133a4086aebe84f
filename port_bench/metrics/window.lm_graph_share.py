"""The share of the window LM's calls that ran as the replay of a captured
CUDA graph, % (sliding-window step): 100 × replays ÷ (replays + direct
calls), from the program's process-wide tallies (``window.lm.replays`` and
``window.lm.eager``, set-up included). None where the program keeps no such
tallies, or made no call."""


def read(ctx):
    try:
        from glio_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    got = tallies()
    replays, direct = got.get("window.lm.replays", 0), got.get("window.lm.eager", 0)
    return 100.0 * replays / (replays + direct) if replays + direct else None
