"""The share of the level-0 batch LM's closure calls (assembly, step, trial
cost) that ran as the replay of a captured CUDA graph, % (batch): 100 ×
replays ÷ (replays + direct calls), from the program's process-wide tallies
(``batch.graph.replays`` and ``batch.graph.eager``, set-up included). None
where the program keeps no such tallies, or made no call."""


def read(ctx):
    try:
        from glio_tpu_torch.utils.profiling import tallies
    except ImportError:
        return None
    got = tallies()
    replays, direct = got.get("batch.graph.replays", 0), got.get("batch.graph.eager", 0)
    return 100.0 * replays / (replays + direct) if replays + direct else None
