"""``metrics/batch.graph_share.py``: the level-0 batch LM's graph replays as
a share of its closure calls, from the program's tallies."""

import types

import pytest

from glio_tpu_torch.utils import profiling
from port_bench.harness import cells

CTX = types.SimpleNamespace(trace=None, units=2, driver=None)


def _read():
    return cells.load_reader("batch.graph_share").read(CTX)


def test_none_where_the_program_keeps_no_tallies(monkeypatch):
    monkeypatch.delattr(profiling, "tallies")
    assert _read() is None


@pytest.mark.parametrize("counts, share", [
    ({}, None),
    ({"window.lm.replays": 40}, None),
    ({"batch.graph.captures": 3, "batch.graph.replays": 600}, 100.0),
    ({"batch.graph.replays": 3, "batch.graph.eager": 1, "batch.graph.captures": 3}, 75.0),
    ({"batch.graph.eager": 120}, 0.0),
])
def test_share_of_replays(monkeypatch, counts, share):
    monkeypatch.setattr(profiling, "tallies", lambda: dict(counts))
    assert _read() == share
