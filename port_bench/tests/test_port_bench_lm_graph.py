"""``metrics/window.lm_graph_share.py``: the window LM's graph replays as a
share of its calls, from the program's tallies."""

import types

import pytest

from glio_tpu_torch.utils import profiling
from port_bench.harness import cells

CTX = types.SimpleNamespace(trace=None, units=2, driver=None)


def _read():
    return cells.load_reader("window.lm_graph_share").read(CTX)


def test_none_where_the_program_keeps_no_tallies(monkeypatch):
    monkeypatch.delattr(profiling, "tallies")
    assert _read() is None


@pytest.mark.parametrize("counts, share", [
    ({}, None),
    ({"window.lm.captures": 1, "window.lm.replays": 57}, 100.0),
    ({"window.lm.replays": 3, "window.lm.eager": 1, "window.lm.captures": 1}, 75.0),
    ({"window.lm.eager": 6}, 0.0),
])
def test_share_of_replays(monkeypatch, counts, share):
    monkeypatch.setattr(profiling, "tallies", lambda: dict(counts))
    assert _read() == share
