"""A run with the timed path broken underneath comes out not correct: for
each cell, every answer altered where it is produced, and half of a batch
left out; for the video cells also the boxes of one slot of each batch
moved by a pixel (the card check skipped; tiny sizes on the CPU)."""

import pytest

from portbench import registry
from portbench.tests import faults, tiny

CELLS = tiny.CELLS


def _incorrect(name, **kw):
    rc, res, err = tiny.run_cell(name, **kw)
    assert rc == 0, err[-3000:]
    failed = [k for k, c in res["compared"].items() if c["value"] > c["limit"]]
    assert not res["correct"] and failed, res["compared"]


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    kind = registry.traffic(registry.cell(tiny.benchmark(), cell)["traffic"])["kind"]
    if kind == "video":
        faults.break_detector(monkeypatch, faults.DETECTOR[fault])
        _incorrect(cell)
    elif kind == "group":
        faults.break_encoder(monkeypatch, fault)
        _incorrect(cell)
    else:
        _incorrect(cell, edit=lambda cfg, tr: tr.update(test_fault=fault))


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".video")])
def test_one_slot_moved_a_pixel_is_not_correct(cell, monkeypatch):
    faults.break_detector(monkeypatch, faults.slot_offset)
    _incorrect(cell)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_tiny_run_is_correct(cell):
    rc, res, err = tiny.run_cell(cell, seed=123456789012)
    assert rc == 0, err[-3000:]
    assert res["correct"], res["compared"]
    assert res["attempted"] > 0 and res["failed"] == 0
