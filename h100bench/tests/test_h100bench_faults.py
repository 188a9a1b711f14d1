"""A run of the harness, its look for a card skipped, judges a broken
timed path not correct: half the batch left out (the loss over the rest),
an answer altered where it is produced, a step that leaves its state
unchanged; and the unbroken path correct.  The faults are planted in the
port's entry points, which the traffic modules call through the package."""

import time

import pytest
import torch

import feos_tpu_torch as ftt
from h100bench.harness import run

CPU = torch.device("cpu")
SIZES = {"pure_vp.b100k": 64, "pure_fit.b100k": 48, "binary_fit.b4096": 8}


def _run(cell):
    argv = ["--workload", cell, "--seed", str(2**31 + 11), "--seconds", "0.3", "--trace", "0"]
    rows = SIZES[cell]
    code, result = run(argv, time.perf_counter(), device=CPU,
                       params={"rows": rows, "reference_block": rows})
    assert code == 0
    return result


def _half_left_out(fn, index):
    def broken(*args, **kwargs):
        out = list(fn(*args, **kwargs))
        nans = out[index].clone()
        nans[nans.shape[0] // 2:] = True
        value = 1 - index  # (nans, p) for the pure entries, (p, nans, ...) for bubble_point
        out[value] = torch.where(nans, torch.nan, out[value])
        out[index] = nans
        return tuple(out)
    return broken


def _altered(fn, value):
    def broken(*args, **kwargs):
        out = list(fn(*args, **kwargs))
        bump = torch.zeros_like(out[value].detach())
        bump[0] = 1e-6
        out[value] = out[value] * (1.0 + bump)
        return tuple(out)
    return broken


def _frozen(fn):
    """bubble_point that keeps solving at the first call's k_ij, as a step
    that never takes its new parameters in."""
    first = {}

    def broken(parameters, kij, *args, **kwargs):
        first.setdefault("kij", kij.detach().clone())
        return fn(parameters, first["kij"] + (kij - kij.detach()), *args, **kwargs)
    return broken


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_path_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell,entry,index", [
    ("pure_vp.b100k", "vapor_pressure", 0), ("pure_fit.b100k", "liquid_density", 0),
    ("binary_fit.b4096", "bubble_point", 1)])
def test_half_the_batch_left_out(monkeypatch, cell, entry, index):
    monkeypatch.setattr(ftt, entry, _half_left_out(getattr(ftt, entry), index))
    assert _run(cell)["correct"] is False


@pytest.mark.parametrize("cell,entry,value", [
    ("pure_vp.b100k", "vapor_pressure", 1), ("pure_fit.b100k", "liquid_density", 1),
    ("binary_fit.b4096", "bubble_point", 0)])
def test_answer_altered(monkeypatch, cell, entry, value):
    monkeypatch.setattr(ftt, entry, _altered(getattr(ftt, entry), value))
    assert _run(cell)["correct"] is False


def test_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(ftt, "bubble_point", _frozen(ftt.bubble_point))
    assert _run("binary_fit.b4096")["correct"] is False
