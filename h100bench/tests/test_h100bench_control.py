"""The control fails: the reference computed in float32 (the nearest
precision below the configurations' float64) put in the program's place
breaks at least one of each cell's limits, at a size a CPU test holds."""

import pytest
import torch

from h100bench.harness import load_cell


@pytest.mark.parametrize("cell,rows", [("pure_vp.b100k", 96), ("pure_fit.b100k", 96),
                                       ("binary_fit.b4096", 8)])
def test_float32_control_fails(cell, rows):
    spec, config, traffic = load_cell(cell)
    spec["params"].update(rows=rows, reference_block=rows)
    c = traffic.Cell(spec, config, 2**31 + 5, torch.device("cpu"))
    c.setup()
    numbers = c.control(torch.float32)
    limits = spec["limits"]
    assert set(numbers) == set(limits)
    assert any(not (v <= limits[k]) for k, v in numbers.items()), numbers
