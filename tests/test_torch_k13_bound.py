"""The bytes ``chip_smoke.py`` holds K13 to (``k13_pick_bytes``,
``k13_register_bytes``): what the function must move at its inputs, each
entry once, counted here on small hand-made prefixes. The card tests
(``tests/test_torch_cuda.py``) hold K13 to its plain versions."""

import importlib.util
from pathlib import Path

import pytest
import torch


def _smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _i32(x):
    return torch.tensor(x, dtype=torch.int32)


#: 8 pairs masked [1, 0, 1, 1, 0, 0, 1, 0]: c the masked-count prefix;
#: runs (0, 3], (3, 3], (3, 6], (6, 8] and a padded (8, 8]
C = _i32([0, 1, 1, 2, 3, 3, 3, 4, 4])
OFF = _i32([0, 3, 3, 6, 8, 8])


@pytest.mark.parametrize("off,want", [
    # offsets 6; c at the ends {0, 3, 6, 8} and around the answers 3, 4, 7
    # ({2, 3}, {3, 4}, {6, 7}): 7 entries; rhos 2, 3, 6; 5 registers
    (OFF, 6 + 7 + 3 + 5),
    # one run of all 8 pairs: c at 0 and 8, around answer 7; rho 6
    (_i32([0, 8]), 2 + 4 + 1 + 1),
    # no pair in any run: the offsets and c at the ends only
    (_i32([0, 0, 0]), 3 + 1 + 0 + 2)])
def test_k13_register_bytes_count_each_entry_once(off, want):
    rhos = torch.arange(8, dtype=torch.int32)
    assert _smoke().k13_register_bytes(C, off, rhos) == 4 * want


@pytest.mark.parametrize("ords,lo,hi,want", [
    # run 0 ranks 0 and 1 (answers 1, 3), run 2 rank 0 (answer 4):
    # ordinals, lo, hi, frac 8 in, 2 out; offsets 0..3; c at {0, 3, 6}
    # and {0, 1, 2, 3, 4}: 6; values 0, 2, 3
    ([0, 2], [[0], [0]], [[1], [0]], 8 + 2 + 4 + 6 + 3),
    # ordinal V (clamped, past the last run) reads offsets[V] alone; its
    # targets lie past c's end (answer 9: c[8] read, value clipped to 7)
    ([5], [[0]], [[0]], 4 + 1 + 1 + 1 + 1)])
def test_k13_pick_bytes_count_each_entry_once(ords, lo, hi, want):
    vals = torch.arange(8, dtype=torch.float32)
    lo, hi = _i32(lo), _i32(hi)
    frac = torch.zeros(lo.shape, dtype=torch.float32)
    assert _smoke().k13_pick_bytes(C, OFF, vals, _i32(ords), lo, hi,
                                   frac) == 4 * want
