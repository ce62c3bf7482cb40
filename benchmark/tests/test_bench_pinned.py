"""The check numbers of the benchmark's cells, each held to the float
that the harness gave on the CPU before scene kinds, fit cells under GI and
the reference fit in pixel blocks came in: at the tests' size, with a
window of one unit, seeds 3, 17 and 2^31 + 17.  Beside the numbers
compared: the frames' widest gap and the fit's losses on both sides."""

import pytest
import torch

from bench_setup import tiny_cell

from harness import driver

PINNED = {
    ("quads64.gi_frames", 3): {
        "px_off_share": 0.0,
        "px_widest_gap": 1.0199962902079918e-07,
    },
    ("quads64.gi_frames", 17): {
        "px_off_share": 0.0,
        "px_widest_gap": 1.4205326098748472e-07,
    },
    ("quads64.gi_frames", 2 ** 31 + 17): {
        "px_off_share": 0.0,
        "px_widest_gap": 1.4205326098748472e-07,
    },
    ("soup1m.frames", 3): {
        "px_off_share": 0.0,
        "px_widest_gap": 2.1558960039413932e-07,
    },
    ("soup1m.frames", 17): {
        "px_off_share": 0.0,
        "px_widest_gap": 1.760511089132777e-07,
    },
    ("soup1m.frames", 2 ** 31 + 17): {
        "px_off_share": 0.0,
        "px_widest_gap": 1.3138951948654665e-07,
    },
    ("quads64.fit", 3): {
        "loss_gap": 3.138743947903694e-06,
        "grad_gap": 1.5825346540488736e-06,
        "step_gap": 0.0005630927308381155,
        "loss_ref": [0.001729863318157274, 0.001360557862769,
                     0.0010314523020770593],
        "loss_got": [0.0017298636958003044, 0.0013605575077235699,
                     0.0010314490646123886],
    },
    ("quads64.fit", 17): {
        "loss_gap": 7.558976880413731e-07,
        "grad_gap": 9.953912718280283e-05,
        "step_gap": 3.648865851454419e-05,
        "loss_ref": [0.002563974968979907, 0.0021692963882214106,
                     0.001916440414544122],
        "loss_got": [0.0025639741215854883, 0.002169294748455286,
                     0.0019164396217092872],
    },
    ("quads64.fit", 2 ** 31 + 17): {
        "loss_gap": 6.696045949747818e-07,
        "grad_gap": 4.376063576273856e-05,
        "step_gap": 0.0001370114462295341,
        "loss_ref": [0.001166882402076576, 0.0009005220863413213,
                     0.000665944425182505],
        "loss_got": [0.0011668828083202243, 0.0009005226893350482,
                     0.000665944186039269],
    },
}


@pytest.mark.parametrize("name,seed", list(PINNED))
def test_check_numbers_are_as_pinned(name, seed):
    cell = tiny_cell(name)
    r = driver.make(cell, torch.device("cpu"), seed, 0.0)
    assert r.run(0.0, False).units == 1
    r.free()
    cmp = r.compare()
    got = {**cmp["info"], **cmp["numbers"]}
    assert set(cmp["numbers"]) <= set(PINNED[(name, seed)])
    for k, v in PINNED[(name, seed)].items():
        assert got[k] == v, k
