"""The measured window: it ends at an NFE boundary once its seconds have
passed, counts whole NFEs, and images_per_s is B x NFEs / NFEs an image
over the window's seconds; a traced run's NFE times leave out the traced
slice."""

import time

import pytest
import torch

import tiny
from harness import window


def test_the_window_ends_at_the_first_nfe_boundary_past_its_seconds():
    nfe = 0.02
    clock = window.Clock("cpu", 0.1)
    calls = []

    def model(x, t):
        calls.append(time.perf_counter())
        time.sleep(nfe)
        return x

    counted = window.Counted(model, clock, window.Capture(0, set(), set()))
    clock.open()
    with pytest.raises(window.WindowClosed):
        for _ in range(1000):
            counted(torch.zeros(1), None)
    assert clock.nfes == len(calls)
    span = clock.t_end - clock.t0
    assert 0.1 <= span < 0.1 + 2 * nfe + 0.05
    assert calls[-1] - clock.t0 < 0.1   # the last NFE started in time


def test_warm_up_stops_after_the_calls_asked_for():
    clock = window.Clock("cpu", 1.0)
    clock.stop_after = 2
    clock.boundary()
    clock.boundary()
    with pytest.raises(window.WindowClosed):
        clock.boundary()
    assert clock.t0 is None and clock.nfes == 0


def test_traced_nfe_seconds_leave_out_the_slice():
    clock = window.Clock("cpu", 1.0, sync_each=True)
    clock.leave = [0.0, 1.0, 3.0, 6.0]
    clock.arrive = [0.0, 0.5, 2.5, 5.0]
    clock.t_end = 10.0
    assert clock.nfe_seconds(set()) == [0.5, 1.5, 2.0, 4.0]
    assert clock.nfe_seconds({1, 2}) == [0.5, 4.0]


def test_images_per_s_counts_whole_nfes_of_a_cpu_run():
    """A tiny cell for 3 seconds: several solves back to back, the window
    cut inside one of them."""
    c = tiny.cell("dwt_var")
    res = tiny.run(c, seconds=3.0, max_solves=None)
    B, per_image = c.traffic["batch"], c.traffic["nfes_per_image"]
    assert res["window_s"] >= 3.0
    assert res["nfes"] >= res["solves"] * per_image
    assert res["nfes"] < (res["solves"] + 1) * per_image
    assert res["attempted"] == B * (res["solves"] + 1)
    assert res["failed"] == 0
    assert res["metrics"]["images_per_s"] == pytest.approx(
        B * res["nfes"] / per_image / res["window_s"])
    assert res["steps_checked"] == res["steps_sampled"]
