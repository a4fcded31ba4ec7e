"""A run's comparison catches a broken timed path, and the control fails.

Each test drives the whole of a run but its look for a card (the program
on CPU tensors runs its plain versions) at a tiny size, with the entry
point broken underneath, and sees ``correct`` come out as the fault
demands.  The cells have no training state and no exchange between
chips, so their faults are half of the batch left out and an answer
altered where it is produced."""

import numpy as np
import pytest
import torch

import control
import run

CELLS = ("manchester.corpus", "fourb5b.corpus")


def drive(workload, wrap=None, trace=0, seed=2**31 + 77):
    args = run.parse(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                      "--trace", str(trace)])
    return run.run(args, device=torch.device("cpu"), entry_wrap=wrap)


def half_left_out(entry):
    """The second half of the answer's recordings (or blocks) left out."""
    def call(x):
        fields = [f.clone() for f in entry(x)]
        n = fields[0].shape[0]
        fields[0][n // 2:] = False
        return tuple(fields)
    return call


def answer_altered(entry):
    """One payload byte of the first kept frame flipped."""
    def call(x):
        fields = [f.clone() for f in entry(x)]
        valid, fb = fields[0].reshape(-1), fields[1].reshape(-1, fields[1].shape[-1])
        k = int(torch.nonzero(valid)[0])
        fb[k, 10] ^= 0x40
        return tuple(fields)
    return call


def start_moved(entry):
    """The first kept frame's start one sample late."""
    def call(x):
        fields = [f.clone() for f in entry(x)]
        start = fields[7].reshape(-1)
        k = int(torch.nonzero(fields[0].reshape(-1))[0])
        start[k] += 1
        return tuple(fields)
    return call


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny, workload):
    res = drive(workload)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0 and res["frames_checked"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"audio_s_per_s", "request_ms_p95", "peak_mem_mib", "setup_s"}


@pytest.mark.parametrize("fault", [half_left_out, answer_altered, start_moved])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_path_is_not_correct(tiny, workload, fault):
    res = drive(workload, wrap=fault)
    assert not res["correct"]
    assert res["checks"]["frames_differ"]["value"] > 0


def test_failing_requests_are_not_correct(tiny):
    def crash(entry):
        def call(x):
            raise RuntimeError("planted")
        return call

    with pytest.raises(RuntimeError):   # the warm-up is set-up: it does not go on
        drive("manchester.corpus", wrap=crash)

    calls = {"n": 0}

    def crash_later(entry):
        def call(x):
            calls["n"] += 1
            if calls["n"] > 3:
                raise RuntimeError("planted")
            return entry(x)
        return call

    res = drive("manchester.corpus", wrap=crash_later)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run(tiny, workload):
    res = drive(workload, trace=1)
    assert res["correct"]
    assert {"syncs_per_request", "launches_per_request", "glue_device_ms",
            "device_idle_share", "request_mfu"} <= set(res["metrics"])
    # no kernel runs on the CPU: the roofline readers have nothing to read
    assert "xcorr_roofline" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(tiny, workload):
    from harness import manifest

    small = manifest.traffic(manifest.cell(manifest.load(), workload)["traffic"])
    r = control.readings(workload, [5, 6, 7], device=torch.device("cpu"), mix_override=small)
    for prog, ctrl in zip(r["program"], r["control"]):
        assert prog["frames_differ"]["value"] == 0
        assert prog["corr_gap"]["value"] <= prog["corr_gap"]["limit"]
        assert any(c["value"] > c["limit"] for c in ctrl.values()), ctrl


@pytest.mark.gpu
def test_cell_on_the_card(tiny):
    res = run.run(run.parse(["--workload", "manchester.corpus", "--seed", "3", "--seconds", "1"]))
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["audio_s_per_s"]["value"])
