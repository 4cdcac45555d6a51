"""The counterparts of the JAX package's examples (``examples/torch_*.py``)
on the CPU against the reference's scripts, and their rules.

Each reference script runs in a child process (``JAX_PLATFORMS=cpu``)
beside the port's ``main(["--device", "cpu"])``; the two outputs must
agree line for line under ``examples/_example_lines.py``'s named masks.
tests/test_torch_examples_serving.py holds the three serving examples.
"""
import re

import pytest
import torch
from _torch_examples import (
    EXAMPLES,
    LINES,
    NAMES,
    assert_closed_loop_invariants,
    assert_same_decisions,
    load,
    reference_and_port,
)


def test_quickstart_decides_as_reference():
    ref, out, _ = reference_and_port("quickstart")
    assert out == ref  # nothing measured: the whole output


def test_multiworker_sim_decides_as_reference():
    """Every line up to the executor pool's timings; the closed loop
    (health=True) by its invariants."""
    ref, out, result = reference_and_port("multiworker_sim")
    assert_same_decisions(ref, out)
    assert "closed loop: transient faults" in LINES.dropped_sections(out)
    assert_closed_loop_invariants(result)


def test_fault_tolerant_serving_decides_as_reference():
    """Short-circuit lanes: the whole output but the EWMA ratios; the
    example's own asserts hold."""
    ref, out, _ = reference_and_port("fault_tolerant_serving")
    assert_same_decisions(ref, out)
    assert out.rstrip().endswith("OK: every request accounted exactly once under injected "
                                 "faults")


@pytest.mark.parametrize("name", NAMES)
def test_example_needs_cuda_unless_cpu_is_named(name):
    """No silent CPU run: without ``--device`` an example raises
    ``resolve_device``'s error on a host without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    module = load(EXAMPLES / f"torch_{name}.py")
    with pytest.raises(RuntimeError, match="repro_torch runs on CUDA and found none"):
        module.main([])


def test_decision_lines_mask_only_what_is_measured():
    """The masks take the clock's numbers and keep every decision: models,
    placements, schedule times, deadlines, counts and utilities."""
    text = "\n".join([
        "    r4 -> ecg-cnn                      start= 100.0ms deadline= 166.4ms",
        "  window 1: n= 9 utility=0.823 backlog=164.0ms utilization=0.36",
        "  worker 0: swaps=1 busy=  37.8ms lane-utilization=0.64",
        "host scheduling wall 21.7ms  lane execution wall 1268.3ms",
        "  batch[gemma-7b        ] size=1 swap=   0.0ms prefill=   2.4ms decode=   3.2ms",
        "  realized/profiled EWMA: w0=1.00 w1=0.08",
        "",
        "closed loop: transient faults on the fast lane, retries + drift EWMA",
        "  requests=8 failed_batches=2 retries=2 dropped=0 quarantined=0",
        "",
        "after",
    ])
    assert LINES.decision_lines(text) == [
        "    r4 -> ecg-cnn                      start= 100.0ms deadline= 166.4ms",
        "  window 1: n= 9 utility=0.823 backlog=164.0ms utilization=0.36",
        "  worker 0: swaps=1 busy=<ms> lane-utilization=<u>",
        "host scheduling wall <ms>  lane execution wall <ms>",
        "  batch[gemma-7b        ] size=1 swap=   0.0ms prefill=<ms> decode=<ms>",
        "",
        "after",
    ]
    for name, _, _, reason in LINES.MASKS:
        assert name and reason
    assert all(re.search(r"\w", reason) for *_, reason in LINES.DROPPED_SECTIONS)
