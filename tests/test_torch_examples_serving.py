"""The serving examples' counterparts (``examples/torch_edge_serving.py``,
``torch_async_serving.py``, ``torch_executor_backends.py``) on the CPU
against the reference's scripts, as tests/test_torch_examples.py holds
the other three."""
import re

from _torch_examples import (
    LINES,
    assert_closed_loop_invariants,
    assert_same_decisions,
    reference_and_port,
)

from repro_torch.serving import profiles


def test_edge_serving_decides_as_reference():
    """The Grouped and the pool sections line for line (utility,
    violations, swaps, batches, placement); the closed loop (health=True)
    by its invariants; all three families serve in the pool section."""
    ref, out, result = reference_and_port("edge_serving")
    assert_same_decisions(ref, out)
    assert_closed_loop_invariants(result)
    assert set(result["models_ran"]["pool"]) == {"mamba2-130m", "tinyllama-1.1b", "gemma-7b"}


def test_async_serving_decides_as_reference():
    """Sync, overlapped and serial lanes decide alike (the example's own
    asserts) and as the reference."""
    ref, out, _ = reference_and_port("async_serving")
    assert_same_decisions(ref, out)
    assert "24 per-request decisions identical" in out


def test_executor_backends_as_reference_and_one_card_profiles():
    """CompiledBackend: every request served, realized provenance (the
    example's asserts), the footprints and served count the reference
    prints; CostModelBackend: the footprints the reference prints, the
    latency and swap of ``serving.profiles`` on one H100."""
    ref, out, _ = reference_and_port("executor_backends")
    assert_same_decisions(ref, out)
    head = "=== CostModelBackend"
    port_lines = LINES.dropped_sections(out)[head]
    ref_lines = LINES.dropped_sections(ref)[head]
    assert len(port_lines) == len(ref_lines) == 4
    recalls = {"mamba2-130m": [0.72, 0.70], "tinyllama-1.1b": [0.84, 0.82],
               "gemma-7b": [0.94, 0.92]}
    for line, ref_line, (arch, rec) in zip(port_lines, ref_lines, recalls.items()):
        p = profiles.costmodel_profile(arch, rec, prompt_tokens=512, new_tokens=64)
        assert p.provenance == "costmodel"
        mem = re.search(r"mem\(w\+kv\)=\S+", ref_line).group(0)
        assert line == (f"  {arch}: latency(b=1)={p.latency_s * 1e3:.2f}ms "
                        f"swap={p.load_latency_s * 1e3:.1f}ms {mem}")
    assert port_lines[-1] == ref_lines[-1]
