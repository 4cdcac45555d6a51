"""Helpers of tests/test_torch_examples*.py: run an example of the JAX
package in a child process and its counterpart of the port in this one,
and compare what they decide (``examples/_example_lines.py``)."""
from __future__ import annotations

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
# The six counterparts of the reference's examples, by the reference's name.
NAMES = ("quickstart", "multiworker_sim", "edge_serving", "async_serving",
         "executor_backends", "fault_tolerant_serving")
# Seconds a reference example may take on the CPU (3-20 s unloaded).
REFERENCE_TIMEOUT_S = 600


def load(path: Path):
    """A module of ``examples/`` imported by path, afresh."""
    spec = importlib.util.spec_from_file_location(f"_example_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


LINES = load(EXAMPLES / "_example_lines.py")


def start_reference(name: str) -> subprocess.Popen:
    """The reference's ``examples/<name>.py`` on the CPU, started."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"))
    return subprocess.Popen([sys.executable, str(EXAMPLES / f"{name}.py")], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=REFERENCE_TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    return out


def run_port(name: str, *argv: str):
    """``examples/torch_<name>.py``'s ``main(["--device", "cpu", *argv])``:
    its standard output and what it returns."""
    module = load(EXAMPLES / f"torch_{name}.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(["--device", "cpu", *argv])
    return buf.getvalue(), result


def reference_and_port(name: str):
    """Both runs, the reference's in a child beside the port's: (its
    output, the port's output, what the port's ``main`` returned)."""
    proc = start_reference(name)
    try:
        out, result = run_port(name)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    return finish(proc), out, result


def assert_same_decisions(ref_out: str, port_out: str) -> None:
    ref, port = LINES.decision_lines(ref_out), LINES.decision_lines(port_out)
    assert port == ref, "\n".join(
        f"reference: {a!r}\nport:      {b!r}" for a, b in zip(ref, port) if a != b) or (
        f"{len(ref)} lines against {len(port)}")


def assert_closed_loop_invariants(result: dict) -> None:
    """A health=True section: every request recorded once, a failure and
    its retry."""
    assert not LINES.closed_loop_problems(result), result["closed_loop"]
