"""The lines of an example's output that carry its decisions.

Two runs of one example (the JAX package's and the port's, or the port's
on the card and on the CPU) decide the same, but what they measure on a
clock differs.  ``decision_lines`` keeps what must agree and masks or
drops the rest, each by a named rule with its reason below; the dropped
sections are held instead by their invariants (``closed_loop_problems``
on what the examples' ``main`` returns) or, for the cost model, by the
caller.  It imports nothing but ``re``, so it runs wherever the examples
do.
"""
import re

# (name, pattern, replacement, reason): substitutions inside a line.
MASKS = (
    ("measured ms",
     re.compile(r"\b(wall|busy|prefill|decode|latency|saved|execution:)(=|\s)\s*[0-9.]+ms"),
     r"\1\2<ms>",
     "wall, busy, prefill and decode seconds and CompiledBackend's realized latency are "
     "read from a clock"),
    ("lane utilisation", re.compile(r"lane-utilization=[0-9.]+"), "lane-utilization=<u>",
     "a lane's busy seconds over the pool's wall seconds, both measured"),
    ("realized-latency schedule", re.compile(r"(swaps)=\d+, (mean_utility)=[0-9.]+"),
     r"\1=<n>, \2=<u>",
     "CompiledBackend's profiles are its realized-latency fit, so its schedule follows the "
     "clock; the served count and the provenance stay compared"),
    ("compiled header", re.compile(r"real (jitted )?forwards"), "real forwards",
     "the reference's forwards are jitted; the port's run eagerly and replay CUDA graphs"),
)

# Lines dropped wherever they appear.
DROPPED_LINES = (
    ("EWMA ratios", "realized/profiled EWMA:",
     "realized over profiled latency, a ratio of measured times"),
)

# Sections (a header line up to the next blank line) dropped whole.
DROPPED_SECTIONS = (
    ("closed loop on models", ("closed loop: transient faults", "fault-tolerant closed loop"),
     "health=True: realized latencies feed quarantine and drift, so the decisions follow "
     "the clock; held by every request recorded once, failed_batches >= 1, retries >= 1"),
    ("cost model", ("=== CostModelBackend",),
     "the port plans for one H100 (serving.profiles, N_DEVICES = 1) and the reference for "
     "16 TPU devices; held against repro_torch.serving.profiles called directly"),
)


def _sections(text: str):
    """(header of the dropped section the line is in, or None; the line)."""
    head = None
    for line in text.splitlines():
        if head is not None and not line.strip():
            head = None
            continue
        if head is None:
            head = next((h for _, heads, _ in DROPPED_SECTIONS for h in heads
                         if line.lstrip().startswith(h)), None)
            if head is not None:
                continue
        yield head, line


def decision_lines(text: str) -> list[str]:
    """``text``'s lines with every rule above applied."""
    out = []
    for head, line in _sections(text):
        if head is not None or any(marker in line for _, marker, _ in DROPPED_LINES):
            continue
        for _, pattern, repl, _ in MASKS:
            line = pattern.sub(repl, line)
        out.append(line)
    return out


def dropped_sections(text: str) -> dict[str, list[str]]:
    """The lines of each dropped section, by its header."""
    found = {}
    for head, line in _sections(text):
        if head is not None:
            found.setdefault(head, []).append(line)
    return found


def closed_loop_problems(result: dict) -> list[str]:
    """What a health=True section's run, as ``main`` returns it, breaks of
    its invariants: every request recorded once, a failed batch and its
    retry."""
    loop = result["closed_loop"]
    problems = []
    if loop["recorded"] != sorted(loop["submitted"]):
        problems.append("not every request was recorded once")
    if loop["failed_batches"] < 1 or loop["retries"] < 1:
        problems.append(f"failed_batches={loop['failed_batches']} retries={loop['retries']}")
    return problems
