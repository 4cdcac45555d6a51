"""What a traced step does on one device, and its roofline terms: the
counterpart of ``repro.launch.hlo_analysis``.

The reference parses the compiled, partitioned HLO text of a step.  The
port compiles nothing: the dry run (``launch.dryrun``) runs the step
eagerly on fake tensors (``FakeTensorMode``: shapes and types, no
storage) over a fake world of the mesh's ranks (``launch.mesh.
fake_world``), and ``StepTrace``, a ``TorchDispatchMode``, watches every
operation that rank 0 runs on its local tensors:

  * FLOPs: each operation's count from ``torch.utils.flop_counter``'s
    formulas (the products; elementwise work is not counted), the
    kernels' included through the formulas their shape-only operators
    register (``kernels`` package).  Operations on DTensors are left to
    DTensor, whose local operations are then counted, so the count is
    one device's;
  * the collective census, ``collective_bytes``: every collective of
    ``_c10d_functional`` (what DTensor issues) and ``c10d`` (what
    ``torch.distributed`` issues), by the reference's kinds, with the
    reference's methodology: result-shape bytes on one device, no
    ring factor (n-1)/n, a collective and its wait counted once.  On a
    mesh of the ``cpu`` device type DTensor moves a shard to another
    dim by an all-gather and a local slice (gloo has no all-to-all), so
    such a move counts as an all-gather of its whole result;
  * bytes accessed: every operation's operands and results, summed
    before any fusion, as XLA's ``bytes accessed`` (an upper bound; the
    roofline's memory term is ``launch.memmodel``'s);
  * live bytes: every storage an operation makes, from the operation to
    the last tensor that holds it, rounded up to the 512 bytes the CUDA
    caching allocator rounds to, on top of the bytes the step's inputs
    hold when it starts: the peak is what ``torch.cuda.
    max_memory_allocated`` would read for the same step, less what the
    libraries allocate inside an operation (cuBLAS's workspace).

``HW`` holds the peaks of the card the port runs on, one NVIDIA H100 SXM
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``:
``NVIDIA H100 80GB HBM3, 700.00 W``), from NVIDIA's data sheet: the
dense bf16 tensor-core rate, the HBM3 bandwidth and NVLink's 900 GB/s to
the host's other cards, 450 GB/s each way.  The reference's ``HW`` holds
a TPU v5e's.  A card set below 700 W runs slower under load than these
peaks say.

The dry run leans on three private names of PyTorch (``INTERNALS``):
``StepTrace`` pauses itself while DTensor propagates an output's shape
(``ShardingPropagator._propagate_tensor_meta_non_cached``, which runs the
op on global fake shapes; uncounted, layer 0 counted 2.8x), ``launch.
mesh.fake_world`` takes its store from ``torch.testing._internal``, and
``models.layers.rope`` asks whether a fake mode is active.  Both
``StepTrace`` and ``fake_world`` check them first (``require_internals``)
and name the PyTorch release that lacks one.
"""
from __future__ import annotations

import importlib
import importlib.util
import weakref

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["StepTrace", "collective_bytes", "roofline_terms", "HW", "KINDS", "INTERNALS",
           "missing_internals", "require_internals"]

# One H100 SXM at its 700 W limit (NVIDIA data sheet, dense rates).
HW = {
    "peak_flops_bf16": 989e12,  # FLOP/s, tensor cores
    "hbm_bw": 3.35e12,  # B/s
    "ici_bw": 450e9,  # B/s, NVLink, one direction
}

# The reference's census kinds, by the operator that issues each.
KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d")
ROUND = 512  # the caching allocator's block granularity

# (module, attribute path) of the private PyTorch names the dry run uses.
INTERNALS = (
    ("torch.distributed.tensor._sharding_prop",
     "ShardingPropagator._propagate_tensor_meta_non_cached"),
    ("torch.testing._internal.distributed.fake_pg", "FakeStore"),
    ("torch._C", "_get_dispatch_mode"),
    ("torch._C", "_TorchDispatchModeKey.FAKE"),
)


def missing_internals() -> list[str]:
    """The names of ``INTERNALS`` that this PyTorch lacks."""
    missing = []
    for module, path in INTERNALS:
        if importlib.util.find_spec(module) is None:
            missing.append(module)
            continue
        obj = importlib.import_module(module)
        for part in path.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                missing.append(f"{module}.{path}")
                break
    return missing


def require_internals() -> None:
    """Raise, naming the PyTorch release, when ``INTERNALS`` are missing:
    without them the dry run would fail midway or miscount."""
    missing = missing_internals()
    if missing:
        raise RuntimeError(f"the dry run needs PyTorch internals that torch {torch.__version__} "
                           f"lacks: {', '.join(missing)}")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)


def _rounded(n: int) -> int:
    return -(-n // ROUND) * ROUND


class StepTrace(TorchDispatchMode):
    """FLOPs, collectives and live bytes of the operations run under it
    (see the module's docstring).  ``inputs``: a tree (dicts, lists,
    tuples, DTensors) of what the step holds when it starts; their bytes
    are the live bytes' floor until they are freed."""

    def __init__(self, inputs=None):
        super().__init__()
        self.flops = 0
        self.flops_by_op: dict[str, int] = {}
        self.bytes = 0
        self.census: dict = {}
        self.live = 0
        self.peak = 0
        self.ops = 0
        self._held: dict[int, int] = {}
        self._paused = 0
        self._unpatched = None
        for t in _leaves(inputs):
            self._hold(t)
        self.start_bytes = self.live

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        require_internals()

        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        trace = self

        def shapes_only(prop, op_schema):
            trace._paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                trace._paused -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = shapes_only
        self._unpatched = orig
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._unpatched
        return super().__exit__(*exc)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type == "meta" and not is_fake(t):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = _rounded(st.nbytes())
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local operations come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        self.ops += 1
        self.bytes += sum(t.numel() * t.element_size()
                          for t in _tensors((args, tuple(kwargs.values()), out)))
        packet = func._overloadpacket
        if packet in flop_registry:
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            name = str(packet)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if func.namespace in _COLLECTIVE_NS:
            kind = KINDS.get(packet.__name__)
            if kind is not None:
                rec = self.census.setdefault(kind, {"count": 0, "bytes": 0})
                rec["count"] += 1
                rec["bytes"] += sum(t.numel() * t.element_size() for t in _tensors(out))
        for t in _tensors(out):
            self._hold(t)
        return out


def _leaves(tree):
    from torch.distributed.tensor import DTensor

    if tree is None:
        return
    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.nn.Module):
        for p in tree.parameters():
            yield from _leaves(p)


def collective_bytes(census) -> dict:
    """{op_kind: {"count": int, "bytes": int}, "total_bytes": int} of a
    ``StepTrace`` (or its ``census`` dict), the reference's format."""
    census = census.census if isinstance(census, StepTrace) else census
    out = {kind: dict(rec) for kind, rec in census.items()}
    out["total_bytes"] = sum(rec["bytes"] for rec in census.values())
    return out


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    collective_bytes_per_device: float,
) -> dict:
    """Three roofline times (seconds) from per-device quantities.

    compute = FLOPs / peak;  memory = bytes / HBM_bw;
    collective = bytes / link bw.  The dominant term is the bottleneck;
    'roofline_fraction' = compute / max(all) (how close the step is to
    being compute-bound at peak).
    """
    t_compute = flops_per_device / HW["peak_flops_bf16"]
    t_memory = hbm_bytes_per_device / HW["hbm_bw"]
    t_collective = collective_bytes_per_device / HW["ici_bw"]
    bound = max(
        ("compute", t_compute), ("memory", t_memory), ("collective", t_collective),
        key=lambda kv: kv[1],
    )[0]
    t_max = max(t_compute, t_memory, t_collective)
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "bound": bound,
        "roofline_fraction": (t_compute / t_max) if t_max > 0 else 0.0,
    }
