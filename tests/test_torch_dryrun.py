"""The port's dry-run tooling (``launch.memmodel``, ``launch.hlo_analysis``'s
``StepTrace`` and census, ``launch.costmodel.composed_cost``,
``launch.dryrun``, ``launch.mesh.fake_world``, the kernels' fake-tensor
branches, ``models.attention.attention_options``) and the sharded serving
steps (``launch.steps.make_sharded_prefill_step``/``_decode_step``), on
the CPU.

* ``analytic_hbm_bytes`` and ``roofline_fraction_for`` equal the
  reference's on every admitted (arch, shape) of both production meshes,
  int8 moments both ways (the reference gets a stand-in mesh).
* ``composed_cost``'s stub + n_periods x period + tail equals one trace
  of the whole step, in FLOPs, for train, prefill and decode on reduced
  configs over a fake (2, 2) world.
* Bounds: ``model_flops_per_device <= the port's composed FLOPs <= the
  reference's composed FLOPs`` (XLA counts elementwise work and the remat
  recompute) for reduced mamba2-130m train and tinyllama-1.1b prefill and
  decode at B=8, S=256 on (2, 2); the reference runs in one JAX child on
  4 forced host devices (about 25 s), its census printed beside the port's.
* The census of a reduced ZeRO-3 train step at (2, 2) equals the bytes
  computed from the sharding specs alone.
* Each kernel's fake branch: outputs of the plain version's shapes and
  types, the live bytes of outputs and scratch the CUDA route allocates,
  and (K3 and K3b over the full square, K4) FLOPs equal to
  ``FlopCounterMode`` on the plain version; a real CPU tensor still takes
  the plain version and no fake launch is counted.
* The sharded serving steps on 4 gloo ranks (``tests/_torch_tp_ranks.py``,
  a child process, about 25 s) equal the unsharded ones within 1e-5 for
  reduced tinyllama-1.1b, mamba2-130m and recurrentgemma-9b under the
  ``tp`` rules and llama4-scout and llama4-maverick under ``ep_tp``.
* ``python -m repro_torch.launch.dryrun --out`` as a child process writes
  records with the reference's keys, which the port's and the reference's
  ``lm_latency_model`` read alike; ``--composed`` adds the breakdown,
  whose FLOPs equal the whole step's; no flag stands for the reference's
  attention chunk (P14); the private PyTorch names the trace uses are
  checked.
* One placement rule (``distributed.sharding.row_axes``) for the kernels'
  shards and the residual stream; ``fsdp.serving_view``.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as J_ARCHS
from repro.configs.shapes import SHAPES as J_SHAPES
from repro.launch import memmodel as j_memmodel
from repro.serving import profiles as j_profiles
from repro_torch import kernels
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_supported
from repro_torch.distributed.policies import make_policy
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import costmodel as cm
from repro_torch.launch import memmodel
from repro_torch.launch import shardings as shd
from repro_torch.launch.hlo_analysis import StepTrace
from repro_torch.launch.mesh import fake_world, make_mesh, make_production_mesh
from repro_torch.models import LM
from repro_torch.models.attention import _attn_opts, attention_options
from repro_torch.serving import profiles as t_profiles
from repro_torch.trees import tree_map

REPO = Path(__file__).resolve().parents[1]
PROD = {"pod": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}
COMPOSE_ARCHS = ("tinyllama-1.1b", "mamba2-130m", "recurrentgemma-9b")
STEPS = ("train", "prefill", "decode")
BOUND_CELLS = (("mamba2-130m", "train"), ("tinyllama-1.1b", "prefill"),
               ("tinyllama-1.1b", "decode"))
BOUND_B, BOUND_S = 8, 256
TP_ARCHS = ("tinyllama-1.1b", "mamba2-130m", "recurrentgemma-9b", "llama4-scout-17b-16e",
            "llama4-maverick-400b-128e")
TP_ATOL = 1e-5
# Reduced llama4-scout whose MoE capacity drops tokens, top-1 and top-2
# (tests/_torch_tp_ranks.py, VARIANTS).
TP_DROPS = ("llama4-scout-17b-16e/drops", "llama4-scout-17b-16e/drops-top2")
# Reduced mamba2-130m with two SSD groups: B and C split over ``model`` with
# the heads (tests/_torch_tp_ranks.py, VARIANTS).
TP_GROUPED = ("mamba2-130m/g2",)


class _RefMesh:
    """What the reference's memory model reads of a mesh."""

    def __init__(self, dims: dict):
        self.shape = dict(dims)
        self.devices = np.empty(tuple(dims.values()))


def _run(args, env=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run([sys.executable, *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


# ----------------------------------------------------------- memmodel


@pytest.mark.parametrize("mesh", sorted(PROD))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_memmodel_matches_reference(arch, mesh):
    for shape_name in SHAPES:
        if not cell_supported(arch, shape_name)[0]:
            continue
        for quant in (False, True):
            got = memmodel.analytic_hbm_bytes(ARCHS[arch], SHAPES[shape_name], PROD[mesh],
                                              opt_quantized=quant)
            want = j_memmodel.analytic_hbm_bytes(J_ARCHS[arch], J_SHAPES[shape_name],
                                                 _RefMesh(PROD[mesh]), opt_quantized=quant)
            assert got == want, (shape_name, quant)


@pytest.mark.parametrize("step", STEPS)
def test_roofline_fraction_matches_reference(step):
    for terms in ((1e-3, 2e-3, 5e-4), (3e-3, 1e-3, 0.0), (0.0, 0.0, 0.0), (1e-4, 1e-4, 2e-4)):
        for frac in (1.0, 0.37, 2.0):
            assert (memmodel.roofline_fraction_for(step, *terms, useful_flops_frac=frac)
                    == j_memmodel.roofline_fraction_for(step, *terms, useful_flops_frac=frac))


# ----------------------------------------------------------- the fake world


def test_fake_world_meshes_and_refusal():
    with fake_world(256):
        mesh = make_production_mesh()
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.mesh.shape) == (16, 16)
        with pytest.raises(RuntimeError, match="needs a process without a process group"):
            with fake_world(4):
                pass
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        assert tuple(mesh.mesh.shape) == (2, 16, 16)
    with pytest.raises(ValueError, match="needs as many ranks"):
        make_production_mesh(device="cpu")


def test_attention_options_thread_local():
    seen = {}

    def other():
        seen["other"] = (_attn_opts(), flash_ops._skip_masked())

    with attention_options(unroll=True, skip_masked_blocks=True):
        assert _attn_opts() == {"unroll": True, "skip": True} and flash_ops._skip_masked()
        assert flash_ops._key_tile(torch.bfloat16, 256) == 64
        assert flash_ops._key_tile(torch.float32, 256) == flash_ops._key_tile(torch.bfloat16, 64)
        with attention_options():
            assert not flash_ops._skip_masked()
        assert flash_ops._skip_masked()
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert seen["other"] == ({"unroll": False, "skip": False}, False)
    assert _attn_opts() == {"unroll": False, "skip": False} and not flash_ops._skip_masked()


# ----------------------------------------------------------- composition


def _whole(cfg, shape, mesh, policy):
    with cm.fake_mode():
        fn, args, inputs = cm.step_setup(cfg, shape, mesh, policy)
        return cm.trace(fn, args, inputs)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("arch", COMPOSE_ARCHS)
def test_composed_cost_equals_the_whole_step(arch, step):
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("cell", 64, 8, step)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        policy = make_policy(cfg, step, mesh)
        whole = _whole(cfg, shape, mesh, policy)
        comp = cm.composed_cost(cfg, shape, mesh, policy)
    assert whole["flops"] > 0
    assert comp["totals"]["flops"] == whole["flops"]
    parts = comp["stub"]["flops"] + cfg.n_periods * comp["period"]["flops"] + (
        comp["tail"]["flops"] if comp["tail"] else 0.0)
    assert parts == comp["totals"]["flops"]


def test_skip_masked_blocks_counts_fewer():
    cfg = get_config("tinyllama-1.1b").reduced()
    shape = ShapeSpec("cell", 256, 8, "prefill")
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        policy = make_policy(cfg, "prefill", mesh)
        full = cm.composed_cost(cfg, shape, mesh, policy)["totals"]["flops"]
        skip = cm.composed_cost(cfg, shape, mesh, policy, skip_masked_blocks=True)
    # K3 at 4 tiles of 64 queries: 1 + 2 + 3 + 4 of 16 key tiles.
    area = flash_ops._area((4, 256, 2, 16), (4, 256, 1, 16), 0, 64)
    assert area == 4 * 2 * 10 * 64 * 64
    assert skip["totals"]["flops"] < full


# ----------------------------------------------------------- bounds against the reference

_REF_CHILD = """
import json, sys
import jax
from repro.configs import get_config
from repro.configs.shapes import ShapeSpec
from repro.distributed.policies import make_policy
from repro.launch.costmodel import composed_cost
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for arch, step, b, s in json.loads(sys.argv[1]):
    cfg = get_config(arch).reduced()
    comp = composed_cost(cfg, ShapeSpec("cell", s, b, step), mesh, make_policy(cfg, step, mesh))
    out[arch + "/" + step] = {"flops": comp["totals"]["flops"],
                              "census": {k: comp[k]["collectives"]
                                         for k in ("stub", "period", "tail") if comp[k]}}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_costs():
    cells = [[a, s, BOUND_B, BOUND_S] for a, s in BOUND_CELLS]
    proc = _run(["-c", _REF_CHILD, json.dumps(cells)], timeout=300,
                env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                     "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line.removeprefix("RESULT "))


@pytest.mark.parametrize("arch,step", BOUND_CELLS)
def test_composed_flops_between_model_and_reference(reference_costs, arch, step):
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("cell", BOUND_S, BOUND_B, step)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        comp = cm.composed_cost(cfg, shape, mesh, make_policy(cfg, step, mesh))
    tokens = BOUND_B * (BOUND_S if step != "decode" else 1)
    model = cfg.model_flops_per_token() * tokens / (1.0 if step == "train" else 3.0) / 4
    ref = reference_costs[f"{arch}/{step}"]
    print(f"\n{arch} {step}: model {model:.4g} <= port {comp['totals']['flops']:.4g} <= "
          f"reference {ref['flops']:.4g}")
    print("  port census      ", {k: comp[k]["collectives"] for k in ("stub", "period", "tail")
                                  if comp[k]})
    print("  reference census ", ref["census"])
    assert model <= comp["totals"]["flops"] <= ref["flops"]


# ----------------------------------------------------------- the census


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "mamba2-130m"))
def test_census_of_a_zero3_step_equals_the_specs(arch):
    """ZeRO-3 on (2, 2): each layer's weights gathered once (no remat in the
    reduced configs), the embedding, final norm and head once a step, one
    all-gather per mesh axis that shards a leaf (its result doubling); their
    gradients reduce-scattered axis by axis; a replicated leaf's gradient
    all-reduced over each mesh axis; then 4-byte sums: the global gradient
    norm over each axis and the step's five (token share, loss, aux loss,
    tokens, total loss)."""
    cfg = get_config(arch).reduced()
    shape = ShapeSpec("cell", 32, 8, "train")
    sizes = {"data": 2, "model": 2}
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        policy = make_policy(cfg, "train", mesh)
        census = _whole(cfg, shape, mesh, policy)["collectives"]
    model = LM(cfg)
    specs, shapes = shd.param_pspecs(model, policy, mesh), model.abstract_params()
    want = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}

    def leaf(t, spec, stacked):
        dims = tuple(t.shape)[1:] if stacked else tuple(t.shape)
        spec = tuple(spec)[1:] if stacked else tuple(spec)
        full = int(np.prod(dims)) * t.dtype.itemsize
        reps = t.shape[0] if stacked else 1
        axes = [a for ax in spec if ax is not None
                for a in (ax if isinstance(ax, tuple) else (ax,))]
        if not axes:
            want["all-reduce"] += reps * full * len(sizes)
            return
        local = full // int(np.prod([sizes[a] for a in axes]))
        for i in range(1, len(axes) + 1):
            grown = local * int(np.prod([sizes[a] for a in axes[:i]]))
            want["all-gather"] += reps * grown
            want["reduce-scatter"] += reps * full * local // grown
    for key in ("embed", "final_norm", "lm_head"):
        if key in shapes:
            tree_map(lambda t, s: leaf(t, s, False), shapes[key], specs[key])
    for kind_shapes, kind_specs in zip(shapes["blocks"], specs["blocks"]):
        tree_map(lambda t, s: leaf(t, s, True), kind_shapes, kind_specs)
    for kind_shapes, kind_specs in zip(shapes["tail"], specs["tail"]):
        tree_map(lambda t, s: leaf(t, s, False), kind_shapes, kind_specs)
    want["all-reduce"] += 4 * len(sizes) + 4 * 5
    assert {k: census[k]["bytes"] for k in want} == want
    assert census["total_bytes"] == sum(want.values())


# ----------------------------------------------------------- fake branches


def _fake_call(fn, *args):
    """``fn`` on fake copies of ``args`` (tensors), traced: (outputs, trace)."""
    kernels.reset_launch_counts()
    with cm.fake_mode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        with StepTrace(fargs) as t:
            out = fn(*fargs)
    return out, t


def _meta(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.dtype)
    return tuple(None if o is None else _meta(o) for o in out)


def _bytes(*shapes_dtypes):
    return sum(-(-int(np.prod(s)) * d.itemsize // 512) * 512 for s, d in shapes_dtypes)


def _rand(*shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen).to(dtype)


def _k3_args(dtype=torch.float32, b=2, s=48, hq=4, hkv=2, d=16):
    return _rand(b, s, hq, d, dtype=dtype), _rand(b, s, hkv, d, dtype=dtype, seed=1), \
        _rand(b, s, hkv, d, dtype=dtype, seed=2)


def _check_fake(name, fn, args, scratch):
    """The fake branch of ``fn`` against its plain version on ``args``:
    shapes and types, one fake launch and no real one, live bytes of the
    outputs plus ``scratch`` ((shape, dtype) pairs)."""
    plain = fn(*args)
    out, t = _fake_call(fn, *args)
    assert _meta(out) == _meta(plain)
    counts, fakes = kernels.launch_counts(), kernels.fake_launch_counts()
    assert fakes[name] == 1 and counts[name] == 0
    outs = [plain] if isinstance(plain, torch.Tensor) else [o for o in plain if o is not None]
    assert t.peak - t.start_bytes == _bytes(*[(tuple(o.shape), o.dtype) for o in outs],
                                            *scratch)
    return t


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("lse", (False, True))
def test_k3_fake_branch(dtype, lse):
    q, k, v = _k3_args(dtype)
    t = _check_fake("flash_attention",
                    lambda q, k, v: flash_ops.flash_attention(q, k, v, return_lse=lse),
                    (q, k, v), [])
    with FlopCounterMode(display=False) as fc:
        flash_ops.flash_attention(q, k, v, return_lse=lse)
    assert t.flops == fc.get_total_flops() == 4 * 2 * 4 * 48 * 48 * 16


@pytest.mark.parametrize("d,groups", ((16, 1), (256, 4)))
def test_k3b_fake_branch(d, groups):
    dtype = torch.bfloat16 if d == 256 else torch.float32
    b, s, hq, hkv = 1, 48, 4, 1
    q, k, v = _k3_args(dtype, b, s, hq, hkv, d)
    o, lse = flash_ops.flash_attention(q, k, v, return_lse=True)
    do = _rand(*q.shape, dtype=dtype, seed=5)
    plan = flash_ops.bwd_plan(b, s, hq, hkv, d, dtype)
    assert plan["groups"] == groups
    scratch = [((b, hq, s), torch.float32)] + (
        [((plan["scratch"],), torch.float32)] if plan["scratch"] else [])
    t = _check_fake("flash_attention_bwd", flash_ops.flash_attention_bwd,
                    (q, k, v, o, do, lse), scratch)
    with FlopCounterMode(display=False) as fc:
        flash_ops.flash_attention_bwd(q, k, v, o, do, lse)
    assert t.flops == fc.get_total_flops() == 10 * b * hq * s * s * d


def test_k4_fake_branch():
    b, s, hq, hkv, d = 3, 40, 4, 2, 16
    q = _rand(b, 1, hq, d)
    kc, vc = _rand(b, s, hkv, d, seed=1), _rand(b, s, hkv, d, seed=2)
    lengths = torch.tensor([40, 7, 19], dtype=torch.int32)
    t = _check_fake("decode_attention", decode_ops.decode_attention, (q, kc, vc, lengths), [])
    with FlopCounterMode(display=False) as fc:
        decode_ops.decode_attention(q, kc, vc, lengths)
    assert t.flops == fc.get_total_flops() == 4 * b * hq * s * d


def _ssd_args(b=2, s=32, h=3, p=8, n=16):
    xdt = _rand(b, s, h, p)
    da = -torch.rand((b, s, h), generator=torch.Generator().manual_seed(3))
    return xdt, da, _rand(b, s, n, seed=4), _rand(b, s, n, seed=5)


def test_k5_fake_branch():
    xdt, da, bm, cm_ = _ssd_args()
    b, s, h, p = xdt.shape
    n, chunk = bm.shape[-1], 8
    nc = s // chunk
    f32 = torch.float32
    # The CUDA route's stages: cum and the chunk ends, scores, the chunk
    # states, beside y and the final state.
    scratch = [((b, h, nc, chunk), f32), ((b, h, nc, chunk), f32), ((b, nc, chunk, chunk), f32),
               ((b, nc, h, n, p), f32)]
    t = _check_fake("ssd", lambda *a: ssd_ops.ssd_chunk_scan(*a, chunk), (xdt, da, bm, cm_),
                    scratch)
    assert t.flops == ssd_ops.ssd_flops(b, s, h, p, n, chunk) > 0
    saved = ssd_ops.ssd_chunk_scan_saving(xdt, da, bm, cm_, chunk)
    out, _ = _fake_call(lambda *a: ssd_ops.ssd_chunk_scan_saving(*a, chunk), xdt, da, bm, cm_)
    assert _meta(out) == _meta(saved)


def test_k5b_fake_branch():
    xdt, da, bm, cm_ = _ssd_args()
    chunk = 8
    b, s, h, p = xdt.shape
    n, nc = bm.shape[-1], s // chunk
    _, _, cum, entering = ssd_ops.ssd_chunk_scan_saving(xdt, da, bm, cm_, chunk)
    dy = _rand(*xdt.shape, seed=9)
    f32 = torch.float32
    scratch = [((b, nc, chunk, chunk), f32), ((b, nc, h, n, p), f32),
               ((b, h, nc, -(-p // ssd_ops.PASS_ROWS)), f32)] + [((b, h, nc, chunk), f32)] * 3 + [
        ((b, nc, h, chunk, chunk), f32), ((b, nc, chunk, chunk), f32), ((b, s, h, n), f32),
        ((b, s, h, n), f32)]
    t = _check_fake("ssd_bwd", lambda *a: ssd_ops.ssd_chunk_bwd(*a, chunk),
                    (xdt, bm, cm_, dy, cum, entering), scratch)
    assert t.flops == 2 * ssd_ops.ssd_flops(b, s, h, p, n, chunk)


def _rglru_args(b=2, s=150, width=8, dtype=torch.float32):
    vecs = [_rand(width, dtype=dtype, seed=i) * 0.1 for i in range(2, 7)]
    return [_rand(b, s, width, dtype=dtype), _rand(b, s, width, dtype=dtype, seed=1)] + vecs


@pytest.mark.parametrize("saving", (False, True))
def test_rglru_fake_branch(saving):
    args = _rglru_args()
    b, s, width = args[0].shape
    fn = rglru_ops.rglru_scan_saving if saving else rglru_ops.rglru_scan
    scratch = [((2, b, -(-s // rglru_ops.CHUNK) - 1, width), torch.float32)]
    if saving:  # the plain version keeps every step's carry; the kernel one per span
        plain = fn(*args)
        out, t = _fake_call(fn, *args)
        assert _meta(out[:2]) == _meta(plain[:2])
        assert tuple(out[2].shape) == (b, -(-s // rglru_ops.CARRY), width)
        assert kernels.fake_launch_counts()["rglru_scan"] == 1
    else:
        t = _check_fake("rglru_scan", fn, args, scratch)
    assert t.flops == rglru_ops.FLOPS_PER_STEP * b * s * width


def test_rglru_bwd_fake_branch():
    args = _rglru_args(s=70)
    b, s, width = args[0].shape
    _, _, carries = rglru_ops.rglru_scan_saving(*args)
    dy = _rand(b, s, width, seed=8)
    want = rglru_ops.rglru_scan_bwd(*args, carries, dy, want_dh0=True)
    kernels.reset_launch_counts()
    with cm.fake_mode() as mode:
        fargs = [mode.from_tensor(a) for a in args]
        fcarries = torch.empty((b, -(-s // rglru_ops.CARRY), width))
        fdy = mode.from_tensor(dy)
        with StepTrace(fargs + [fcarries, fdy]) as t:
            out = rglru_ops.rglru_scan_bwd(*fargs, fcarries, fdy, want_dh0=True)
    assert _meta(out) == _meta(want)
    assert kernels.fake_launch_counts()["rglru_scan_bwd"] == 1
    scratch = ((rglru_ops.bwd_scratch_elems(b, s, width, rglru_ops.CHUNK, rglru_ops.GROUP),),
               torch.float32)
    assert t.peak - t.start_bytes == _bytes(*[(tuple(o.shape), o.dtype) for o in want],
                                            scratch)
    assert t.flops == 2 * rglru_ops.FLOPS_PER_STEP * b * s * width


def test_real_cpu_tensors_take_the_plain_versions():
    q, k, v = _k3_args()
    kernels.reset_launch_counts()
    out = flash_ops.flash_attention(q, k, v)
    ref = flash_ops.flash_attention_ref(flash_ops._gqa(q, 2), k.transpose(1, 2),
                                        v.transpose(1, 2))
    torch.testing.assert_close(out, flash_ops._model(ref), atol=0, rtol=0)
    xdt, da, bm, cm_ = _ssd_args()
    ssd_ops.ssd_chunk_scan(xdt, da, bm, cm_, 8)
    rglru_ops.rglru_scan(*_rglru_args())
    lengths = torch.full((2,), 48, dtype=torch.int32)
    decode_ops.decode_attention(q[:, :1], k, v, lengths)
    assert not any(kernels.fake_launch_counts().values())
    assert not any(kernels.launch_counts().values())


# ----------------------------------------------------------- sharded serving steps


@pytest.fixture(scope="module")
def tp_run():
    with tempfile.TemporaryDirectory() as d:
        job = {"world": 4, "store": str(Path(d) / "store"), "out": d, "mesh": [2, 2],
               "batch": 4, "seq": 24, "steps": 3, "archs": list(TP_ARCHS + TP_DROPS + TP_GROUPED)}
        Path(d, "job.json").write_text(json.dumps(job))
        proc = _run([str(REPO / "tests" / "_torch_tp_ranks.py"), str(Path(d, "job.json"))],
                    timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return json.loads(Path(d, "tp.json").read_text())


@pytest.mark.parametrize("arch", TP_ARCHS + TP_GROUPED)
def test_sharded_serving_steps_match_unsharded(tp_run, arch):
    diffs = tp_run[arch]
    assert diffs.pop("pos") == 24 + 3
    assert len(diffs) == 2 + 2 * 3
    bad = {k: v for k, v in diffs.items() if not v <= TP_ATOL}
    assert not bad, bad


@pytest.mark.parametrize("arch", TP_DROPS)
def test_sharded_moe_drops_route_as_unsharded(tp_run, arch):
    """A capacity that drops tokens: every sharded MoE call routes its
    groups' tokens to the experts and slots the unsharded call gives them,
    drops included, and the logits and caches agree as in the drop-free
    configs (top-2's two terms are summed over ``model``: rounding)."""
    diffs = tp_run[arch]
    assert diffs.pop("pos") == 24 + 3
    assert diffs.pop("routes") == 0
    assert diffs.pop("dropped") > 0
    bad = {k: v for k, v in diffs.items() if not v <= TP_ATOL}
    assert not bad, bad


class _DTensorOps(TorchDispatchMode):
    """Records every aten op called with a DTensor argument, and whether
    the routed MoE (``models.moe.moe_forward``) was running."""

    def __init__(self):
        super().__init__()
        self.ops: set = set()
        self.in_moe = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            self.ops.add((str(func), self.in_moe))
            return NotImplemented
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_sharded_moe_indexes_no_dtensor(monkeypatch, step):
    """The sharded llama4-scout prefill and decode steps (reduced, bf16,
    ``ep_tp`` rules on a fake (2, 2) world) call no indexing op on a
    DTensor inside the MoE: torch 2.11 has no sharding strategy for the
    dispatch's ``index_put_``.  The one ``aten.index.Tensor`` on DTensors
    is the token embedding's lookup ``table[tokens]``, which DTensor
    shards on every release the port runs on."""
    from repro_torch.models import blocks
    from repro_torch.models import moe as t_moe

    cfg = dataclasses.replace(get_config("llama4-scout-17b-16e").reduced(), dtype="bfloat16")
    mode = _DTensorOps()
    orig = t_moe.moe_forward

    def moe_forward(*args):
        mode.in_moe = True
        try:
            return orig(*args)
        finally:
            mode.in_moe = False

    monkeypatch.setattr(blocks.moe_mod, "moe_forward", moe_forward)
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with cm.fake_mode():
            fn, args, _ = cm.step_setup(cfg, ShapeSpec("cell", 32, 4, step), mesh,
                                        make_policy(cfg, step, mesh))
            with mode:
                logits, _ = fn(*args)
    assert tuple(logits.shape)[0] == 4
    indexing = {"aten.index_put_.default", "aten.index_put.default", "aten.index.Tensor"}
    assert any(in_moe for _, in_moe in mode.ops)  # the MoE ran on DTensors
    assert not {(op, True) for op in indexing} & mode.ops
    assert {op for op, _ in mode.ops} & indexing == {"aten.index.Tensor"}


def test_sharded_decode_writes_the_sequence_sharded_cache():
    """One decode step on a fake (2, 2) world keeps every cache leaf on
    its placements, the K/V slots sharded over ``model``."""
    cfg = get_config("tinyllama-1.1b").reduced()
    shape = ShapeSpec("cell", 32, 4, "decode")
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        policy = make_policy(cfg, "decode", mesh)
        with cm.fake_mode():
            fn, (params, cache, tokens), _ = cm.step_setup(cfg, shape, mesh, policy)
            before = [{k: tuple(v.placements) for k, v in c.items()} for c in cache["layers"]]
            logits, cache = fn(params, cache, tokens)
            after = [{k: tuple(v.placements) for k, v in c.items()} for c in cache["layers"]]
    assert after == before
    assert str(before[0]["k"]) == "(Shard(dim=0), Shard(dim=1))"
    assert tuple(logits.shape) == (4, cfg.vocab_size)


# ----------------------------------------------------------- the command line


# The reference's keys of an ok record ("composed" only with --composed:
# the whole step's one trace is the total, cost_source "whole_step").
_REF_KEYS = {"arch", "shape", "mesh", "mesh_shape", "step", "params", "active_params",
             "seq_len", "global_batch", "lower_s", "compile_s", "memory_analysis",
             "hbm_per_device_bytes", "cost_analysis", "collectives", "hlo_len",
             "cost_source", "hbm_traffic_model", "hlo_bytes_accessed_upper_bound", "roofline",
             "model_flops_total", "model_flops_per_device", "useful_flops_ratio", "status",
             "total_s"}


def test_dryrun_cli_records_read_by_both_profiles():
    arch = "mamba2-130m"
    with tempfile.TemporaryDirectory() as d:
        proc = _run(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", "prefill_32k",
                     "--shape", "decode_32k", "--shape", "long_500k", "--mesh", "pod",
                     "--out", d], timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert proc.stdout.count("[ok]") == 3
        for shape in ("prefill_32k", "decode_32k"):
            rec = json.loads(Path(d, f"{arch}__{shape}__pod.json").read_text())
            assert rec["status"] == "ok" and _REF_KEYS <= set(rec)
            assert rec["cost_source"] == "whole_step" and "composed" not in rec
            assert rec["mesh_shape"] == PROD["pod"]
            assert rec["hbm_per_device_bytes"] == (
                rec["memory_analysis"]["argument_size_in_bytes"]
                + rec["memory_analysis"]["temp_size_in_bytes"])
            assert rec["roofline"]["t_max_s"] > 0
        got = t_profiles.lm_latency_model(d, arch)
        assert got == j_profiles.lm_latency_model(d, arch)
        with tempfile.TemporaryDirectory() as empty:
            assert got != t_profiles.lm_latency_model(empty, arch)  # the roofline branch
    assert not (REPO / "results" / "dryrun").exists()


def test_dryrun_composed_breakdown_and_options_in_the_record():
    """``composed=True`` adds the breakdown, whose FLOPs equal the whole
    step's that the roofline uses; the attention options in force are
    written into the record."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.hlo_analysis import HW

    cfg = get_config("tinyllama-1.1b").reduced()
    shape = ShapeSpec("cell", 256, 8, "prefill")  # 4 query tiles of K3
    rec = dryrun.dry_run(cfg, shape, {"data": 2, "model": 2})
    assert "composed" not in rec and rec["cost_source"] == "whole_step"
    assert rec["attention_options"] == {"unroll": False, "skip_masked_blocks": False}
    assert rec["roofline"]["t_compute_s"] == rec["cost_analysis"]["flops"] / HW["peak_flops_bf16"]
    assert rec["roofline"]["t_collective_s"] == (rec["collectives"]["total_bytes"]
                                                 / HW["ici_bw"])
    with attention_options(unroll=True, skip_masked_blocks=True):
        skip = dryrun.dry_run(cfg, shape, {"data": 2, "model": 2}, composed=True)
    assert skip["attention_options"] == {"unroll": True, "skip_masked_blocks": True}
    assert skip["composed"]["totals"]["flops"] == skip["cost_analysis"]["flops"]
    assert skip["cost_analysis"]["flops"] < rec["cost_analysis"]["flops"]
    assert set(skip["composed"]) == {"stub", "period", "tail", "totals"}


def test_dryrun_has_no_attention_chunk_flag():
    """P14: the reference's REPRO_ATTN_CHUNK sets its XLA attention's
    chunks; K3's tiles are fixed, so the port offers no flag for it."""
    import inspect

    from repro_torch.launch import dryrun

    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--attn-chunk", "256", "--list"])
    assert exc.value.code == 2
    assert "attn_chunk" not in inspect.signature(dryrun.run_cell).parameters
    assert dryrun.main(["--list", "--arch", "mamba2-130m", "--mesh", "pod"]) == 0


def test_dryrun_checks_the_torch_internals_it_uses(monkeypatch):
    """The private PyTorch names the dry run leans on are present here, and
    a release without one is refused by name before any trace runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch import hlo_analysis

    assert hlo_analysis.missing_internals() == []
    monkeypatch.delattr(ShardingPropagator, "_propagate_tensor_meta_non_cached")
    want = (f"torch {torch.__version__} lacks: torch.distributed.tensor._sharding_prop."
            "ShardingPropagator._propagate_tensor_meta_non_cached")
    with pytest.raises(RuntimeError, match=re.escape(want)):
        StepTrace().__enter__()
    with pytest.raises(RuntimeError, match="lacks"):
        with fake_world(4):
            pass
    assert not torch.distributed.is_initialized()


def test_row_axes_one_rule_for_rows_and_heads():
    """``distributed.sharding.row_axes``: rows over every axis but
    ``model`` when they divide, else over ``data``, else whole; the
    kernels' shards and the residual stream take it alike."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import heads_divide, row_axes, rows_heads, rows_over_data

    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        assert row_axes(mesh, 8, 4) == ["pod", "data"]
        assert row_axes(mesh, 8, 2) == ["data"]
        assert row_axes(mesh, 3) == []
        assert heads_divide(mesh, 4, 2) and not heads_divide(mesh, 4, 3)
        assert rows_heads(mesh, ["data"], 0, 2) == (Replicate(), Shard(0), Shard(2))
        assert rows_heads(mesh, ["pod", "data"], None, None) == (Replicate(),) * 3
        with cm.fake_mode():
            from torch.distributed.tensor import DTensor

            x = DTensor.from_local(torch.empty((2, 5, 4)), mesh, [Replicate()] * 3,
                                   run_check=False)
            assert tuple(rows_over_data(x).placements) == (Replicate(), Shard(0), Replicate())
            seen = {}

            def local(a):
                seen["shape"] = tuple(a.shape)
                return a

            kernels.on_shards(local, (x,), ((0, 2),), ((0, 2),))
            assert seen["shape"] == (1, 5, 2)


def test_serving_view_gathers_data_shards_and_passes_plain_layers():
    """``fsdp.serving_view``: a layer of plain tensors is itself; a layer
    whose weights are split over ``data`` keeps only its ``model`` shards."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import fsdp

    plain = torch.nn.Linear(4, 4)
    assert fsdp.serving_view(plain) is plain
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        with cm.fake_mode():
            from torch.distributed.tensor import DTensor

            m = torch.nn.Module()
            m.w = torch.nn.Parameter(DTensor.from_local(
                torch.empty((4, 2)), mesh, [Shard(0), Shard(1)], run_check=False))
            m.scale = torch.nn.Parameter(DTensor.from_local(
                torch.empty((4,)), mesh, [Replicate(), Replicate()], run_check=False))
            view = fsdp.serving_view(m)
            assert tuple(view.w.placements) == (Replicate(), Shard(1))
            assert tuple(view.scale.placements) == (Replicate(), Replicate())
            m.w = torch.nn.Parameter(DTensor.from_local(
                torch.empty((8, 2)), mesh, [Replicate(), Shard(1)], run_check=False))
            assert fsdp.serving_view(m) is m


def test_dryrun_records_skipped_and_failed_cells():
    from repro_torch.launch import dryrun

    with tempfile.TemporaryDirectory() as d:
        rec = dryrun.run_cell("tinyllama-1.1b", "long_500k", "pod", out_dir=d)
        assert rec["status"] == "skipped" and "500k" in rec["reason"]
        assert json.loads(Path(d, "tinyllama-1.1b__long_500k__pod.json").read_text()) == rec
        with fake_world(1):  # a process group already up: the cell fails and is written
            rec = dryrun.run_cell("mamba2-130m", "decode_32k", "pod", out_dir=d, suffix="_x")
        assert rec["status"] == "error" and "fake_world" in rec["error"]
        assert Path(d, "mamba2-130m__decode_32k__pod_x.json").exists()


def test_dryrun_one_rank_prediction_counts_the_step_launches():
    """A one-rank mesh's record (chip_smoke.py's prediction): the fake
    launches of a reduced ZeRO-3 train step with remat equal its layers
    twice (forward and recompute) and once for the backward."""
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(), remat=True)
    rec = dryrun.dry_run(cfg, ShapeSpec("cell", 64, 4, "train"), {"data": 1, "model": 1})
    assert rec["launches"] == {"ssd": 2 * cfg.num_layers, "ssd_bwd": cfg.num_layers}
    assert rec["hbm_per_device_bytes"] > rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["collectives"]["total_bytes"] > 0


def test_heads_that_do_not_divide_run_whole():
    """P13: with 2 KV heads on a model axis of 4, K3 takes every head on
    every model rank (its FLOPs those of all 4 query heads a layer)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    shape = ShapeSpec("cell", 64, 4, "prefill")
    with fake_world(4):
        mesh = make_mesh((1, 4), ("data", "model"))
        policy = make_policy(cfg, "prefill", mesh)
        with cm.fake_mode():
            fn, args, inputs = cm.step_setup(cfg, shape, mesh, policy)
            with StepTrace(inputs) as t:
                fn(*args)
    per_layer = 4 * 4 * cfg.num_heads * 64 * 64 * cfg.head_dim
    assert t.flops_by_op["repro_torch.flash_attention"] == cfg.num_layers * per_layer


def test_a_trace_leaves_no_fake_tensor_behind():
    """A fake trace first, then the same model on real CPU tensors in this
    process: nothing the trace made (the rope frequencies' cache) reaches
    the real run."""
    from repro_torch.models.layers import _rope_freqs

    cfg = get_config("tinyllama-1.1b").reduced()
    _rope_freqs.cache_clear()
    with fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        _whole(cfg, ShapeSpec("cell", 32, 4, "prefill"), mesh, make_policy(cfg, "prefill", mesh))
    model = LM(cfg)
    params = model.init(0, device="cpu")
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    logits, _ = model.prefill(params, tokens)
    assert not kernels.is_fake(logits) and bool(torch.isfinite(logits).all())
    _rope_freqs.cache_clear()
    torch.testing.assert_close(model.prefill(params, tokens)[0], logits, atol=0, rtol=0)
