"""The port's public entry points take the calls the reference's take.

For each entry point of both packages the parameter names, kinds, order
and defaults are equal.  The only differences allowed are the port's
keyword-only extras — ``device`` everywhere, last, and ``train_n`` of
``build_benchmark_suite`` — and labelled refusals: a name of
``repro.data`` that the port lists in ``NOT_PORTED``.  Also the
reference's calls that used to fail in the port (ROADMAP fault P6):
positional ``workers``, ``backend=`` of the k-NN constructors and
``SwapManager.is_resident``.
"""
import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.data as jdata
import repro_torch.data as tdata
from repro.core import pipeline as jpipe
from repro.core import scheduler as jsched
from repro.core import shard as jshard
from repro.core import simulator as jsim
from repro.core import sneakpeek as jsneak
from repro.data import applications as japps
from repro.launch import steps as jsteps
from repro.serving import runtime as jruntime
from repro.serving import server as jserver
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer
from repro_torch.core import pipeline as tpipe
from repro_torch.core import scheduler as tsched
from repro_torch.core import shard as tshard
from repro_torch.core import simulator as tsim
from repro_torch.core import sneakpeek as tsneak
from repro_torch.data import applications as tapps
from repro_torch.launch import steps as tsteps
from repro_torch.serving import runtime as truntime
from repro_torch.serving import server as tserver
from repro_torch.training import checkpoint as tckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer as ttrainer

# (reference, port, the port's keyword-only extras)
ENTRY_POINTS = {
    "schedule_window": (jsched.schedule_window, tsched.schedule_window, {"device"}),
    "make_policy": (jsched.make_policy, tsched.make_policy, set()),
    "SchedulerPolicy": (jsched.SchedulerPolicy, tsched.SchedulerPolicy, set()),
    "SchedulerPolicy.schedule": (jsched.SchedulerPolicy.schedule,
                                 tsched.SchedulerPolicy.schedule, {"device"}),
    "Simulation": (jsim.Simulation, tsim.Simulation, {"device"}),
    "run_window": (jsim.run_window, tsim.run_window, {"device"}),
    "WindowPipeline": (jpipe.WindowPipeline, tpipe.WindowPipeline, {"device"}),
    "WindowPipeline.schedule": (jpipe.WindowPipeline.schedule, tpipe.WindowPipeline.schedule,
                                set()),
    "WindowPipeline.run": (jpipe.WindowPipeline.run, tpipe.WindowPipeline.run, set()),
    "ShardedWindowPipeline": (jshard.ShardedWindowPipeline, tshard.ShardedWindowPipeline,
                              {"device"}),
    "pipeline_schedule": (jpipe.pipeline_schedule, tpipe.pipeline_schedule, {"device"}),
    "set_pipeline_backend": (jpipe.set_pipeline_backend, tpipe.set_pipeline_backend, set()),
    "KNNSneakPeek": (jsneak.KNNSneakPeek, tsneak.KNNSneakPeek, {"device"}),
    "make_sneakpeek": (japps.make_sneakpeek, tapps.make_sneakpeek, {"device"}),
    "build_benchmark_suite": (japps.build_benchmark_suite, tapps.build_benchmark_suite,
                              {"train_n", "device"}),
    "EdgeServer": (jserver.EdgeServer, tserver.EdgeServer, {"device"}),
    "SwapManager": (jruntime.SwapManager, truntime.SwapManager, set()),
    "Trainer": (jtrainer.Trainer, ttrainer.Trainer, {"device"}),
    "TrainerConfig": (jtrainer.TrainerConfig, ttrainer.TrainerConfig, set()),
    "OptimizerConfig": (jopt.OptimizerConfig, topt.OptimizerConfig, set()),
    "adamw_step": (jopt.adamw_step, topt.adamw_step, set()),
    "learning_rate": (jopt.learning_rate, topt.learning_rate, set()),
    "LMDataset": (jdata.LMDataset, tdata.LMDataset, set()),
    "LMDataConfig": (jdata.LMDataConfig, tdata.LMDataConfig, set()),
    "checkpoint.save": (jckpt.save, tckpt.save, set()),
    "checkpoint.restore": (jckpt.restore, tckpt.restore, {"device"}),
    "make_train_step": (jsteps.make_train_step, tsteps.make_train_step, set()),
}


def _default(value):
    """A default as compared: a dtype by its name, whichever framework's
    object names it (``OptimizerConfig.master_dtype``)."""
    if isinstance(value, torch.dtype):
        return str(value).removeprefix("torch.")
    if isinstance(value, type) and hasattr(value, "dtype"):  # jnp.float32 and its kind
        return np.dtype(value.dtype).name
    return value


def _params(fn):
    return [(p.name, p.kind, _default(p.default))
            for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_signature_matches_reference(name):
    """Names, kinds, order and defaults equal; the port's extras are
    keyword-only, and ``device`` comes last."""
    ref, port, extras = ENTRY_POINTS[name]
    got = _params(port)
    assert [p for p in got if p[0] not in extras] == _params(ref)
    for pname, kind, _ in got:
        if pname in extras:
            assert kind is inspect.Parameter.KEYWORD_ONLY, pname
    if "device" in extras:
        assert got[-1][0] == "device" and got[-1][2] is None


def test_public_methods_cover_reference():
    """The reference's public methods of the ported classes exist in the port."""
    for ref, port in ((jruntime.SwapManager, truntime.SwapManager),
                      (jpipe.WindowPipeline, tpipe.WindowPipeline),
                      (jshard.ShardedWindowPipeline, tshard.ShardedWindowPipeline),
                      (jsched.SchedulerPolicy, tsched.SchedulerPolicy)):
        missing = {n for n in dir(ref) if not n.startswith("_")} - set(dir(port))
        assert not missing, f"{port.__name__} lacks {sorted(missing)}"


def test_data_exports_cover_reference():
    """``repro_torch.data`` exports every name of the reference's: the
    testbed's from ``data.applications``, the LM pipeline's from
    ``data.lm_data``; nothing is left in ``NOT_PORTED``."""
    from repro_torch.data import lm_data as tlm

    for name in jdata.__all__:
        assert name in tdata.__all__
        home = tlm if name in ("LMDataConfig", "LMDataset") else tapps
        assert getattr(tdata, name) is getattr(home, name)
    assert tdata.NOT_PORTED == {}


# ROADMAP §3, P15: the reference's switch between numpy and Pallas for the
# batched Eq. 2 scores.  In the port the device decides (K1 on the card,
# its plain float64 version on the CPU); a switch to the host on a CUDA
# device would be the fallback the port's rules forbid.
NOT_EXPORTED = {"core": {"set_utility_backend", "get_utility_backend"}}


def _defining_module(package, name: str) -> str:
    """The submodule of ``package`` (the reference's) whose top level
    defines ``name``: a def, a class or an assignment."""
    homes = []
    for path in sorted(Path(package.__path__[0]).glob("*.py")):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                bound = {node.name}
            elif isinstance(node, ast.Assign):
                bound = {t.id for t in node.targets if isinstance(t, ast.Name)}
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                bound = {node.target.id}
            else:
                continue
            if name in bound:
                homes.append(path.stem)
                break
    assert len(homes) == 1, f"{package.__name__}.{name} is defined in {homes}"
    return homes[0]


@pytest.mark.parametrize("sub", ["core", "serving", "configs"])
def test_package_exports_cover_reference(sub):
    """Every name of the reference's ``repro.<sub>.__all__`` is in the
    port's and is the object of the port's module of the same name as the
    reference's defining one; the one exclusion is P15's pair, which the
    port neither exports nor resolves."""
    ref = importlib.import_module(f"repro.{sub}")
    port = importlib.import_module(f"repro_torch.{sub}")
    excluded = NOT_EXPORTED.get(sub, set())
    for name in ref.__all__:
        if name in excluded:
            continue
        assert name in port.__all__, f"repro_torch.{sub} does not export {name}"
        home = _defining_module(ref, name)
        assert getattr(ref, name) is getattr(
            importlib.import_module(f"repro.{sub}.{home}"), name)
        assert getattr(port, name) is getattr(
            importlib.import_module(f"repro_torch.{sub}.{home}"), name), name
    for name in excluded:
        assert name not in port.__all__
        with pytest.raises(AttributeError):
            getattr(port, name)


def test_positional_calls_bind_like_reference():
    """A positional ``workers`` binds to ``workers`` in both packages."""
    for ref, port in ((jsched.schedule_window, tsched.schedule_window),
                      (jsim.Simulation, tsim.Simulation)):
        args = ("p", "r", "a", 0.1, None, False, "W") if ref is jsched.schedule_window \
            else ("p", "a", 0.1, None, False, 0, "W")
        assert inspect.signature(port).bind(*args).arguments["workers"] == "W"
        assert inspect.signature(ref).bind(*args).arguments["workers"] == "W"


def test_build_benchmark_suite_takes_backend():
    """``build_benchmark_suite(backend="numpy")``, as
    examples/multiworker_sim.py:26 calls it, runs on the CPU; the k-NN
    routes are the reference's evidence."""
    j_apps, j_sneaks = japps.build_benchmark_suite(backend="numpy")
    t_apps, t_sneaks = tapps.build_benchmark_suite(backend="numpy", device="cpu")
    assert list(t_apps) == list(j_apps)
    reqs = tapps.make_requests(list(tapps.APP_SPECS.values()), per_app=4, seed=2)
    for name, sp in t_sneaks.items():
        assert sp.backend == "numpy" and sp.device.type == "cpu"
        feats = np.stack([r.features for r in reqs if r.app == name])
        np.testing.assert_array_equal(sp.evidence_batch(feats).numpy(),
                                      j_sneaks[name].evidence_batch(feats))
    positional = tapps.build_benchmark_suite("sigmoid", "uninformative", 5, 0, None, "auto",
                                             device="cpu")
    assert list(positional[0]) == list(j_apps)


def test_knn_backend_maps_to_one_route():
    """"auto" takes ``device``'s route; "jax" asks for the kernel (CUDA),
    "numpy" for the plain version on the CPU; a route ``device`` does not
    give raises."""
    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int32)
    assert tsneak.KNNSneakPeek(x, y, 2, backend="auto", device="cpu").device.type == "cpu"
    assert tsneak.KNNSneakPeek(x, y, 2, 5, "knn", "numpy", device="cpu").backend == "numpy"
    with pytest.raises(ValueError, match="runs on CUDA"):
        tsneak.KNNSneakPeek(x, y, 2, backend="jax", device="cpu")
    with pytest.raises(ValueError, match="unknown k-NN backend"):
        tapps.make_sneakpeek(tapps.APP_SPECS["voice_commands"], backend="faiss", device="cpu")
    # "numpy" on an explicit CUDA device: refused as a route mismatch on a
    # card, and as a missing card here.
    error = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(error):
        tsneak.KNNSneakPeek(x, y, 2, backend="numpy", device="cuda")


def test_swap_manager_is_resident_matches_reference():
    sizes = {"a": 3, "b": 4, "c": 5}
    lat = {"a": 0.1, "b": 0.2, "c": 0.3}
    j, t = jruntime.SwapManager(8, sizes, lat), truntime.SwapManager(8, sizes, lat)
    for name in ["a", "b", "c", "a", "b", "b", "c", "a"]:
        assert t.load(name) == j.load(name)
        for probe in sizes:
            assert t.is_resident(probe) == j.is_resident(probe)
