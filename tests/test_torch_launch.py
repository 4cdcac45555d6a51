"""The port's launch tooling and distribution (repro_torch.launch,
repro_torch.distributed, serving.profiles, CostModelBackend, sharded
training and checkpoints) against the JAX package's, on the CPU.

* The sharding rules: ``make_policy``, ``param_pspecs``,
  ``opt_state_pspecs``, ``cache_pspecs``, ``token_pspec`` and
  ``logits_pspec`` for the ten registered archs x {train, prefill,
  decode} on (data, model) meshes (2, 2) and (4, 4), against the
  reference run in a child process on 16 forced host devices (the
  reference's own tests do not set ``XLA_FLAGS`` in-process).
* The profiles and ``CostModelBackend`` against the reference's with the
  reference's ``HW`` patched to the port's constants and equal device
  counts, within 1e-12 relative.
* ``compressed_psum_tree(axis_name=)`` on 2 and 4 gloo ranks against the
  reference's under ``shard_map`` in the same child process.
* ``Trainer(shardings=)`` (ZeRO-3) on 2 and 4 gloo ranks, meshes
  data,model = 2,1 and 2,2, reduced tinyllama-1.1b and mamba2-130m,
  resumed from the reference Trainer's step-0 checkpoint for 6 steps:
  against the port's and the reference's unsharded Trainers from the same
  checkpoint (first-step gradients within 1e-5, losses and weights within
  1e-4: float32 sums in another order, turned into steps of about the
  learning rate's size by AdamW's eps where a gradient is near zero), and
  the checkpoints across: the reference's restored on the shardings, the
  sharded run's restored unsharded and in the reference.  Faults: from
  ``fault_hook`` on every rank and on rank 1 alone (every rank restores),
  and inside rank 1's step (``launch.train.run_ranks`` starts every rank
  again; the run from the seed ends on the unsharded Trainer's weights).
* The launchers through ``--device cpu``, the sharded one on 4 gloo ranks;
  the serving launcher's requests (arrivals, deadlines, labels) and
  ``Application`` against the reference launcher's, whose ``main`` runs
  with a server that records what it is given (P11).

The multi-rank cases run ``tests/_torch_ranks.py`` in a child process
with a timeout of its own.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.hlo_analysis as j_hlo
from repro.configs import ARCHS as J_ARCHS
from repro.data import LMDataConfig as JLMDataConfig
from repro.data import LMDataset as JLMDataset
from repro.models import LM as JLM
from repro.serving import backends as j_backends
from repro.serving import profiles as j_profiles
from repro.training import OptimizerConfig as JOptimizerConfig
from repro.training import Trainer as JTrainer
from repro.training import TrainerConfig as JTrainerConfig
from repro.training import checkpoint as j_ckpt
from repro_torch import convert
from repro_torch.configs import ARCHS, ModelConfig
from repro_torch.configs.shapes import SHAPES, cell_supported
from repro_torch.data import LMDataConfig, LMDataset
from repro_torch.distributed.policies import make_policy
from repro_torch.distributed.sharding import NamedSharding, PartitionSpec
from repro_torch.launch import hlo_analysis as t_hlo
from repro_torch.launch import shardings as shd
from repro_torch.launch.steps import input_specs
from repro_torch.models import LM
from repro_torch.serving import profiles as t_profiles
from repro_torch.serving.backends import CostModelBackend
from repro_torch.training import OptimizerConfig, Trainer, TrainerConfig
from repro_torch.training import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
MESHES = [(2, 2), (4, 4)]
STEPS = ("train", "prefill", "decode")
TOKEN_BATCHES = (1, 8, 16, 32)
CACHE_SHAPE = (8, 64)  # batch, max_len of the caches whose specs are compared
SHARDED_MESHES = [(2, 1), (2, 2)]
TRAIN_ARCHS = ("tinyllama-1.1b", "mamba2-130m")
DATA = dict(seq_len=16, global_batch=8, kind="markov")
OPT = dict(learning_rate=3e-3, warmup_steps=2, total_steps=1000)
TRAINER = dict(total_steps=7, checkpoint_every=1000, log_every=1)  # resumes at 1: 6 steps
STEP_FAULT_ARCH = "tinyllama-1.1b"  # rank 1 fails inside its third step once
STEP_FAULT_STEPS = 4
GRAD_ATOL = 1e-5
STATE_ATOL = 1e-4


class _FakeMesh:
    """Axis names and sizes: all the rules read of a mesh."""

    def __init__(self, dims):
        self.shape = dict(zip(("data", "model"), dims))
        self.axis_names = ("data", "model")


def _enc(x):
    """Specs and rules as JSON-comparable data, tuples kept apart from lists."""
    if isinstance(x, PartitionSpec) or type(x).__name__ == "PartitionSpec":
        return {"P": [_enc(e) for e in x]}
    if isinstance(x, tuple):
        return {"t": [_enc(e) for e in x]}
    if isinstance(x, list):
        return [_enc(e) for e in x]
    if isinstance(x, dict):
        return {k: _enc(v) for k, v in x.items()}
    return x


def _flat(tree, prefix=""):
    """{path: leaf}, dict keys sorted."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}[{i}]").items()}
    return {prefix: tree}


def _arrays(tree):
    return {k: np.asarray(v.detach().float().numpy() if isinstance(v, torch.Tensor) else v,
                          np.float64)
            for k, v in _flat(tree).items()}


def _assert_close(got, want, atol, what):
    g, w = _arrays(got), _arrays(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        np.testing.assert_allclose(g[k], w[k], atol=atol, rtol=0, err_msg=f"{what}: {k}")


# ----------------------------------------------------- the reference's child


_REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=16"
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.configs import ARCHS
    from repro.distributed.policies import make_policy
    from repro.launch import shardings as shd
    from repro.models import LM
    from repro.training import OptimizerConfig
    from repro.training.compression import compressed_psum_tree, init_error_feedback

    args = json.loads(sys.argv[1])

    def enc(x):
        if isinstance(x, P):
            return {"P": [enc(e) for e in x]}
        if isinstance(x, tuple):
            return {"t": [enc(e) for e in x]}
        if isinstance(x, list):
            return [enc(e) for e in x]
        if isinstance(x, dict):
            return {k: enc(v) for k, v in x.items()}
        return x

    def mesh_of(dims, n=None):
        devs = np.array(jax.devices()[:dims[0] * dims[1]]).reshape(dims)
        return Mesh(devs, ("data", "model"))

    specs = {}
    for dims in args["meshes"]:
        mesh = mesh_of(dims)
        key = f"{dims[0]}x{dims[1]}"
        for arch, cfg in ARCHS.items():
            model = LM(cfg)
            out = specs.setdefault(key, {}).setdefault(arch, {})
            for step in args["steps"]:
                pol = make_policy(cfg, step, mesh)
                out[step] = {
                    "param_rules": enc(dict(pol.param_rules)),
                    "act_rules": enc(dict(pol.act_rules)),
                    "params": enc(shd.param_pspecs(model, pol, mesh)),
                    "opt": enc(shd.opt_state_pspecs(model, pol, mesh, OptimizerConfig())),
                    "opt_q": enc(shd.opt_state_pspecs(
                        model, pol, mesh, OptimizerConfig(quantize_moments=True))),
                }
            out["cache"] = enc(shd.cache_pspecs(model.abstract_cache(*args["cache"]), mesh))
            out["logits"] = {str(b): enc(shd.logits_pspec(cfg, b, mesh)) for b in args["batches"]}
        specs[key]["token"] = {f"{b}/{int(f)}": enc(shd.token_pspec(b, mesh, full_mesh=f))
                               for b in args["batches"] for f in (False, True)}

    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:
        from jax.experimental.shard_map import shard_map
    compressed = {}
    for dims in args["sharded"]:
        mesh = mesh_of(dims)
        world = dims[0] * dims[1]
        rounds = [np.concatenate([np.random.default_rng(100 + r).normal(size=(3, 16, 32))
                                  .astype(np.float32)[i] for r in range(world)])
                  for i in range(3)]
        for axis, size in zip(("data", "model"), dims):
            if size == 1:
                continue

            def one(g, e, axis=axis):
                out, ne = compressed_psum_tree({"w": g}, {"w": e}, axis_name=axis)
                return out["w"], ne["w"]

            spec = P(("data", "model"))
            f = jax.jit(shard_map(one, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec)))
            e = np.zeros_like(rounds[0])
            for i, g in enumerate(rounds):
                out, e = f(g, e)
                compressed[f"{dims[0]}x{dims[1]}/{axis}/out{i}"] = np.asarray(out).tolist()
                compressed[f"{dims[0]}x{dims[1]}/{axis}/ef{i}"] = np.asarray(e).tolist()
    print(json.dumps({"specs": specs, "compressed": compressed}))
""")


@pytest.fixture(scope="module")
def reference():
    """The reference's specs and compressed all-reduces, from one child
    process with 16 forced host devices."""
    args = {"meshes": MESHES, "steps": STEPS, "cache": CACHE_SHAPE,
            "batches": TOKEN_BATCHES, "sharded": SHARDED_MESHES}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, json.dumps(args)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ----------------------------------------------------------- rules and specs


def _port_cache_specs(ref_cache, cfg):
    """The reference's cache specs in the port's layout: one dict per
    layer, a stacked leaf's spec without its leading (periods) entry."""
    full = cfg.n_periods * cfg.period
    layers = []
    for i in range(cfg.num_layers):
        if i < full:
            stacked = ref_cache["blocks"][i % cfg.period]
            layers.append({k: {"P": v["P"][1:]} for k, v in stacked.items()})
        else:
            layers.append(ref_cache["tail"][i - full])
    return {"layers": layers, "pos": ref_cache["pos"]}


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_policies_and_specs_match_reference(reference, arch, dims):
    """Every rule set and every spec the launch tooling builds, equal to
    the reference's for one arch on one mesh, for each step."""
    mesh = _FakeMesh(dims)
    ref = reference["specs"][f"{dims[0]}x{dims[1]}"]
    cfg = ARCHS[arch]
    model = LM(cfg)
    for step in STEPS:
        pol = make_policy(cfg, step, mesh)
        want = ref[arch][step]
        assert _enc(dict(pol.param_rules)) == want["param_rules"], step
        assert _enc(dict(pol.act_rules)) == want["act_rules"], step
        assert _enc(shd.param_pspecs(model, pol, mesh)) == want["params"], step
        assert _enc(shd.opt_state_pspecs(model, pol, mesh, OptimizerConfig())) == want["opt"]
        assert (_enc(shd.opt_state_pspecs(model, pol, mesh,
                                          OptimizerConfig(quantize_moments=True)))
                == want["opt_q"]), step
    assert (_enc(shd.cache_pspecs(model.abstract_cache(*CACHE_SHAPE), mesh))
            == _port_cache_specs(ref[arch]["cache"], cfg))
    for b in TOKEN_BATCHES:
        assert _enc(shd.logits_pspec(cfg, b, mesh)) == ref[arch]["logits"][str(b)]
        for full in (False, True):
            got = shd.token_pspec(b, mesh, full_mesh=full)
            assert _enc(got) == ref["token"][f"{b}/{int(full)}"]


def test_named_sharding_placements_and_shapes():
    """A spec's placements on a mesh: Shard on the mesh dims it names (a
    joint entry in the mesh's order), Replicate elsewhere; the shapes,
    cells and input stand-ins as the reference's."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = _FakeMesh((2, 2))
    assert NamedSharding(mesh, PartitionSpec("model", "data")).placements == (Shard(1), Shard(0))
    assert (NamedSharding(mesh, PartitionSpec(None, ("data", "model"))).placements
            == (Shard(1), Shard(1)))
    assert NamedSharding(mesh, PartitionSpec()).placements == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="order"):
        NamedSharding(mesh, PartitionSpec(("model", "data"))).placements
    from repro.configs import shapes as j_shapes
    from repro.launch.steps import input_specs as j_input_specs

    assert {k: dataclasses.astuple(v) for k, v in SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in j_shapes.SHAPES.items()}
    for arch in ARCHS:
        for shape in SHAPES:
            assert cell_supported(arch, shape) == j_shapes.cell_supported(arch, shape)
            got = input_specs(ARCHS[arch], SHAPES[shape])["tokens"]
            want = j_input_specs(J_ARCHS[arch], j_shapes.SHAPES[shape])["tokens"]
            assert got.device.type == "meta" and tuple(got.shape) == tuple(want.shape)
            assert got.dtype == torch.int32


def test_mesh_larger_than_the_world_raises():
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    with pytest.raises(ValueError, match="needs as many ranks"):
        make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="needs as many ranks"):
        make_production_mesh(device="cpu")


# ----------------------------------------------------------- profiles


@pytest.fixture
def port_hw(monkeypatch):
    """The reference's roofline constants set to the port's (one H100)."""
    for key, value in t_hlo.HW.items():
        monkeypatch.setitem(j_hlo.HW, key, value)
    assert t_hlo.roofline_terms(3e12, 5e9, 7e8) == j_hlo.roofline_terms(3e12, 5e9, 7e8)


def _rel(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_profiles_match_reference(port_hw, arch):
    """Every profile function at equal constants and device counts."""
    cfg, jcfg = ARCHS[arch], J_ARCHS[arch]
    costs = {"flops": 3.1e13, "bytes": 2.2e10, "collective_bytes": 4.0e8, "batch": 4}
    with tempfile.TemporaryDirectory() as d:
        for n in (1, 16):
            _rel(t_profiles.lm_latency_model(d, arch, 256, 16, n_devices=n),
                 j_profiles.lm_latency_model(d, arch, 256, 16, n_devices=n))
            t_terms = t_profiles.costmodel_terms(cfg, 300, 20, n_devices=n)
            j_terms = j_profiles.costmodel_terms(jcfg, 300, 20, n_devices=n)
            assert sorted(t_terms) == sorted(j_terms)
            _rel([t_terms[k] for k in sorted(t_terms)], [j_terms[k] for k in sorted(j_terms)])
            for c in (None, costs):
                _rel(t_profiles.costmodel_latency_model(arch, 300, 20, d, n_devices=n, costs=c),
                     j_profiles.costmodel_latency_model(arch, 300, 20, d, n_devices=n, costs=c))
            tp = t_profiles.costmodel_profile(cfg, [0.7, 0.8], 300, 20, n_devices=n, costs=costs)
            jp = j_profiles.costmodel_profile(jcfg, [0.7, 0.8], 300, 20, n_devices=n, costs=costs)
            for field in ("latency_s", "load_latency_s", "memory_bytes", "latency_model",
                          "recalls", "provenance", "name"):
                got, want = getattr(tp, field), getattr(jp, field)
                if isinstance(want, str):
                    assert got == want
                else:
                    _rel(got, want)
        tp = t_profiles.lm_profile(d, arch, [0.6, 0.9])
        jp = j_profiles.lm_profile(d, arch, [0.6, 0.9])
        # the reference stages a 16-chip slice's shards in parallel, the port one card's
        _rel(tp.load_latency_s, jp.load_latency_s * 16 / t_profiles.N_DEVICES)
        assert tp.memory_bytes == jp.memory_bytes and tp.provenance == jp.provenance
    assert t_profiles.load_dryrun_record(REPO / "results" / "dryrun", arch, "decode_32k") is None


@pytest.mark.parametrize("n_devices", [1, 16])
def test_cost_model_backend_matches_reference(port_hw, n_devices):
    """Affine models, modelled reports, sizes, swap costs and lanes of
    ``CostModelBackend`` as the reference's, for registry names, configs
    and (cfg, seed) pairs."""
    variants = {"a": "mamba2-130m", "b": ARCHS["gemma-7b"], "c": (ARCHS["tinyllama-1.1b"], 3)}
    jvariants = {"a": "mamba2-130m", "b": J_ARCHS["gemma-7b"], "c": (J_ARCHS["tinyllama-1.1b"], 3)}
    costs = {"b": {"flops": 1e13, "bytes": 3e10}}
    tb = CostModelBackend(variants, prompt_tokens=200, new_tokens=10, n_devices=n_devices,
                          costs=costs)
    jb = j_backends.CostModelBackend(jvariants, prompt_tokens=200, new_tokens=10,
                                     n_devices=n_devices, costs=costs)
    lane = tb.spawn()
    assert isinstance(lane, CostModelBackend) and lane is not tb and lane.provenance == "costmodel"
    for name in variants:
        _rel(tb.affine(name), jb.affine(name))
        _rel(lane.affine(name), jb.affine(name))
        for b in (1, 3):
            prompts = np.zeros((b, 7), np.int32)
            t, j = tb.run_batch(name, prompts, list(range(b))), jb.run_batch(
                name, prompts, list(range(b)))
            _rel([t.prefill_s, t.decode_s], [j.prefill_s, j.decode_s])
            assert t.predictions == j.predictions and t.tokens.shape == j.tokens.shape
        assert tb.model_bytes(name) == jb.model_bytes(name)
        assert tb.model_bytes(name, 2, 100) == jb.model_bytes(name, 2, 100)
        _rel(tb.swap_cost(name), jb.swap_cost(name))
        tp = tb.profiles({name: [0.5, 0.6]})[name]
        jp = jb.profiles({name: [0.5, 0.6]})[name]
        _rel([tp.latency_s, tp.load_latency_s, tp.memory_bytes, *tp.latency_model],
             [jp.latency_s, jp.load_latency_s, jp.memory_bytes, *jp.latency_model])
        assert tp.provenance == jp.provenance == "costmodel"
    assert CostModelBackend({"m": "mamba2-130m"}).n_devices == 1


# ----------------------------------------------------------- sharded training


@pytest.fixture(scope="module")
def runs():
    """The reference Trainer's step-0 checkpoints, its 6 steps from them,
    the port's unsharded Trainer's 6 steps from copies, first-step
    gradients of both, then the sharded runs on 2 and 4 gloo ranks from
    copies (``tests/_torch_ranks.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = Path(tempfile.mkdtemp(prefix="torch-launch-"))
    out = {"root": root, "ref": {}, "port": {}, "sharded": {}}
    try:
        for arch in TRAIN_ARCHS:
            jcfg = J_ARCHS[arch].reduced()
            cfg = ModelConfig(**dataclasses.asdict(jcfg))
            jds = JLMDataset(JLMDataConfig(vocab_size=jcfg.vocab_size, **DATA))
            ds = LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, **DATA))
            base = root / arch / "ref"
            jtr = JTrainer(JLM(jcfg), jds, opt_cfg=JOptimizerConfig(**OPT),
                           cfg=JTrainerConfig(checkpoint_dir=str(base), **TRAINER))
            jparams0, jopt0 = jtr.init_state(0)
            jtr._save(0, jparams0, jopt0)
            for dims in SHARDED_MESHES:
                shutil.copytree(base, root / arch / f"sharded-{dims[0]}x{dims[1]}")
            shutil.copytree(base, root / arch / "port")
            batch = {k: jax.numpy.asarray(v) for k, v in jds.batch_at(1).items()}
            _, jgrads = jax.value_and_grad(JLM(jcfg).loss, has_aux=True)(jparams0, batch)
            _, jparams, _, jsum = jtr.train()
            out["ref"][arch] = {"params": jax.tree.map(np.asarray, jparams),
                                "grads": jax.tree.map(np.asarray, jgrads),
                                "losses": jsum["losses"]}
            params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams0),
                                                   device="cpu")
            params.requires_grad_(True)
            loss, _ = LM(cfg).loss(params, {k: torch.as_tensor(v)
                                            for k, v in ds.batch_at(1).items()})
            loss.backward()
            grads = params.grad_tree()
            tr = Trainer(LM(cfg), ds, opt_cfg=OptimizerConfig(**OPT),
                         cfg=TrainerConfig(checkpoint_dir=str(root / arch / "port"), **TRAINER),
                         device="cpu")
            _, tparams, _, tsum = tr.train()
            out["port"][arch] = {"params": tparams.to_tree(), "grads": grads,
                                 "losses": tsum["losses"]}
        cfg = ModelConfig(**dataclasses.asdict(J_ARCHS[STEP_FAULT_ARCH].reduced()))
        tr = Trainer(LM(cfg), LMDataset(LMDataConfig(vocab_size=cfg.vocab_size, **DATA)),
                     opt_cfg=OptimizerConfig(**OPT),
                     cfg=TrainerConfig(checkpoint_dir=str(root / "step-fault-port"),
                                       total_steps=STEP_FAULT_STEPS, checkpoint_every=1,
                                       log_every=1), device="cpu")
        _, tparams, _, tsum = tr.train()
        out["step_fault"] = {"params": tparams.to_tree(), "losses": tsum["losses"]}
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
        for dims in SHARDED_MESHES:
            key = f"{dims[0]}x{dims[1]}"
            job_out = root / f"out-{key}"
            job_out.mkdir()
            job = {"world": dims[0] * dims[1], "mesh": list(dims), "out": str(job_out),
                   "store": str(root / f"store-{key}"), "data": DATA, "opt": OPT,
                   "trainer": TRAINER,
                   "archs": {arch: str(root / arch / f"sharded-{key}") for arch in TRAIN_ARCHS},
                   "step_fault": {"arch": STEP_FAULT_ARCH, "steps": STEP_FAULT_STEPS,
                                  "dir": str(root / f"step-fault-{key}")}}
            (root / f"job-{key}.json").write_text(json.dumps(job))
            proc = subprocess.run([sys.executable, str(REPO / "tests" / "_torch_ranks.py"),
                                   str(root / f"job-{key}.json")], env=env,
                                  capture_output=True, text=True, timeout=600)
            out["sharded"][key] = {"proc": proc, "out": job_out}
        yield out
    finally:
        torch.set_num_threads(threads)
        shutil.rmtree(root, ignore_errors=True)


def _sharded(runs, dims):
    key = f"{dims[0]}x{dims[1]}"
    run = runs["sharded"][key]
    assert run["proc"].returncode == 0, run["proc"].stderr[-3000:]
    return key, run["out"], json.loads((run["out"] / "result.json").read_text())


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
@pytest.mark.parametrize("dims", SHARDED_MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_sharded_trainer_matches_unsharded_and_reference(runs, dims, arch):
    """ZeRO-3 on 2 or 4 gloo ranks: first-step gradients, the 6 losses and
    the final weights against the port's and the reference's unsharded
    Trainers resumed from the same reference checkpoint; a fault injected
    on every rank restores the last checkpoint and the run ends; two steps
    with int8 moments against the same steps unsharded."""
    key, out, result = _sharded(runs, dims)
    res = result[arch]
    world = dims[0] * dims[1]
    assert res["step"] == TRAINER["total_steps"] - 1 and res["restarts"] == 0
    assert res["blocks"] == world  # the batch rows fold over the whole mesh (fsdp)
    grads, _ = ckpt.restore(out / f"grads-{arch}", 0, device="cpu")
    _assert_close(grads, runs["port"][arch]["grads"], GRAD_ATOL, "grads vs port")
    _assert_close(grads, runs["ref"][arch]["grads"], GRAD_ATOL, "grads vs reference")
    for other in ("port", "ref"):
        np.testing.assert_allclose(res["losses"], runs[other][arch]["losses"], atol=STATE_ATOL,
                                   rtol=0, err_msg=other)
    assert res["int8_err"] <= STATE_ATOL  # int8 moments on their specs, two steps
    last = TRAINER["total_steps"] - 1
    assert res["fault"] == [{"step": last + 2, "restarts": 1, "fired": [last + 2]}] * world
    final = runs["root"] / arch / f"sharded-{key}"
    state, _ = ckpt.restore(final, TRAINER["total_steps"] - 1, device="cpu")
    _assert_close(state["params"], runs["port"][arch]["params"], STATE_ATOL, "weights vs port")
    _assert_close(state["params"], runs["ref"][arch]["params"], STATE_ATOL, "weights vs ref")


@pytest.mark.parametrize("dims", SHARDED_MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_fault_on_one_rank_restarts_every_rank(runs, dims):
    """A fault from ``fault_hook`` on rank 1 alone: every rank restores the
    last checkpoint at the same step and the run ends on all of them.  A
    failure inside rank 1's step, which its peers cannot be told of, ends
    every rank, and ``launch.train.run_ranks`` starts them again: they
    resume from the last checkpoint, and the weights and losses of the
    run from the seed equal the unsharded Trainer's."""
    key, out, result = _sharded(runs, dims)
    world = dims[0] * dims[1]
    first = TRAINER["total_steps"] - 1 + 2  # where the every-rank fault's run ended
    for arch in TRAIN_ARCHS:
        one = result[arch]["fault_one"]
        assert [r["step"] for r in one] == [first + 2] * world
        assert [r["restarts"] for r in one] == [1] * world
        assert [r["fired"] for r in one] == [[first + 2] if r == 1 else [] for r in range(world)]
    assert "starting the" in runs["sharded"][key]["proc"].stderr
    res = json.loads((out / "step-fault.json").read_text())
    assert res["fired"] and res["restarts"] == 0 and res["step"] == STEP_FAULT_STEPS - 1
    want = runs["step_fault"]
    np.testing.assert_allclose(res["losses"], want["losses"][2:], atol=STATE_ATOL, rtol=0)
    state, _ = ckpt.restore(runs["root"] / f"step-fault-{key}", STEP_FAULT_STEPS - 1,
                            device="cpu")
    _assert_close(state["params"], want["params"], STATE_ATOL, "weights vs unsharded")


@pytest.mark.parametrize("dims", SHARDED_MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_sharded_checkpoints_cross(runs, dims):
    """The reference's checkpoint restores onto the shardings, each rank
    holding exactly its cut of the full arrays (moments placed as their
    specs say), and the sharded run's final checkpoint, written whole by
    rank 0, restores unsharded in the port and in the reference, bit for
    bit equal."""
    key, _, result = _sharded(runs, dims)
    for arch in TRAIN_ARCHS:
        assert result[arch]["shard_err"] == 0.0 and result[arch]["placed"]
        final = runs["root"] / arch / f"sharded-{key}"
        step = TRAINER["total_steps"] - 1
        port, _ = ckpt.restore(final, step, device="cpu")
        ref, _ = j_ckpt.restore(str(final), step)
        _assert_close(port, jax.tree.map(np.asarray, ref), 0.0, "port vs reference restore")
        assert int(port["opt"]["step"]) == step


@pytest.mark.parametrize("dims", SHARDED_MESHES, ids=lambda d: f"{d[0]}x{d[1]}")
def test_compressed_psum_over_mesh_axes_matches_reference(runs, reference, dims):
    """Three rounds with error feedback over each mesh axis of size above
    one: every rank's mean and residual equal to the reference's under
    ``shard_map``."""
    key, out, _ = _sharded(runs, dims)
    world = dims[0] * dims[1]
    axes = [a for a, n in zip(("data", "model"), dims) if n > 1]
    assert axes
    for rank in range(world):
        got = np.load(out / f"compressed-{rank}.npz")
        for axis in axes:
            for i in range(3):
                for kind in ("out", "ef"):
                    want = np.asarray(reference["compressed"][f"{key}/{axis}/{kind}{i}"],
                                      np.float32)[rank * 16:(rank + 1) * 16]
                    np.testing.assert_allclose(got[f"{axis}/{kind}{i}"], want, atol=1e-6,
                                               rtol=0, err_msg=f"rank {rank} {axis} {kind}{i}")


# ----------------------------------------------------------- the launchers


def _run(args, timeout=420):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", *args], env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_train_launcher_cpu():
    with tempfile.TemporaryDirectory() as d:
        proc = _run(["repro_torch.launch.train", "--device", "cpu", "--arch", "mamba2-130m",
                     "--reduced", "--steps", "12", "--ckpt-dir", d])
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "devices=1" in proc.stdout and "done @ step 11" in proc.stdout
        assert any(p.name.startswith("step_") for p in Path(d).iterdir())
        summary = _summary(proc)
        assert len(summary["losses"]) == len(summary["step_s"]) == 12
        assert summary["peak_bytes"] is None and summary["tokens_per_s"] > 0


def _summary(proc) -> dict:
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("summary {")
    return json.loads(last.removeprefix("summary "))


def test_train_launcher_sharded_cpu():
    """The bar the reference's own sharded launcher misses (its embedding
    gather on the sharded table fails under JAX 0.9): 4 gloo ranks on a
    (2, 2) mesh, a sharded checkpoint written, no rendezvous file left,
    the losses within 1e-4 of the unsharded launcher's."""
    args = ["repro_torch.launch.train", "--device", "cpu", "--arch", "tinyllama-1.1b",
            "--reduced", "--steps", "6", "--batch", "8", "--seq", "32"]
    with tempfile.TemporaryDirectory() as d, tempfile.TemporaryDirectory() as d1:
        proc = _run(args + ["--devices", "4", "--mesh", "data,model=2,2", "--ckpt-dir", d])
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "devices=4" in proc.stdout and "done @ step 5" in proc.stdout
        assert proc.stdout.count("done @ step") == 1  # rank 0 prints
        assert sorted(p.name for p in Path(d).iterdir()) == [
            "LATEST", "step_00000000", "step_00000005"]
        one = _run(args + ["--ckpt-dir", d1])
        assert one.returncode == 0, one.stderr[-3000:]
        np.testing.assert_allclose(_summary(proc)["losses"], _summary(one)["losses"],
                                   atol=STATE_ATOL, rtol=0)


def test_train_launcher_refusals():
    """A mesh larger than the ranks raises; several ranks without a mesh
    and, on a host without CUDA, the default device are refused."""
    with tempfile.TemporaryDirectory() as d:
        proc = _run(["repro_torch.launch.train", "--device", "cpu", "--reduced", "--steps", "2",
                     "--mesh", "data,model=2,2", "--ckpt-dir", d])
        assert proc.returncode != 0 and "needs as many ranks" in proc.stderr
        proc = _run(["repro_torch.launch.train", "--device", "cpu", "--reduced", "--steps", "2",
                     "--devices", "2", "--ckpt-dir", d])
        assert proc.returncode != 0 and "needs --mesh" in proc.stderr
        if not torch.cuda.is_available():
            for args in (["repro_torch.launch.train", "--reduced", "--steps", "2",
                          "--ckpt-dir", d], ["repro_torch.launch.serve", "--requests", "2"]):
                proc = _run(args)
                assert proc.returncode != 0 and "CUDA" in proc.stderr


def test_serve_launcher_cpu(port_hw):
    """``mean utility`` and ``batch[`` lines, and profile lines equal to
    what the reference launcher prints at the port's constants and device
    count."""
    proc = _run(["repro_torch.launch.serve", "--device", "cpu", "--requests", "6",
                 "--new-tokens", "2", "--policy", "SneakPeek"])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "mean utility" in proc.stdout and "batch[" in proc.stdout
    assert proc.stdout.strip().splitlines()[-1].startswith("kernel launches {")
    results_dir = REPO / "results" / "dryrun"
    for name in ("mamba2-130m", "tinyllama-1.1b", "gemma-7b"):
        fixed, per_item = j_profiles.lm_latency_model(results_dir, name,
                                                      n_devices=t_profiles.N_DEVICES)
        load = 2 * J_ARCHS[name].param_count() / 25e9 / t_profiles.N_DEVICES
        line = (f"variant {name:16s} l(m)={fixed+per_item:8.4f}s load={load:7.3f}s "
                f"({'roofline' if results_dir.exists() else 'analytic'} profile)")
        assert line in proc.stdout.splitlines(), (line, proc.stdout[:600])


# ----------------------------------------------------------- the serving launcher's workload (P11)


class _Captured(Exception):
    pass


def _reference_workload(monkeypatch, policy: str, requests: int, windows: int, seed: int):
    """The reference launcher's ``Application`` and requests: its ``main``
    run with a server that records what it is given and an executor that
    builds nothing."""
    import repro.serving as j_serving
    from repro.launch import serve as j_serve
    from repro.serving.server import WindowQueue

    seen = {}

    class Server:
        def __init__(self, apps, policy, executor=None, prompt_fn=None, **kw):
            seen["app"] = apps["assistant"]
            self.queue = WindowQueue()

        def run(self, reqs, horizon_s):
            seen["requests"], seen["horizon"] = reqs, horizon_s
            raise _Captured

    monkeypatch.setattr(j_serving, "EdgeServer", Server)
    monkeypatch.setattr(j_serving, "LMExecutor", lambda *a, **k: None)
    with pytest.raises(_Captured):
        j_serve.main(["--policy", policy, "--requests", str(requests), "--windows",
                      str(windows), "--seed", str(seed)])
    return seen


@pytest.mark.parametrize("policy", ["LO-EDF", "MaxAcc-EDF", "SneakPeek"])
def test_serve_launcher_requests_match_reference(monkeypatch, policy):
    """Arrivals, deadlines and labels from the same seed equal the
    reference's under every policy; under SneakPeek the port's requests
    also carry features (a generator of their own), centred on their labels."""
    from repro_torch.launch import serve as t_serve
    from repro_torch.serving.server import WindowQueue as TWindowQueue

    for seed, n, windows in ((0, 12, 2), (7, 40, 3)):
        ref = _reference_workload(monkeypatch, policy, n, windows, seed)
        horizon = windows * TWindowQueue().window_s
        assert horizon == ref["horizon"]
        rng = np.random.default_rng(seed)
        feats = seed + 2 if policy == "SneakPeek" else None
        got = t_serve.build_requests(rng, n, horizon, 400.0, features_seed=feats)
        want = ref["requests"]
        assert [(r.rid, r.app, r.arrival_s, r.deadline_s, r.true_label) for r in got] == [
            (r.rid, r.app, r.arrival_s, r.deadline_s, r.true_label) for r in want]
        assert all(r.features is None for r in want)
        if feats is None:
            assert all(r.features is None for r in got)
        else:
            x = np.stack([r.features for r in got])
            labels = np.array([r.true_label for r in got])
            assert x.shape == (n, t_serve.FEATURE_DIM) and x.dtype == np.float32
            assert x[labels == 1].mean() > 0 > x[labels == 0].mean()


def test_serve_launcher_application_matches_reference(monkeypatch, port_hw):
    """Recalls, latency models and load latencies at the reference's 16
    devices equal the reference launcher's; the port's launcher itself
    stages its weights over one card."""
    from repro_torch.launch import serve as t_serve

    ref = _reference_workload(monkeypatch, "LO-EDF", 4, 1, 0)["app"]
    with tempfile.TemporaryDirectory() as d:
        app, variants = t_serve.build_application(d, n_devices=16)
        one, _ = t_serve.build_application(d)
    assert app.name == ref.name and app.penalty == ref.penalty
    assert [m.name for m in app.models] == [m.name for m in ref.models] == list(variants)
    for got, want, single in zip(app.models, ref.models, one.models):
        _rel(got.recalls, want.recalls)
        _rel(got.latency_model, want.latency_model)
        _rel([got.latency_s, got.load_latency_s], [want.latency_s, want.load_latency_s])
        _rel(single.load_latency_s, want.load_latency_s * 16 / t_profiles.N_DEVICES)
    for name, (cfg, seed) in variants.items():
        assert cfg == ARCHS[name].reduced() and 0 <= seed < 100
