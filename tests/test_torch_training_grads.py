"""``LM.loss`` and its gradients in the port against
``jax.value_and_grad(model.loss)`` of the JAX package, on the CPU.

Identical weights (the reference's ``LM.init`` through
``convert.lm_params_from_arrays``) and tokens made with numpy; float32.
The port's gradients run through its autograd functions (K3's and K5's
plain forward and backward here), ``torch.utils.checkpoint`` with remat,
and the MoE's auxiliary term; reduced mamba2-130m (one, two and four SSD
groups), tinyllama-1.1b,
gemma3-4b (one period: five windowed layers and a global one),
llama4-scout (the routed MoE), recurrentgemma-9b (the RG-LRU scan's
autograd function) and gemma-7b.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import LM as JLM
from repro_torch import convert
from repro_torch.configs import ModelConfig
from repro_torch.models import LM

# Float32 sums taken in other orders through a few layers.
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4



@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tensors here are small: one intra-op thread each, so that the
    suite's parallel workers do not oversubscribe the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree) for k2, v2 in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree, dtype=np.float64)}


# ---------------------------------------------------------------- LM.loss gradients


GRAD_MODELS = {
    "mamba2": ("mamba2-130m", {}, 2, 24),
    "mamba2-remat": ("mamba2-130m", {"remat": True}, 2, 24),
    # B and C of 2 and 4 groups, each shared by its heads: K5b's plain
    # version sums d(scores), dB and dC over a group's heads
    "mamba2-g2": ("mamba2-130m", {"ssd_ngroups": 2}, 2, 24),
    "mamba2-g4": ("mamba2-130m", {"ssd_ngroups": 4}, 2, 24),
    "tinyllama": ("tinyllama-1.1b", {}, 2, 20),
    "tinyllama-remat": ("tinyllama-1.1b", {"remat": True, "xent_chunk": 7}, 2, 20),
    "gemma3": ("gemma3-4b", {"num_layers": 6}, 1, 40),  # one period: 5 windowed (16 keys), 1 global
    "llama4-scout": ("llama4-scout-17b-16e", {}, 2, 16),  # routed MoE: the aux loss
    # two periods (rglru, rglru, local: 16 keys) and a tail rglru: the scan's
    # autograd function (its saving forward and plain backward)
    "recurrentgemma": ("recurrentgemma-9b", {}, 2, 20),
    "gemma-7b": ("gemma-7b", {}, 2, 20),  # MHA, GeGLU, tied readout
}


@pytest.mark.parametrize("name", sorted(GRAD_MODELS))
def test_lm_loss_and_gradients_match_reference(name):
    """``LM.loss`` and the gradient of every weight against
    ``jax.value_and_grad(model.loss)`` on identical weights and tokens
    (atol 1e-5 + rtol 1e-4); with remat, each layer and each cross-entropy
    chunk recomputed in the backward, the same numbers."""
    arch, overrides, batch, seq = GRAD_MODELS[name]
    jcfg = dataclasses.replace(J_ARCHS[arch].reduced(), **overrides)
    jlm = JLM(jcfg)
    jparams = jlm.init(seed=5)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(batch, seq + 1),
                                               dtype=np.int32)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jparams, {"tokens": jnp.asarray(tokens)})
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = convert.lm_params_from_arrays(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    params.requires_grad_(True)
    loss, metrics = LM(cfg).loss(params, {"tokens": torch.as_tensor(tokens)})
    loss.backward()
    loss = loss.item()
    assert abs(loss - float(jloss)) <= GRAD_ATOL + GRAD_RTOL * abs(float(jloss))
    for key in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=key)
    if arch.startswith("llama4"):
        assert float(metrics["aux_loss"]) > 0.0
    got, want = _flat(convert.grads_to_arrays(params)), _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)
