"""State carried between the JAX package and the port, as plain arrays.

The scheduler's "weights" are the application tables (per-class
recalls, latencies, sizes, priors) and the SneakPeek training sets; the
served language models' are their parameter trees, and a trained one's
also its optimizer state and gradients, in the reference's stacked
layout.  The ``*_to_arrays``
functions read them from any object with the reference's attributes or
layout — a ``repro`` object or a ``repro_torch`` one — into numpy
arrays; the ``*_from_arrays`` functions build the port's objects from
them, so both sides compute on identical state.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.dirichlet import DirichletPrior
from repro_torch.core.sneakpeek import KNNSneakPeek
from repro_torch.core.types import Application
from repro_torch.device import resolve_device
from repro_torch.models.kvcache import model_dtype
from repro_torch.models.transformer import TransformerParams

__all__ = [
    "application_to_arrays",
    "application_from_arrays",
    "knn_sneakpeek_to_arrays",
    "knn_sneakpeek_from_arrays",
    "lm_params_to_arrays",
    "lm_params_from_arrays",
    "opt_state_to_arrays",
    "opt_state_from_arrays",
    "grads_to_arrays",
]


def application_to_arrays(app) -> dict:
    """The plain-array form of an application (``application_from_arrays``'
    keyword arguments)."""
    models = app.models
    for m in models:
        if m.latency_model is not None or m.is_short_circuit:
            raise ValueError(
                f"variant {m.name!r}: only plain profiled variants convert"
            )
    return {
        "name": app.name,
        "recalls": np.stack([np.asarray(m.recalls, dtype=np.float64) for m in models]),
        "latency_s": np.array([m.latency_s for m in models], dtype=np.float64),
        "load_latency_s": np.array([m.load_latency_s for m in models], dtype=np.float64),
        "memory_bytes": np.array([m.memory_bytes for m in models], dtype=np.int64),
        "penalty": app.penalty,
        "prior_alpha": np.asarray(app.prior.alpha, dtype=np.float64),
        "expected_freqs": (
            None if app.expected_freqs is None
            else np.asarray(app.expected_freqs, dtype=np.float64)
        ),
        "model_names": [m.name for m in models],
    }


def application_from_arrays(
    name: str,
    recalls: np.ndarray,
    latency_s: np.ndarray,
    load_latency_s: np.ndarray,
    memory_bytes: np.ndarray,
    penalty: str,
    prior_alpha: np.ndarray,
    expected_freqs: np.ndarray | None,
    model_names: Sequence[str],
) -> Application:
    """An ``Application`` of the port from its plain arrays: ``recalls``
    (M, C), the per-variant vectors (M,), the prior's concentration (C,)."""
    recalls = np.asarray(recalls, dtype=np.float64)
    m = len(model_names)
    if recalls.ndim != 2 or recalls.shape[0] != m:
        raise ValueError(f"recalls must be ({m}, C), got {recalls.shape}")
    models = [
        ModelProfile(
            name=model_names[i],
            recalls=recalls[i],
            latency_s=float(latency_s[i]),
            load_latency_s=float(load_latency_s[i]),
            memory_bytes=int(memory_bytes[i]),
        )
        for i in range(m)
    ]
    return Application(
        name=name,
        models=models,
        penalty=penalty,
        prior=DirichletPrior(np.asarray(prior_alpha, dtype=np.float64)),
        expected_freqs=expected_freqs,
    )


def knn_sneakpeek_to_arrays(sp) -> dict:
    """The training and holdout split of a k-NN SneakPeek model as arrays
    (``knn_sneakpeek_from_arrays``' keyword arguments, without ``device``)."""
    return {
        "train_x": np.asarray(sp.train_x, dtype=np.float32),
        "train_y": np.asarray(sp.train_y, dtype=np.int32),
        "hold_x": np.asarray(sp._hold_x, dtype=np.float32),
        "hold_y": np.asarray(sp._hold_y, dtype=np.int32),
        "num_classes": int(sp.num_classes),
        "k": int(sp.k),
    }


def knn_sneakpeek_from_arrays(train_x, train_y, hold_x, hold_y, num_classes: int,
                              k: int, device=None, name: str = "knn") -> KNNSneakPeek:
    """A port ``KNNSneakPeek`` over exactly this split, its training set on
    ``device`` (the card unless ``"cpu"`` is named)."""
    return KNNSneakPeek.from_split(train_x, train_y, hold_x, hold_y, num_classes,
                                   k=k, name=name, device=device)


def _tree_map(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(v, fn) for v in tree]
    return fn(tree)


def lm_params_from_arrays(cfg, tree, device=None) -> TransformerParams:
    """The port's weights from the reference's parameter tree.

    ``tree`` is ``repro``'s ``LM.init`` layout with numpy (or any
    array-like) leaves: ``{"embed", "blocks": [one stack per pattern
    position, layers on axis 0], "tail", "final_norm", "lm_head"}``, each
    block's subtrees under the reference's names (``attn``, ``ssd``,
    ``rec`` for RG-LRU, ``mlp``, ``moe`` with its router, expert stacks
    and ``shared`` MLP).  The
    leading layer axis is unstacked into one module per layer; leaves are
    cast to the config's dtype and placed on ``device`` (the card unless
    ``"cpu"`` is named)."""
    dev = resolve_device(device)
    dtype = model_dtype(cfg)

    def leaf(a):  # through float32, which holds a bfloat16 leaf exactly
        return torch.as_tensor(np.array(a, dtype=np.float32)).to(device=dev, dtype=dtype)

    return TransformerParams(cfg, _tree_map(tree, leaf))


def lm_params_to_arrays(params: TransformerParams) -> dict:
    """The reference's parameter tree of the port's weights, as float32
    numpy arrays (the inverse of ``lm_params_from_arrays``)."""
    return _tree_map(params.to_tree(), lambda t: t.detach().float().cpu().numpy())


def _leaf_array(t) -> np.ndarray:
    """A tensor or array as numpy: floating leaves as float32 (which holds
    a bfloat16 one exactly), integer leaves in their own type."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return t.float().numpy() if t.is_floating_point() else t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def opt_state_to_arrays(opt_state) -> dict:
    """An optimizer state of either package (``step``, ``master`` or None,
    ``m``, ``v``, int8 moments as {"q", "scale"}) as numpy arrays in the
    reference's layout."""
    return {k: None if v is None else _tree_map(v, _leaf_array) for k, v in opt_state.items()}


def opt_state_from_arrays(tree, device=None) -> dict:
    """The port's optimizer state from arrays in the reference's layout:
    float leaves float32 and int8 codes on ``device`` (the card unless
    ``"cpu"`` is named), the step count a 0-dim int32 tensor on the host."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.array(a)
        if a.dtype.kind == "f" or a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(a).to(dev)

    out = {k: None if v is None else _tree_map(v, leaf) for k, v in tree.items()
           if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32)
    return out


def grads_to_arrays(params: TransformerParams) -> dict:
    """The gradients a backward left on the port's weights, in the
    reference's stacked layout, as float32 numpy arrays (zeros for a weight
    the loss did not reach)."""
    return _tree_map(params.grad_tree(), lambda t: t.detach().float().cpu().numpy())
