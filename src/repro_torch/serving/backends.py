"""Executor backends: the execution interface and its profiled substrate.

The counterpart of ``repro.serving.backends``.  Everything the runtime
(``serving.runtime``) needs from "a thing that runs models" is the
``ExecutorBackend`` interface:

    run_batch(model, prompts, request_ids) -> ExecutionReport
    affine(model)                          -> (fixed_s, per_item_s)
    model_bytes(model)                     -> bytes
    swap_cost(model)                       -> cold-load seconds

``ProfiledBackend`` runs the port's ``LM`` (attention prefill through K3
and greedy decode through K4, SSD prefill through K5) on the card,
stopwatch-timed with the card synchronised before every clock read, so
``prefill_s`` and ``decode_s`` are the card's time and not the host's
enqueue time.  Sizes are weight
bytes at the declared dtype; swap cost is bytes over a 25 GB/s staging
rate, the reference's constants.  ``CompiledBackend``,
``SimulatedBackend`` and ``CostModelBackend`` are not ported yet
(ROADMAP "Modules to port", items 10 and 13).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import ModelProfile
from repro_torch.device import resolve_device
from repro_torch.models import LM

__all__ = ["ExecutionReport", "ExecutorBackend", "ProfiledBackend", "weight_bytes"]

_STAGING_BW = 25e9  # host->device weight staging bandwidth (B/s)


@dataclasses.dataclass
class ExecutionReport:
    """Realised execution of one scheduled batch (timing + outputs)."""

    request_ids: list
    model: str
    batch_size: int
    swap_s: float
    prefill_s: float
    decode_s: float
    tokens: np.ndarray  # (B, new_tokens) generated ids
    predictions: list  # per-request predicted class (argmax over option logits)
    worker: int = -1  # lane that executed the batch (-1: single-executor path)

    @property
    def total_s(self) -> float:
        """Swap + prefill + decode seconds for the batch."""
        return self.swap_s + self.prefill_s + self.decode_s


def weight_bytes(cfg) -> int:
    """Parameter bytes for a config at its declared dtype."""
    per = 2 if cfg.dtype == "bfloat16" else 4
    return per * cfg.param_count()


def _affine_fit(obs: Sequence[tuple[int, float]]) -> tuple[float, float]:
    """(fixed_s, per_item_s) least-squares fit of (batch, seconds) points.

    One distinct batch size yields a flat model at the mean; negative
    slopes or intercepts (measurement noise) are clamped so the affine
    model stays physical.
    """
    if not obs:
        return 0.0, 0.0
    by_b: dict[int, list[float]] = {}
    for b, t in obs:
        by_b.setdefault(int(b), []).append(float(t))
    bs = sorted(by_b)
    ts = [sum(by_b[b]) / len(by_b[b]) for b in bs]
    if len(bs) < 2:
        return ts[0], 0.0
    slope, intercept = np.polyfit(np.asarray(bs, float), np.asarray(ts, float), 1)
    per_item = max(float(slope), 0.0)
    fixed = max(float(intercept), 0.0)
    if fixed == 0.0 and per_item == 0.0:
        fixed = float(np.mean(ts))
    return fixed, per_item


class ExecutorBackend:
    """Interface every execution substrate implements.

    ``variants`` maps model name -> (ModelConfig, seed); ``provenance``
    labels the latency estimates this backend produces and is stamped
    onto the ``ModelProfile``s it mints.
    """

    provenance: str = "profiled"

    def __init__(self, variants: Mapping[str, tuple], new_tokens: int = 4):
        self.variants = dict(variants)
        self.new_tokens = new_tokens
        self._obs: dict[str, list[tuple[int, float]]] = {}

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """Execute one padded (B, S) prompt batch; ``swap_s`` is left at
        0.0 — residency and swap accounting belong to the caller's
        ``SwapManager``."""
        raise NotImplementedError

    def _record(self, model_name: str, batch: int, seconds: float) -> None:
        self._obs.setdefault(model_name, []).append((int(batch), float(seconds)))

    def affine(self, model_name: str) -> tuple[float, float]:
        """(fixed_s, per_item_s) latency model for one variant."""
        return _affine_fit(self._obs.get(model_name, []))

    def model_bytes(self, model_name: str) -> int:
        """Device bytes a resident variant occupies (its weights)."""
        cfg, _ = self.variants[model_name]
        return weight_bytes(cfg)

    def swap_cost(self, model_name: str) -> float:
        """Seconds to stage a cold variant's weights onto the device."""
        return self.model_bytes(model_name) / _STAGING_BW

    def profile(self, model_name: str, recalls, name: str | None = None,
                latency_floor_s: float = 0.0) -> ModelProfile:
        """A scheduler-facing ``ModelProfile`` from this backend's own
        latency, memory and swap estimates, stamped with its provenance."""
        fixed, per_item = self.affine(model_name)
        lat = max(fixed + per_item, latency_floor_s)
        return ModelProfile(
            name=name or model_name,
            recalls=np.asarray(recalls, dtype=np.float64),
            latency_s=lat,
            load_latency_s=self.swap_cost(model_name),
            memory_bytes=self.model_bytes(model_name),
            latency_model=(max(fixed, lat - per_item), per_item),
            provenance=self.provenance,
        )


class ProfiledBackend(ExecutorBackend):
    """The reference's default substrate on the port's ``LM``: weights
    made lazily per variant (``LM.init(seed)`` on ``device``, the card
    unless ``"cpu"`` is named), prefill with ``max_len = prompt +
    new_tokens``, greedy decode, stopwatch timing."""

    provenance = "profiled"

    def __init__(self, variants: Mapping[str, tuple], new_tokens: int = 4, device=None):
        super().__init__(variants, new_tokens)
        self.device = resolve_device(device)
        self._models: dict[str, LM] = {}
        self._params: dict = {}

    def set_params(self, name: str, params) -> None:
        """Serve variant ``name`` with these weights (a ``TransformerParams``
        on this backend's device, e.g. from ``convert.lm_params_from_arrays``)
        instead of ``LM.init(seed)``'s."""
        cfg, _ = self.variants[name]
        self._models[name] = LM(cfg)
        self._params[name] = params

    def _get(self, name: str):
        if name not in self._models:
            cfg, seed = self.variants[name]
            model = LM(cfg)
            self._params[name] = model.init(seed, device=self.device)
            self._models[name] = model
        return self._models[name], self._params[name]

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """prompts: (B, S) int32 (pre-padded)."""
        model, params = self._get(model_name)
        with torch.inference_mode():
            t0 = self._clock()
            tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
            logits, cache = model.prefill(params, tokens,
                                          max_len=tokens.shape[1] + self.new_tokens)
            t1 = self._clock()
            preds = None
            if class_token_ids is not None:
                ids = torch.as_tensor(np.asarray(class_token_ids), device=self.device)
                preds = logits[:, ids].argmax(dim=-1).tolist()
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks = [tok]
            for _ in range(self.new_tokens - 1):
                logits, cache = model.decode_step(params, cache, tok[:, None])
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
                toks.append(tok)
            t2 = self._clock()
        self._record(model_name, prompts.shape[0], t2 - t0)
        return ExecutionReport(
            request_ids=request_ids,
            model=model_name,
            batch_size=prompts.shape[0],
            swap_s=0.0,
            prefill_s=t1 - t0,
            decode_s=t2 - t1,
            tokens=torch.stack(toks, dim=1).cpu().numpy(),
            predictions=preds if preds is not None else [None] * prompts.shape[0],
        )
