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
enqueue time.  Prefill runs eagerly; decode runs as a CUDA graph of
``transformer.decode_into`` per (variant, batch size, cache capacity)
(``DecodeGraph``), the counterpart of the reference's ``jax.jit`` of
the decode step, with the capacity rounded up to a multiple of 256 as
the reference's ``_bucket_seq`` rounds, so ragged batches share a graph.
The graphs of one (variant, capacity) run one at a time, so they share
one cache, made at the largest batch size the variant has decoded: each
batch size's graph decodes on the leading rows of it.  A model without
attention gives each batch size a cache of its own.
Sizes are weight
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

from repro_torch import kernels
from repro_torch.core.accuracy import ModelProfile
from repro_torch.device import resolve_device
from repro_torch.models import LM, kvcache, transformer

__all__ = ["ExecutionReport", "ExecutorBackend", "ProfiledBackend", "DecodeGraph",
           "weight_bytes", "bucket_capacity", "CAPACITY_MULTIPLE"]

_STAGING_BW = 25e9  # host->device weight staging bandwidth (B/s)
# Decode caches are sized to a multiple of this many positions, so batches
# of nearby prompt lengths share one decode graph; K4 reads only the valid
# lengths, so a larger capacity changes no result.
CAPACITY_MULTIPLE = 256


def bucket_capacity(positions: int) -> int:
    """``positions`` rounded up to a multiple of ``CAPACITY_MULTIPLE`` (at
    least one multiple), as the reference's ``_bucket_seq`` rounds."""
    return max(-(-positions // CAPACITY_MULTIPLE) * CAPACITY_MULTIPLE, CAPACITY_MULTIPLE)


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

    def clear_observations(self) -> None:
        """Forget the timed batches, e.g. warm-up batches that paid one-time
        costs (library loads, graph captures), before fitting profiles."""
        self._obs.clear()

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


class DecodeGraph:
    """Greedy decode on static buffers for one (variant, batch size, cache
    capacity): the cache, its position, the (B, 1) int32 token buffer and
    the (B, V) logits buffer, each allocated once and written in place by
    ``transformer.decode_into``.  The cache's layers may be given (views
    of a larger batch's, which the owner shares between graphs that never
    run at the same time); otherwise they are made here.

    On the card the first step runs eagerly on a side stream (a real step,
    and the warm-up a capture needs: libraries loaded, kernels built, the
    rope table cached); the next is captured into a ``torch.cuda.CUDAGraph``
    on that stream, from ``pool``, and is then replayed, as is every step
    of later batches with the same key.  A capture launches nothing, so
    the launches its wrappers counted are taken back off the counts and
    added again at each replay (``kernels.add_launches``).  On the CPU
    every step runs ``decode_into`` eagerly."""

    def __init__(self, params, cfg, batch: int, capacity: int, device, pool=None,
                 stream=None, layers=None):
        self.params, self.cfg, self.device = params, cfg, device
        self.pool, self.stream = pool, stream
        if layers is None:
            self.cache = kvcache.init_cache(cfg, batch, capacity, device=device)
        else:
            self.cache = {"layers": layers, "pos": kvcache.position(0, device)}
        self.tok = torch.zeros((batch, 1), dtype=torch.int32, device=device)
        self.logits = torch.zeros((batch, cfg.vocab_size), dtype=kvcache.model_dtype(cfg),
                                  device=device)
        self.graph = None
        self.warm = False
        self.launches: dict[str, int] = {}  # kernel launches of one replay
        self.captures = self.replays = 0
        self.capture_s = 0.0

    def load(self, cache, tok) -> None:
        """Copy a prefill's cache and position, and the first (B, 1) token,
        into the static buffers."""
        for dst, src in zip(self.cache["layers"], cache["layers"]):
            for name, t in dst.items():
                t.copy_(src[name])
        self.cache["pos"].copy_(cache["pos"])
        self.tok.copy_(tok)

    def _decode(self) -> None:
        transformer.decode_into(self.params, self.cache, self.tok, self.logits, self.cfg)

    def step(self) -> None:
        """One decode step: ``tok`` then holds the new token, ``logits``
        its logits."""
        if self.graph is not None:
            self.graph.replay()
            kernels.add_launches(self.launches)
            self.replays += 1
        elif self.device.type != "cuda":
            self._decode()
        elif not self.warm:
            self._on_side_stream(self._decode)
            self.warm = True
        else:
            self._capture()
            self.step()

    def _on_side_stream(self, fn) -> None:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(self.pool)
            try:
                self._decode()
            finally:
                graph.capture_end()

        self._on_side_stream(capture)
        after = kernels.launch_counts()
        self.launches = {name: n - before.get(name, 0) for name, n in after.items()
                         if n != before.get(name, 0)}
        kernels.add_launches({name: -n for name, n in self.launches.items()})
        self.graph = graph
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


def _has_attention(cfg) -> bool:
    """Whether a config's caches grow with the capacity: any global or
    sliding-window attention layer (a ring holds min(window, capacity))."""
    return any(cfg.layer_kind(i).partition(":")[0] in ("attn", "local")
               for i in range(cfg.num_layers))


class ProfiledBackend(ExecutorBackend):
    """The reference's default substrate on the port's ``LM``: weights
    made lazily per variant (``LM.init(seed)`` on ``device``, the card
    unless ``"cpu"`` is named), prefill with room for ``prompt +
    new_tokens`` positions rounded up to a multiple of 256, greedy decode
    through one ``DecodeGraph`` per (variant, batch size, capacity) — per
    (variant, batch size) for a model without attention, whose caches do
    not grow and are each its own — and stopwatch timing.  The graphs of
    one (variant, capacity) share one cache, made at the largest batch
    size the variant has decoded at any capacity; a larger batch makes a
    larger cache and retires the graphs of the old one, which are
    captured again on their next batch.  On the card decode
    replays CUDA graphs (a key's first batch runs one eager step and
    captures the next, inside its ``decode_s``, as the reference's first
    call compiles inside its stopwatch); on the CPU it runs eagerly."""

    provenance = "profiled"

    def __init__(self, variants: Mapping[str, tuple], new_tokens: int = 4, device=None):
        super().__init__(variants, new_tokens)
        self.device = resolve_device(device)
        self._models: dict[str, LM] = {}
        self._params: dict = {}
        self._decoders: dict[tuple, DecodeGraph] = {}
        # (variant, capacity) -> (rows, the layers of the cache its graphs
        # share, their graph pool on the card)
        self._caches: dict[tuple, tuple] = {}
        self._rows: dict[str, int] = {}  # the largest batch each variant decoded
        self._retired = {"captures": 0, "replays": 0, "capture_s": 0.0}
        self._stream = None  # the capture stream, on the card

    def set_params(self, name: str, params) -> None:
        """Serve variant ``name`` with these weights (a ``TransformerParams``
        on this backend's device, e.g. from ``convert.lm_params_from_arrays``)
        instead of ``LM.init(seed)``'s."""
        cfg, _ = self.variants[name]
        self._models[name] = LM(cfg)
        self._params[name] = params
        self._retire(lambda key: key[0] == name)
        self._caches = {k: c for k, c in self._caches.items() if k[0] != name}

    def _retire(self, drop) -> None:
        """Forget the decode graphs whose key satisfies ``drop``, keeping
        their counts for ``graph_stats``."""
        for key in [k for k in self._decoders if drop(k)]:
            dec = self._decoders.pop(key)
            for stat in self._retired:
                self._retired[stat] += getattr(dec, stat)

    def _get(self, name: str):
        if name not in self._models:
            cfg, seed = self.variants[name]
            model = LM(cfg)
            self._params[name] = model.init(seed, device=self.device)
            self._models[name] = model
        return self._models[name], self._params[name]

    def decoder(self, name: str, batch: int, capacity: int) -> DecodeGraph:
        """The decode buffers (and, once captured, the graph) of variant
        ``name`` at this batch size and capacity, made on first use."""
        model, params = self._get(name)
        cap = capacity if _has_attention(model.cfg) else None
        key = (name, batch, cap)
        dec = self._decoders.get(key)
        if dec is None:
            if self.device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            layers = pool = None
            if cap is not None:
                shared, pool = self._shared_cache(name, model.cfg, batch, capacity)
                layers = [{n: t[:batch] for n, t in layer.items()} for layer in shared]
            dec = DecodeGraph(params, model.cfg, batch, capacity, self.device, pool,
                              self._stream, layers=layers)
            self._decoders[key] = dec
        return dec

    def _shared_cache(self, name: str, cfg, batch: int, capacity: int):
        """(the layers of the cache the graphs of (``name``, ``capacity``)
        share, their graph pool), made at the largest batch size ``name``
        has decoded, or made anew when they hold fewer than ``batch`` rows.
        So a capacity first met at a small batch does not retire its graphs
        when a batch as large as an earlier one comes.  A new cache takes a
        new pool: the retired graphs were the old pool's only users, and a
        pool is released with them."""
        self._rows[name] = max(batch, self._rows.get(name, 0))
        rows, layers, pool = self._caches.get((name, capacity), (0, None, None))
        if rows < batch:
            self._retire(lambda key: (key[0], key[2]) == (name, capacity))
            self._caches.pop((name, capacity), None)
            layers = None  # the old cache goes before the new one is made
            rows = self._rows[name]
            layers = kvcache.init_cache(cfg, rows, capacity, device=self.device)["layers"]
            pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
            self._caches[(name, capacity)] = (rows, layers, pool)
        return layers, pool

    def graph_stats(self) -> dict:
        """Decode graphs held, and captures, replays and seconds spent
        capturing, summed over this backend's keys (retired graphs
        included)."""
        decs = self._decoders.values()
        out = {"graphs": sum(d.graph is not None for d in decs)}
        for stat, retired in self._retired.items():
            out[stat] = retired + sum(getattr(d, stat) for d in decs)
        return out

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """prompts: (B, S) int32 (pre-padded)."""
        model, params = self._get(model_name)
        b, s = prompts.shape
        capacity = bucket_capacity(s + self.new_tokens)
        with torch.inference_mode():
            t0 = self._clock()
            tokens = torch.as_tensor(np.asarray(prompts), device=self.device)
            logits, cache = model.prefill(params, tokens, max_len=capacity)
            t1 = self._clock()
            preds = None
            if class_token_ids is not None:
                ids = torch.as_tensor(np.asarray(class_token_ids), device=self.device)
                preds = logits[:, ids].argmax(dim=-1).tolist()
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks = [tok]
            if self.new_tokens > 1:
                dec = self.decoder(model_name, b, capacity)
                dec.load(cache, tok[:, None])
                del cache
                for _ in range(self.new_tokens - 1):
                    dec.step()
                    toks.append(dec.tok[:, 0].clone())
            t2 = self._clock()
        self._record(model_name, b, t2 - t0)
        return ExecutionReport(
            request_ids=request_ids,
            model=model_name,
            batch_size=b,
            swap_s=0.0,
            prefill_s=t1 - t0,
            decode_s=t2 - t1,
            tokens=torch.stack(toks, dim=1).cpu().numpy(),
            predictions=preds if preds is not None else [None] * b,
        )
