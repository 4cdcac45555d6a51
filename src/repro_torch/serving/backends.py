"""Executor backends: the execution interface and its substrates.

The counterpart of ``repro.serving.backends``.  Everything the runtime
(``serving.runtime``) needs from "a thing that runs models" is the
``ExecutorBackend`` interface:

    run_batch(model, prompts, request_ids) -> ExecutionReport
    affine(model)                          -> (fixed_s, per_item_s)
    model_bytes(model, batch, max_len)     -> bytes
    swap_cost(model)                       -> cold-load seconds
    spawn()                                -> the backend of a new lane

``ProfiledBackend`` runs the port's ``LM`` (attention prefill through K3
and greedy decode through K4, SSD prefill through K5, the RG-LRU
recurrence through ``rglru_scan``) on the card,
stopwatch-timed with its own stream synchronised before every clock
read, so ``prefill_s`` and ``decode_s`` are the card's time for this
backend's work and not the host's enqueue time, nor another lane's
queued work.  Each backend instance runs on a stream of its own, and a
pool gives each lane its own instance (``spawn``), so lanes run
concurrently on one card.  Prefill runs eagerly; decode runs as a CUDA
graph of ``transformer.decode_into`` per (variant, batch size, cache
capacity) (``DecodeGraph``), the counterpart of the reference's
``jax.jit`` of the decode step, with the capacity rounded up to a
multiple of 256 as the reference's ``_bucket_seq`` rounds, so ragged
batches share a graph.  The graphs of one (variant, capacity) run one at
a time, so they share one cache, made at the largest batch size the
variant has decoded: each batch size's graph decodes on the leading rows
of it, recurrent states (an RG-LRU layer's ``conv`` and ``h``) included.
A model without attention gives each batch size a cache of its own.
Sizes are weight bytes at the declared dtype; swap cost is bytes over a
25 GB/s staging rate, the reference's constants.

``CompiledBackend`` buckets shapes (batch to a power of two, sequence to
a multiple), fuses a window's same-model batches (``run_batches``) and
fits its latency model from its own warm runs (provenance
``"realized"``).  ``SimulatedBackend`` runs no model: its reports are
the profiles' modelled seconds.  ``CostModelBackend`` runs no model
either: its reports are ``serving.profiles``' roofline census.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.accuracy import ModelProfile
from repro_torch.device import resolve_device
from repro_torch.models import LM, kvcache, transformer

__all__ = ["ExecutionReport", "ExecutorBackend", "ProfiledBackend", "CompiledBackend",
           "SimulatedBackend", "CostModelBackend", "DecodeGraph", "weight_bytes",
           "bucket_capacity", "CAPACITY_MULTIPLE"]

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


def moe_group_len(cfg, b: int, s: int) -> int:
    """The least length >= ``s`` at which a (``b``, length) batch of a
    model with routed MoE layers splits into whole token groups of
    ``cfg.moe_group``; ``s`` for any other model, or a batch of one group
    at most.  The routed layers group a batch's B·S tokens and refuse a
    remainder, as the reference's do; the backends right-pad such a
    batch with more zero tokens, which take capacity in token order as a
    padded prompt row's zeros do (ROADMAP §3, P8)."""
    group = cfg.moe_group
    if not any(p.partition(":")[2] == "moe" for p in cfg.pattern) or b * s <= group:
        return s
    step = group // math.gcd(b, group)
    return -(-s // step) * step


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

    def latency_model(self, model_name: str, batch: int = 1) -> float:
        """Estimated seconds to execute a batch of ``batch`` requests."""
        fixed, per_item = self.affine(model_name)
        return fixed + per_item * batch

    def model_bytes(self, model_name: str, batch: int | None = None,
                    max_len: int | None = None) -> int:
        """Device bytes a resident variant occupies (weights only here;
        a backend that models the KV cache adds it)."""
        cfg, _ = self.variants[model_name]
        return weight_bytes(cfg)

    def swap_cost(self, model_name: str) -> float:
        """Seconds to stage a cold variant's weights onto the device."""
        return self.model_bytes(model_name) / _STAGING_BW

    def spawn(self) -> "ExecutorBackend":
        """The backend of a new lane: a same-config instance with its own
        residency, caches and observations, as a real per-worker device
        would have."""
        return type(self)(self.variants, new_tokens=self.new_tokens)

    def close(self) -> None:
        """Release what the substrate holds (nothing here; a process
        lane's proxy stops its worker process)."""

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
    added again at each replay (``kernels.add_launches``); they are read
    from the capturing thread's own tally, so a concurrent lane's launches
    are never taken for the graph's.  The capture runs in CUDA's
    thread-local capture mode: other lanes may launch and allocate on
    their own streams while it runs.  On the CPU every step runs
    ``decode_into`` eagerly."""

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
        before = kernels.thread_launch_counts()
        graph = torch.cuda.CUDAGraph()

        def capture():
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                self._decode()
            finally:
                graph.capture_end()

        self._on_side_stream(capture)
        after = kernels.thread_launch_counts()
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


class _Weights:
    """The weights of a backend's variants, shared by the backends spawned
    from it: the lanes of one process read one copy on the card.  Built
    once per variant under a lock, and complete on the card before any
    lane reads them.  ``carried`` names the variants whose weights were
    set (``set_params``) rather than drawn from their seed."""

    def __init__(self):
        self.lock = threading.Lock()
        self.models: dict[str, LM] = {}
        self.params: dict = {}
        self.carried: set[str] = set()

    def portable(self) -> dict:
        """The carried weights as numpy trees, to cross into another
        process; the others are drawn there again from their seeds."""
        from repro_torch.convert import lm_params_to_arrays

        with self.lock:
            return {name: lm_params_to_arrays(self.params[name]) for name in self.carried}


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
    call compiles inside its stopwatch); on the CPU it runs eagerly.

    On the card every batch runs on this instance's own stream, and the
    clock synchronises that stream only.  ``spawn`` gives a new lane an
    instance with its own stream, graphs and caches that reads this one's
    weights (the reference's lanes each draw the same seeds again; the
    values are the same).  A fresh instance pickles for a process lane:
    weights set through ``set_params`` cross as numpy arrays and are
    placed on the device in the child, the others are drawn there from
    their seeds; an instance that has run batches refuses to pickle."""

    provenance = "profiled"
    # Whether the graphs of one (variant, capacity) share one cache.
    share_caches = True

    def __init__(self, variants: Mapping[str, tuple], new_tokens: int = 4, device=None):
        super().__init__(variants, new_tokens)
        self.device = resolve_device(device)
        self._weights = _Weights()
        self._decoders: dict[tuple, DecodeGraph] = {}
        # (variant, capacity) -> (rows, the layers of the cache its graphs
        # share, their graph pool on the card)
        self._caches: dict[tuple, tuple] = {}
        self._rows: dict[str, int] = {}  # the largest batch each variant decoded
        self._retired = {"captures": 0, "replays": 0, "capture_s": 0.0}
        self._stream = None  # the capture stream, on the card
        self._lane_stream = None  # the stream every batch runs on, on the card

    def spawn(self) -> "ProfiledBackend":
        """The backend of a new lane: its own stream, graphs, caches and
        observations, over this backend's weights."""
        twin = ProfiledBackend(self.variants, new_tokens=self.new_tokens, device=self.device)
        twin._weights = self._weights
        return twin

    def __getstate__(self):
        if self._decoders or self._caches or self._lane_stream is not None:
            raise TypeError(
                f"{type(self).__name__} has run batches on {self.device}: a process lane "
                "takes a fresh backend (spawn()), which holds no tensor of its own")
        state = dict(self.__dict__)
        state["_weights"] = self._weights.portable()
        return state

    def __setstate__(self, state):
        carried = state.pop("_weights")
        self.__dict__.update(state)
        self._weights = _Weights()
        if carried:
            from repro_torch.convert import lm_params_from_arrays

            for name, tree in carried.items():
                self.set_params(name, lm_params_from_arrays(
                    self.variants[name][0], tree, device=self.device))

    def set_params(self, name: str, params) -> None:
        """Serve variant ``name`` with these weights (a ``TransformerParams``
        on this backend's device, e.g. from ``convert.lm_params_from_arrays``)
        instead of ``LM.init(seed)``'s; the lanes spawned from this
        backend read them too."""
        cfg, _ = self.variants[name]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # complete before any lane reads them
        with self._weights.lock:
            self._weights.models[name] = LM(cfg)
            self._weights.params[name] = params
            self._weights.carried.add(name)
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
        w = self._weights
        with w.lock:
            if name not in w.params:
                cfg, seed = self.variants[name]
                model = LM(cfg)
                w.params[name] = model.init(seed, device=self.device)
                if self.device.type == "cuda":  # complete before any lane reads them
                    torch.cuda.current_stream(self.device).synchronize()
                w.models[name] = model
            return w.models[name], w.params[name]

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
            if cap is not None and self.share_caches:
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

    def _on_lane(self):
        """Run on this backend's own stream (on the card; nothing on the CPU)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._lane_stream is None:
            self._lane_stream = torch.cuda.Stream(self.device)
        return torch.cuda.stream(self._lane_stream)

    def _clock(self) -> float:
        """The host's clock once this backend's stream has drained."""
        if self.device.type == "cuda":
            self._lane_stream.synchronize()
        return time.perf_counter()

    def _execute(self, model_name: str, prompts: np.ndarray,
                 class_token_ids: Optional[np.ndarray]):
        """Prefill and greedy decode of one (B, S) prompt batch on this
        backend's stream: (prefill_s, decode_s, (B, new_tokens) tokens,
        predictions or None)."""
        model, params = self._get(model_name)
        b, s = prompts.shape
        sp = moe_group_len(model.cfg, b, s)
        if sp > s:
            prompts = np.pad(np.asarray(prompts), ((0, 0), (0, sp - s)))
            s = sp
        capacity = bucket_capacity(s + self.new_tokens)
        with torch.inference_mode(), self._on_lane():
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
            out = torch.stack(toks, dim=1).cpu().numpy()
        return t1 - t0, t2 - t1, out, preds

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """prompts: (B, S) int32 (pre-padded)."""
        b = prompts.shape[0]
        prefill_s, decode_s, tokens, preds = self._execute(model_name, prompts,
                                                           class_token_ids)
        self._record(model_name, b, prefill_s + decode_s)
        return ExecutionReport(
            request_ids=request_ids,
            model=model_name,
            batch_size=b,
            swap_s=0.0,
            prefill_s=prefill_s,
            decode_s=decode_s,
            tokens=tokens,
            predictions=preds if preds is not None else [None] * b,
        )


def _bucket_batch(b: int) -> int:
    """Next power of two: bounds the distinct batch shapes (and graphs)."""
    return 1 << max(b - 1, 0).bit_length()


def _bucket_seq(s: int, multiple: int) -> int:
    """Round a sequence length up to the padding multiple."""
    return max(((s + multiple - 1) // multiple) * multiple, multiple)


class CompiledBackend(ProfiledBackend):
    """Serving-shaped forwards over registry models, the port of the
    reference's ``CompiledBackend``.

    Differences from ``ProfiledBackend`` (which times whatever shape the
    schedule hands it):

    * **Bucketing** — the batch is zero-padded to the next power of two
      and the sequence to a multiple of ``seq_multiple`` (right-padding,
      as the reference pads), so decode runs a bounded set of CUDA graphs,
      one per (variant, bucketed batch, capacity), each on a cache of its
      own: a graph is captured once and never retired.
    * **In-place caches** — the reference donates its decode cache to the
      jitted step; the graphs here write theirs in place.
    * **Continuous batching** — ``run_batches`` fuses a window's run of
      same-model batches into one forward and splits the measured seconds
      back per batch, by rows.
    * **Realized latency model** — every executed (padded batch, seconds)
      pair feeds an affine fit, except each (variant, bucketed batch,
      bucketed length)'s first run, which pays one-time costs (graph
      captures); ``affine`` self-calibrates with dummy batches of 1 and 2
      when asked before two batch sizes ran.  Provenance ``"realized"``.

    ``model_bytes`` counts the weights plus the KV cache at the batch and
    length hints, the residency cost the swap manager and the scheduler's
    capacity-aware LRU consume.
    """

    provenance = "realized"
    share_caches = False

    def __init__(self, variants: Mapping[str, tuple], new_tokens: int = 4,
                 seq_multiple: int = 8, batch_hint: int = 8,
                 max_len_hint: int | None = None, device=None):
        super().__init__(variants, new_tokens, device)
        self.seq_multiple = int(seq_multiple)
        self.batch_hint = int(batch_hint)
        self.max_len_hint = max_len_hint
        # Shapes already executed once: only later runs feed the fit.
        self._warm: set[tuple[str, int, int]] = set()

    def spawn(self) -> "CompiledBackend":
        """The backend of a new lane, with the same bucketing hints, over
        this backend's weights."""
        twin = CompiledBackend(
            self.variants, new_tokens=self.new_tokens, seq_multiple=self.seq_multiple,
            batch_hint=self.batch_hint, max_len_hint=self.max_len_hint, device=self.device,
        )
        twin._weights = self._weights
        return twin

    def _pad(self, prompts: np.ndarray) -> np.ndarray:
        b, s = prompts.shape
        bp = _bucket_batch(b)
        sp = _bucket_seq(s, self.seq_multiple)
        if (bp, sp) == (b, s):
            return prompts
        out = np.zeros((bp, sp), np.int32)
        out[:b, :s] = prompts
        return out

    def _forward(self, model_name: str, padded: np.ndarray,
                 class_token_ids: Optional[np.ndarray]):
        """One bucketed forward: (prefill_s, decode_s, tokens, predictions)
        for all padded rows; records the observation unless this is the
        shape's first run."""
        prefill_s, decode_s, tokens, preds = self._execute(model_name, padded,
                                                           class_token_ids)
        key = (model_name, padded.shape[0], padded.shape[1])
        if key in self._warm:
            self._record(model_name, padded.shape[0], prefill_s + decode_s)
        else:
            self._warm.add(key)
        return prefill_s, decode_s, tokens, preds

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """One bucketed forward for a scheduled batch; the report carries
        the unpadded rows (the timing covers the padded shape)."""
        b = prompts.shape[0]
        prefill_s, decode_s, tokens, preds = self._forward(
            model_name, self._pad(prompts), class_token_ids)
        return ExecutionReport(
            request_ids=request_ids, model=model_name, batch_size=b,
            swap_s=0.0, prefill_s=prefill_s, decode_s=decode_s,
            tokens=tokens[:b],
            predictions=list(preds[:b]) if preds is not None else [None] * b,
        )

    def run_batches(self, model_name: str, prompt_list: Sequence[np.ndarray],
                    rid_lists: Sequence[list],
                    class_token_ids: Optional[np.ndarray] = None) -> list[ExecutionReport]:
        """Continuous batching: fuse several scheduled batches of one model
        into one forward, then split the outputs and the measured seconds
        back per batch, in proportion to its rows."""
        sizes = [p.shape[0] for p in prompt_list]
        maxlen = max(p.shape[1] for p in prompt_list)
        total = sum(sizes)
        merged = np.zeros((total, maxlen), np.int32)
        row = 0
        for p in prompt_list:
            merged[row:row + p.shape[0], :p.shape[1]] = p
            row += p.shape[0]
        prefill_s, decode_s, tokens, preds = self._forward(
            model_name, self._pad(merged), class_token_ids)
        reports = []
        row = 0
        for b, rids in zip(sizes, rid_lists):
            frac = b / total
            reports.append(ExecutionReport(
                request_ids=list(rids), model=model_name, batch_size=b,
                swap_s=0.0, prefill_s=prefill_s * frac, decode_s=decode_s * frac,
                tokens=tokens[row:row + b],
                predictions=(list(preds[row:row + b]) if preds is not None
                             else [None] * b),
            ))
            row += b
        return reports

    def _calibrate(self, model_name: str) -> None:
        """Seed the fit with dummy forwards at two bucketed batch sizes:
        each shape runs twice, the first unrecorded."""
        for b in (1, 2):
            dummy = np.zeros((b, self.seq_multiple), np.int32)
            for _ in range(2):
                self.run_batch(model_name, dummy, list(range(b)))

    def affine(self, model_name: str) -> tuple[float, float]:
        """Realized-latency fit; self-calibrates if too few shapes ran."""
        obs = self._obs.get(model_name, [])
        if len({b for b, _ in obs}) < 2:
            self._calibrate(model_name)
        return _affine_fit(self._obs[model_name])

    def model_bytes(self, model_name: str, batch: int | None = None,
                    max_len: int | None = None) -> int:
        """Weights plus the KV cache at the batch and length hints."""
        cfg, _ = self.variants[model_name]
        b = batch if batch is not None else self.batch_hint
        if max_len is None:
            max_len = self.max_len_hint
        if max_len is None:
            max_len = _bucket_seq(64, self.seq_multiple) + self.new_tokens
        return weight_bytes(cfg) + kvcache.cache_bytes(cfg, b, max_len)


class SimulatedBackend(ExecutorBackend):
    """Deterministic substrate without a model, built from scheduler
    ``ModelProfile``s: no config, no tensor, no device.

    Reported seconds are always the profile's modelled latency (its
    affine ``latency_model``, or flat ``latency_s``), so every run, any
    lane strategy, sees identical reports.  What varies is how long a
    call occupies its lane: ``occupancy="none"`` returns at once,
    ``"sleep"`` holds the lane for the modelled seconds (times
    ``time_scale``) in ``time.sleep``, which releases the GIL, and
    ``"spin"`` busy-waits as long without releasing it.  Predictions are
    a deterministic hash of (rid, model), equal across lanes and
    processes; instances pickle as they are.
    """

    provenance = "simulated"

    OCCUPANCY = ("none", "sleep", "spin")

    def __init__(self, profiles: Mapping[str, ModelProfile], new_tokens: int = 0,
                 occupancy: str = "none", time_scale: float = 1.0):
        if occupancy not in self.OCCUPANCY:
            raise ValueError(f"unknown occupancy {occupancy!r}; "
                             f"expected one of {self.OCCUPANCY}")
        super().__init__({name: (prof, 0) for name, prof in dict(profiles).items()},
                         new_tokens)
        self.profiles = dict(profiles)
        self.occupancy = occupancy
        self.time_scale = float(time_scale)

    def spawn(self) -> "SimulatedBackend":
        """A new lane's instance with the same profiles and occupancy."""
        return SimulatedBackend(self.profiles, new_tokens=self.new_tokens,
                                occupancy=self.occupancy, time_scale=self.time_scale)

    def affine(self, model_name: str) -> tuple[float, float]:
        """The profile's declared latency model (flat if it has none)."""
        prof = self.profiles[model_name]
        if prof.latency_model is not None:
            return float(prof.latency_model[0]), float(prof.latency_model[1])
        return float(prof.latency_s), 0.0

    def model_bytes(self, model_name: str, batch: int | None = None,
                    max_len: int | None = None) -> int:
        """The profile's declared residency footprint."""
        return int(self.profiles[model_name].memory_bytes)

    def swap_cost(self, model_name: str) -> float:
        """The profile's declared cold-load seconds."""
        return float(self.profiles[model_name].load_latency_s)

    def _occupy(self, seconds: float) -> None:
        if seconds <= 0.0 or self.occupancy == "none":
            return
        if self.occupancy == "sleep":
            time.sleep(seconds)
            return
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            pass

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """Occupy the lane per the occupancy mode, report the modelled
        seconds, and emit deterministic per-request predictions."""
        b = prompts.shape[0]
        fixed, per_item = self.affine(model_name)
        total = fixed + per_item * b
        self._occupy(total * self.time_scale)
        self._record(model_name, b, total)
        n_classes = max(len(self.profiles[model_name].recalls), 1)
        preds = [int((int(rid) * 1103515245 + len(model_name)) % n_classes)
                 for rid in request_ids]
        return ExecutionReport(
            request_ids=list(request_ids), model=model_name, batch_size=b,
            swap_s=0.0, prefill_s=total, decode_s=0.0,
            tokens=np.zeros((b, 0), np.int32),
            predictions=preds,
        )


class CostModelBackend(ExecutorBackend):
    """Latency from the roofline cost model — no device execution.

    Every estimate flows through ``serving.profiles``: dry-run roofline
    records when ``results_dir`` has them, cost-model totals when passed
    via ``costs=``, and the analytic roofline census
    (``launch.hlo_analysis.HW``, one H100, and ``models.kvcache.
    cache_bytes`` for decode cache reads) otherwise.  ``run_batch``
    returns a synthetic ``ExecutionReport`` whose timing fields carry the
    MODELLED seconds (split prefill/decode by the census's proportions)
    with no generated tokens — this backend drives schedulers and
    capacity planning for variants too large to execute.  Provenance
    ``"costmodel"``.  ``n_devices`` defaults to the one card the port
    serves on (the reference's to 16).

    ``variants`` accepts the executor convention ``{name: (cfg, seed)}``
    or bare configs / registry arch names.
    """

    provenance = "costmodel"

    def __init__(self, variants: Mapping, prompt_tokens: int = 512,
                 new_tokens: int = 64, results_dir=None, mesh: str = "pod",
                 n_devices: int = 1, costs: Mapping[str, Mapping] | None = None,
                 batch_hint: int = 8):
        from repro_torch.configs import get_config

        norm = {}
        for name, v in dict(variants).items():
            if isinstance(v, tuple):
                norm[name] = v
            elif isinstance(v, str):
                norm[name] = (get_config(v), 0)
            else:
                norm[name] = (v, 0)
        super().__init__(norm, new_tokens)
        self.prompt_tokens = int(prompt_tokens)
        self.results_dir = results_dir
        self.mesh = mesh
        self.n_devices = int(n_devices)
        self.costs = dict(costs) if costs else {}
        self.batch_hint = int(batch_hint)
        self._affine_cache: dict[str, tuple[float, float]] = {}

    def spawn(self) -> "CostModelBackend":
        """Fresh lane instance sharing the cost-model parameters."""
        return CostModelBackend(
            self.variants, prompt_tokens=self.prompt_tokens,
            new_tokens=self.new_tokens, results_dir=self.results_dir,
            mesh=self.mesh, n_devices=self.n_devices, costs=self.costs,
            batch_hint=self.batch_hint,
        )

    def affine(self, model_name: str) -> tuple[float, float]:
        """(fixed_s, per_item_s) from the roofline cost model (cached)."""
        if model_name not in self._affine_cache:
            from repro_torch.serving.profiles import costmodel_latency_model

            cfg, _ = self.variants[model_name]
            self._affine_cache[model_name] = costmodel_latency_model(
                cfg, prompt_tokens=self.prompt_tokens,
                new_tokens=self.new_tokens, results_dir=self.results_dir,
                mesh=self.mesh, n_devices=self.n_devices,
                costs=self.costs.get(model_name),
            )
        return self._affine_cache[model_name]

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """Synthetic report: modelled seconds (census prefill/decode
        split), zero generated tokens, no predictions."""
        from repro_torch.serving.profiles import costmodel_terms

        b = prompts.shape[0]
        fixed, per_item = self.affine(model_name)
        total = fixed + per_item * b
        cfg, _ = self.variants[model_name]
        terms = costmodel_terms(cfg, prompt_tokens=self.prompt_tokens,
                                new_tokens=self.new_tokens,
                                n_devices=self.n_devices)
        census_prefill = terms["prefill_fixed_s"] + terms["prefill_item_s"] * b
        census_total = census_prefill + terms["decode_fixed_s"] + terms["decode_item_s"] * b
        pf = census_prefill / census_total if census_total > 0 else 0.0
        return ExecutionReport(
            request_ids=request_ids, model=model_name, batch_size=b,
            swap_s=0.0, prefill_s=total * pf, decode_s=total * (1.0 - pf),
            tokens=np.zeros((b, 0), np.int32),
            predictions=[None] * b,
        )

    def model_bytes(self, model_name: str, batch: int | None = None,
                    max_len: int | None = None) -> int:
        """Weights plus the KV cache at the modelled serving shape."""
        cfg, _ = self.variants[model_name]
        b = batch if batch is not None else self.batch_hint
        if max_len is None:
            max_len = self.prompt_tokens + self.new_tokens
        return weight_bytes(cfg) + kvcache.cache_bytes(cfg, b, max_len)

    def swap_cost(self, model_name: str) -> float:
        """Per-device weight shards stage in parallel, at the rate
        ``lm_profile`` charges."""
        cfg, _ = self.variants[model_name]
        return weight_bytes(cfg) / _STAGING_BW / self.n_devices

    def profiles(self, recalls: Mapping[str, Sequence[float]]) -> dict[str, ModelProfile]:
        """Mint one costmodel-provenance ``ModelProfile`` per variant."""
        return {name: self.profile(name, rec) for name, rec in recalls.items()}
