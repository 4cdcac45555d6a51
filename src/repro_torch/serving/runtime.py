"""Serving runtime: window queue, model-swap manager, batch executors.

The counterpart of ``repro.serving.runtime``: the scheduler
(``repro_torch.core``) decides (model, order, batch, worker); the
runtime charges swaps and dispatches batches to an ``ExecutorBackend``
(``serving.backends``), the port's ``LM`` on the card by default.
``LMExecutor`` runs a single worker's schedule; ``ExecutorPool`` runs a
placed schedule with one ``WorkerExecutor`` lane per worker, each with
its own backend instance (its own stream on the card, its own decode
graphs, caches and swap manager).  Lanes run one after another
(``"serial"``), on threads (``"thread"``), or forward each batch to a
spawned worker process that owns its CUDA context (``"process"``,
``ProcessLaneBackend``).  ``execute_supervised`` is the fault-tolerant
gather (per-batch failure records, a fault injector polled per batch, a
shared lane deadline), ``execute_async`` starts a window's gather on a
one-thread coordinator and returns at once, so the serving loop can
schedule the next window while this one runs.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Callable, Mapping, Optional, Sequence

import numpy as np

from repro_torch import kernels
from repro_torch.core.multiworker import Worker
from repro_torch.core.residency import evict_lru
from repro_torch.core.types import Request, Schedule, ScheduleEntry
from repro_torch.serving.backends import ExecutionReport, ExecutorBackend, ProfiledBackend

__all__ = ["WindowQueue", "SwapManager", "LMExecutor", "ExecutionReport",
           "iter_entry_batches", "LANE_NAMES", "BatchFailure", "PoolOutcome",
           "PendingExecution", "ProcessLaneBackend", "WorkerExecutor", "ExecutorPool"]

# Lane strategies of ExecutorPool: "serial" runs the lanes one after
# another in the calling thread, "thread" one long-lived thread per lane,
# "process" keeps the lane threads for coordination and forwards every
# batch to a spawned worker process holding its own backend instance.
LANE_NAMES = ("serial", "thread", "process")


class WindowQueue:
    """Scheduling-window request queue (paper §III-B: requests enqueue
    during a window, then are scheduled as a set)."""

    def __init__(self, window_s: float = 0.1):
        self.window_s = window_s
        self._pending: list[Request] = []

    def submit(self, request: Request):
        """Enqueue a request for the window containing its arrival."""
        self._pending.append(request)

    def drain_window(self, now: float) -> list[Request]:
        """Requests that arrived by ``now`` (window close), ordered by
        (arrival, rid): simultaneous arrivals drain deterministically
        whatever the submission order."""
        ready = [r for r in self._pending if r.arrival_s <= now]
        self._pending = [r for r in self._pending if r.arrival_s > now]
        return sorted(ready, key=lambda r: (r.arrival_s, r.rid))

    def readmit(self, requests: Sequence[Request]) -> None:
        """Merge withdrawn (preempted or retried) requests back into the
        queue.  Their ``arrival_s`` is in the past, so the next
        ``drain_window`` returns them with the fresh arrivals under the
        same (arrival, rid) order — the re-admission path of window-close
        preemption."""
        self._pending.extend(requests)

    def __len__(self):
        return len(self._pending)


class SwapManager:
    """LRU model residency with byte-accounted capacity.

    ``load(name)`` returns the swap latency charged (0 when resident) and
    updates residency; the weights themselves are made by the backend's
    lazy store.  Eviction follows the shared rule of
    ``core.residency.evict_lru``, the one the scheduler's timelines charge
    swaps by: oldest first, never the model being loaded.
    """

    def __init__(self, capacity_bytes: int | None, sizes: Mapping[str, int],
                 load_latency: Mapping[str, float]):
        self.capacity = capacity_bytes
        self.sizes = dict(sizes)
        self.load_latency = dict(load_latency)
        self._resident: OrderedDict[str, int] = OrderedDict()
        self.swap_count = 0
        self.evictions = 0

    def resident_bytes(self) -> int:
        """Total bytes of currently resident model weights."""
        return sum(self._resident.values())

    def is_resident(self, name: str) -> bool:
        """Whether ``name`` is currently resident (no swap charge)."""
        return name in self._resident

    def load(self, name: str) -> float:
        """Make ``name`` resident; returns the swap latency charged."""
        if name in self._resident:
            self._resident.move_to_end(name)
            return 0.0
        self.swap_count += 1
        self._resident[name] = self.sizes.get(name, 0)
        order = list(self._resident)
        for victim in evict_lru(order, self.sizes, self.capacity, protect=name):
            del self._resident[victim]
            self.evictions += 1
        return self.load_latency.get(name, 0.0)


class LMExecutor:
    """Executes scheduled batches through an ``ExecutorBackend``.

    The executor owns the residency accounting (its ``SwapManager``, sized
    by ``backend.model_bytes`` and charged at ``backend.swap_cost`` per
    cold load); the backend runs the forward passes.  Without an explicit
    ``backend`` the default is ``ProfiledBackend(variants, new_tokens,
    device)`` ({name: (ModelConfig, seed)}), on the card unless
    ``device="cpu"`` is named.

    Classification convention of the paper's applications: each request
    carries its prompt ids (``prompt_fn``); the predicted class is the
    argmax over the logits of ``class_token_ids`` after prefill.
    """

    def __init__(self, variants: Mapping[str, tuple] | None = None,
                 capacity_bytes: int | None = None, new_tokens: int = 4,
                 backend: ExecutorBackend | None = None, device=None):
        if backend is None:
            if variants is None:
                raise ValueError("LMExecutor needs variants=... or backend=...")
            backend = ProfiledBackend(variants, new_tokens=new_tokens, device=device)
        self.backend = backend
        self.variants = dict(backend.variants)
        self.new_tokens = backend.new_tokens
        sizes = {name: int(backend.model_bytes(name)) for name in self.variants}
        loads = {name: float(backend.swap_cost(name)) for name in self.variants}
        self.swaps = SwapManager(capacity_bytes, sizes, loads)

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """prompts: (B, S) int32 (pre-padded)."""
        swap_s = self.swaps.load(model_name)
        report = self.backend.run_batch(model_name, prompts, request_ids, class_token_ids)
        report.swap_s = swap_s
        return report

    def close(self) -> None:
        """Release backend resources (e.g. a process lane's worker)."""
        self.backend.close()

    @staticmethod
    def _pad(batch: Sequence[ScheduleEntry],
             prompt_fn: Callable[[Request], np.ndarray]) -> np.ndarray:
        """Prompts right-padded with 0 to the longest; the backend reads
        the logits of the last position even for shorter prompts, as the
        reference does."""
        prompts = [prompt_fn(e.request) for e in batch]
        maxlen = max(p.shape[0] for p in prompts)
        padded = np.zeros((len(prompts), maxlen), np.int32)
        for k, p in enumerate(prompts):
            padded[k, :p.shape[0]] = p
        return padded

    def run_entry_batch(self, batch: Sequence[ScheduleEntry],
                        prompt_fn: Callable[[Request], np.ndarray],
                        class_token_ids=None) -> ExecutionReport:
        """Execute ONE batch of schedule entries (same model and batch_id)."""
        if batch[0].model.endswith(":short_circuit"):
            # §V-C1: answered by the SneakPeek stage — no model execution,
            # no swap, no prompt tokenisation or padding.
            return ExecutionReport(
                request_ids=[e.request.rid for e in batch], model=batch[0].model,
                batch_size=len(batch), swap_s=0.0, prefill_s=0.0, decode_s=0.0,
                tokens=np.zeros((len(batch), 0), np.int32),
                predictions=[None] * len(batch))
        return self.run_batch(
            batch[0].model, self._pad(batch, prompt_fn),
            [e.request.rid for e in batch], class_token_ids)

    def execute_schedule(self, schedule: Schedule, prompt_fn: Callable[[Request], np.ndarray],
                         class_token_ids=None) -> list[ExecutionReport]:
        """Run a scheduler-produced schedule batch by batch: entries that
        share a batch_id execute as one padded batch.

        When the backend batches continuously (``run_batches``, e.g.
        ``CompiledBackend``), consecutive same-model batches fuse into one
        forward; the swap is charged once, on the run's first report, and
        the fused seconds are split between the batches.
        """
        batches = list(iter_entry_batches(schedule.sorted_entries()))
        merged_runs = hasattr(self.backend, "run_batches")
        reports: list[ExecutionReport] = []
        i = 0
        while i < len(batches):
            model = batches[i][0].model
            j = i
            if merged_runs and not model.endswith(":short_circuit"):
                while j + 1 < len(batches) and batches[j + 1][0].model == model:
                    j += 1
            if j == i:
                reports.append(self.run_entry_batch(batches[i], prompt_fn, class_token_ids))
            else:
                run = batches[i:j + 1]
                swap_s = self.swaps.load(model)
                merged = self.backend.run_batches(
                    model,
                    [self._pad(b, prompt_fn) for b in run],
                    [[e.request.rid for e in b] for b in run],
                    class_token_ids,
                )
                merged[0].swap_s = swap_s
                reports.extend(merged)
            i = j + 1
        return reports


@dataclasses.dataclass
class BatchFailure:
    """One batch that did not execute on its lane: ``kind`` is an injected
    fault kind, ``"error"`` for an exception of the batch, or ``"lane"``
    for a failure of the lane; ``cascaded`` marks batches failed only
    because an earlier crash stopped their lane."""

    worker: int
    request_ids: list
    model: str
    kind: str
    batch_index: int = -1
    cascaded: bool = False
    error: str = ""


@dataclasses.dataclass
class PoolOutcome:
    """What a pool's gather collected from its lanes: the successful
    reports, the failed batches, and the lanes that overran the deadline
    (joined late: a health signal, not lost work)."""

    reports: list
    failures: list
    timed_out: list

    def failed_rids(self) -> set[int]:
        """Request ids of every failed batch."""
        return {rid for f in self.failures for rid in f.request_ids}


class _ImmediateFuture:
    """Future-shaped wrapper around a call that already ran (serial lane)."""

    def __init__(self, fn, args):
        self._exc: BaseException | None = None
        self._res = None
        try:
            self._res = fn(*args)
        except BaseException as err:  # re-raised at result(), like a Future
            self._exc = err

    def result(self, timeout=None):
        """The call's result (it ran at submit time)."""
        if self._exc is not None:
            raise self._exc
        return self._res


class _ImmediateExecutor:
    """Executor-shaped serial lane: ``submit`` runs the call inline, in
    submission order, in the calling thread."""

    def submit(self, fn, *args) -> _ImmediateFuture:
        return _ImmediateFuture(fn, args)

    def shutdown(self, wait=True):
        """Nothing to tear down (no threads)."""


def _lane_worker_main(conn) -> None:
    """Entry point of one spawned lane worker process.

    Protocol (the parent's side is ``ProcessLaneBackend``): first
    ``("init", backend)`` — the pickled, never-run backend this process
    owns, which places its weights on its own device; then ``("run",
    model, prompts, rids, class_token_ids)`` per batch, answered with
    ``("ok", prefill_s, decode_s, tokens, predictions, launches)`` —
    ``launches`` being the kernel launches the batch made in this process
    — or ``("err", repr)``; ``("stop",)`` ends the loop."""
    backend = None
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        except Exception as err:  # the template did not unpickle here
            conn.send(("err", repr(err)))
            continue
        if msg[0] == "stop":
            conn.close()
            return
        if msg[0] == "init":
            backend = msg[1]
            conn.send(("ok",))
            continue
        _, model_name, prompts, rids, class_token_ids = msg
        try:
            before = kernels.launch_counts()
            rep = backend.run_batch(model_name, prompts, rids, class_token_ids)
            after = kernels.launch_counts()
            launches = {name: n - before.get(name, 0) for name, n in after.items()
                        if n != before.get(name, 0)}
            conn.send(("ok", rep.prefill_s, rep.decode_s, rep.tokens, rep.predictions,
                       launches))
        except Exception as err:
            conn.send(("err", repr(err)))


class ProcessLaneBackend(ExecutorBackend):
    """Backend proxy that forwards every batch to a dedicated worker
    process, started with the spawn method, holding its own backend
    instance and, on the card, its own CUDA context.

    ``template`` must be a fresh backend — what ``spawn()`` returns — so
    it pickles into the child; one that has run batches refuses to.  The
    parent keeps it for sizes, swap costs and provenance, and records the
    realized seconds for ``affine``.  Work crosses as plain arrays
    (padded (B, S) int32 prompts and request ids), reports come back as
    plain fields with the child's kernel launches, which are added to
    this process's counts (``kernels.add_launches``).  A batch that fails
    in the child raises here.  The child starts on the first
    ``run_batch``; ``close()`` stops it.
    """

    def __init__(self, template: ExecutorBackend):
        self.template = template
        self.variants = dict(template.variants)
        self.new_tokens = template.new_tokens
        self.provenance = template.provenance
        self._obs = {}
        self._proc = None
        self._conn = None

    def _ensure(self) -> None:
        if self._proc is not None:
            return
        ctx = multiprocessing.get_context("spawn")
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=_lane_worker_main, args=(child,), daemon=True)
        try:
            proc.start()
        finally:
            child.close()
        self._proc, self._conn = proc, conn
        try:
            self._conn.send(("init", self.template))
            ack = self._conn.recv()
        except BaseException:
            self.close()
            raise
        if ack[0] != "ok":
            self.close()
            raise RuntimeError(f"lane worker failed to initialize: {ack[1]}")

    def run_batch(self, model_name: str, prompts: np.ndarray, request_ids: list,
                  class_token_ids: Optional[np.ndarray] = None) -> ExecutionReport:
        """Ship one padded batch to the worker process and rebuild the
        report here.  Waiting on the pipe releases the GIL, so the lane
        threads wait in parallel while their processes compute."""
        self._ensure()
        self._conn.send(("run", model_name, np.ascontiguousarray(prompts),
                         list(request_ids), class_token_ids))
        reply = self._conn.recv()
        if reply[0] != "ok":
            raise RuntimeError(f"lane worker batch failed: {reply[1]}")
        _, prefill_s, decode_s, tokens, predictions, launches = reply
        kernels.add_launches(launches)
        self._record(model_name, prompts.shape[0], prefill_s + decode_s)
        return ExecutionReport(
            request_ids=list(request_ids), model=model_name,
            batch_size=prompts.shape[0], swap_s=0.0,
            prefill_s=prefill_s, decode_s=decode_s,
            tokens=tokens, predictions=predictions,
        )

    def affine(self, model_name: str):
        """The realized fit once batches have run, else the template's."""
        if self._obs.get(model_name):
            return super().affine(model_name)
        return self.template.affine(model_name)

    def model_bytes(self, model_name: str, batch: int | None = None,
                    max_len: int | None = None) -> int:
        """Residency footprint, from the template."""
        return self.template.model_bytes(model_name, batch, max_len)

    def swap_cost(self, model_name: str) -> float:
        """Cold-load seconds, from the template."""
        return self.template.swap_cost(model_name)

    def spawn(self) -> "ProcessLaneBackend":
        """A new proxy over a new template (its own worker process)."""
        return ProcessLaneBackend(self.template.spawn())

    def close(self) -> None:
        """Stop and join the worker process (idempotent)."""
        if self._proc is None:
            return
        try:
            self._conn.send(("stop",))
        except (BrokenPipeError, OSError):
            pass
        self._conn.close()
        self._proc.join(timeout=30.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        self._proc = None
        self._conn = None


class PendingExecution:
    """Handle to one window's lane execution in flight
    (``ExecutorPool.execute_async``).

    ``result()`` joins the coordinator and returns the ``PoolOutcome``;
    ``started_at`` and ``finished_at`` are ``time.perf_counter()`` stamps
    the serving loop reads to measure how much scheduling time the
    overlap hid."""

    def __init__(self, future: Future, started_at: float):
        self._future = future
        self.started_at = started_at
        self.finished_at: float | None = None

    def done(self) -> bool:
        """Whether the lanes have all finished (non-blocking)."""
        return self._future.done()

    def result(self) -> PoolOutcome:
        """Join the execution (re-raising lane errors as the synchronous
        path does)."""
        outcome, finished = self._future.result()
        self.finished_at = finished
        return outcome


class WorkerExecutor:
    """One worker's execution lane: a private ``LMExecutor`` (its own
    ``SwapManager``: per-worker residency, as the scheduler's per-worker
    timelines model it) and the ``multiworker.Worker`` whose speed and
    load scaling it honours.

    The lanes share one card, so heterogeneity is honoured in the
    accounting: measured prefill and decode seconds divide by
    ``worker.speed`` and swap seconds multiply by ``worker.load_scale``,
    consistent with the scaled profiles Eq. 15 placed the batch with.
    Without a ``backend`` it builds ``ProfiledBackend(variants,
    new_tokens, device)``, on the card unless ``device="cpu"``.
    """

    def __init__(self, worker: Worker, variants: Mapping[str, tuple] | None = None,
                 capacity_bytes: int | None = None, new_tokens: int = 4,
                 backend: ExecutorBackend | None = None, device=None):
        self.worker = worker
        self.executor = LMExecutor(variants, capacity_bytes, new_tokens, backend=backend,
                                   device=device)
        self.busy_s = 0.0
        # Kernel launches this lane caused ({name: n}): read from the
        # lane thread's own tally around each share it runs.
        self.launches: dict[str, int] = {}

    @property
    def swap_count(self) -> int:
        """Weight swaps this lane's SwapManager has performed."""
        return self.executor.swaps.swap_count

    def _scaled(self, report: ExecutionReport) -> ExecutionReport:
        w = self.worker
        if w.speed == 1.0 and w.load_scale == 1.0:
            return report
        return dataclasses.replace(
            report,
            swap_s=report.swap_s * w.load_scale,
            prefill_s=report.prefill_s / w.speed,
            decode_s=report.decode_s / w.speed,
        )

    def execute(
        self,
        entries: Sequence[ScheduleEntry],
        prompt_fn: Callable[[Request], np.ndarray],
        class_token_ids=None,
        until: float | None = None,
        on_dispatch: Callable[[list[int]], None] | None = None,
        injector=None,
        window: int = 0,
        failures: list | None = None,
    ) -> list[ExecutionReport]:
        """Run this worker's share of a placed schedule, batch by batch.

        ``until`` stops dispatch at the first batch whose committed start
        time is at or past it (est_start_s is nondecreasing along a
        worker's queue, so everything later stays backlogged for the next
        window — the half of the schedule window-close preemption may
        withdraw).  ``on_dispatch(rids)`` fires as each batch begins,
        before it runs: the serving loop sets the streaming state's
        dispatch marks with it, so started work is never withdrawn.

        ``injector`` (``serving.faults.FaultInjector``) is polled per
        batch index within ``window``; ``failures`` (a list the supervised
        gather passes in) collects ``BatchFailure`` records — injected
        faults and exceptions of a batch — instead of raising, so one bad
        batch never takes down the lane's remaining work.  Without it
        exceptions propagate.  A crash stops the lane: its batch and every
        later batch fail (the later ones marked ``cascaded``).  A hang runs
        the batch and adds the fault's ``delay_s`` to its reported decode
        seconds, without sleeping: the straggler signal flows through the
        realized-latency EWMA as a slow lane's would.  A batch an injected
        fault fails never runs, so it launches no kernel."""
        if injector is not None and failures is None:
            raise ValueError("fault injection requires a failures sink "
                             "(use ExecutorPool.execute_supervised)")
        reports = []
        wid = self.worker.wid
        crashed = False
        before = kernels.thread_launch_counts()
        try:
            for bi, batch in enumerate(iter_entry_batches(sorted(entries, key=lambda e: e.order))):
                if until is not None and batch[0].est_start_s >= until - 1e-12:
                    break
                rids = [e.request.rid for e in batch]
                if crashed:
                    failures.append(BatchFailure(
                        worker=wid, request_ids=rids, model=batch[0].model,
                        kind="crash", batch_index=bi, cascaded=True))
                    continue
                fault = injector.poll(window, wid, bi, rids) if injector is not None else None
                if fault is not None and fault.kind in ("crash", "transient", "swap_fail"):
                    failures.append(BatchFailure(
                        worker=wid, request_ids=rids, model=batch[0].model,
                        kind=fault.kind, batch_index=bi))
                    crashed = fault.kind == "crash"
                    continue
                if on_dispatch is not None:
                    on_dispatch(rids)
                try:
                    report = self._scaled(
                        self.executor.run_entry_batch(batch, prompt_fn, class_token_ids))
                except Exception as err:
                    if failures is None:
                        raise
                    failures.append(BatchFailure(
                        worker=wid, request_ids=rids, model=batch[0].model,
                        kind="error", batch_index=bi, error=repr(err)))
                    continue
                if fault is not None and fault.kind == "hang":
                    report = dataclasses.replace(report, decode_s=report.decode_s + fault.delay_s)
                report.worker = wid
                self.busy_s += report.total_s
                reports.append(report)
        finally:
            for name, n in kernels.thread_launch_counts().items():
                if n != before.get(name, 0):
                    self.launches[name] = self.launches.get(name, 0) + n - before.get(name, 0)
        return reports


class ExecutorPool:
    """The multi-worker execution plane: one ``WorkerExecutor`` lane per
    ``multiworker.Worker``, running each window's placed schedule per
    worker.

    ``EdgeServer(workers=[...])`` routes every window here and feeds the
    per-lane swap counts and busy seconds into ``ServeStats``.
    """

    def __init__(self, workers: Sequence[Worker], variants: Mapping[str, tuple] | None = None,
                 capacity_bytes: int | None = None, new_tokens: int = 4,
                 backend_factory: Callable[[], ExecutorBackend] | None = None,
                 lane: str = "thread", device=None):
        """``backend_factory`` (e.g. ``some_backend.spawn``) is called once
        per lane, so every worker gets its own substrate instance.
        Without it the lanes are spawned from one ``ProfiledBackend(
        variants, new_tokens, device)`` (on the card unless ``device="cpu"``
        is named), so they read one copy of the weights.

        ``lane`` picks the strategy per ``LANE_NAMES``: ``"thread"`` runs
        the lanes on a long-lived thread pool, ``"serial"`` one after
        another in the calling thread, ``"process"`` wraps each lane's
        backend in a ``ProcessLaneBackend``, so its batches run in a
        spawned worker process."""
        if not workers:
            raise ValueError("ExecutorPool requires at least one worker")
        if variants is None and backend_factory is None:
            raise ValueError("ExecutorPool needs variants=... or backend_factory=...")
        if lane not in LANE_NAMES:
            raise ValueError(f"unknown lane strategy {lane!r}; expected one of {LANE_NAMES}")
        self.lane = lane
        if backend_factory is None:
            backend_factory = ProfiledBackend(variants, new_tokens=new_tokens,
                                              device=device).spawn
        if lane == "process":
            inner = backend_factory
            backend_factory = lambda: ProcessLaneBackend(inner())  # noqa: E731
        self.lanes: dict[int, WorkerExecutor] = {
            w.wid: WorkerExecutor(w, capacity_bytes=capacity_bytes, backend=backend_factory())
            for w in workers
        }
        self.wall_s = 0.0  # wall-clock spent inside the gathers
        # One long-lived thread per lane (the serial lane: a shim that
        # runs the work at submit).
        self._tp: ThreadPoolExecutor | _ImmediateExecutor | None = None
        # One-thread coordinator of execute_async: runs the whole gather
        # off the caller's thread, so scheduling can overlap it.
        self._coord: ThreadPoolExecutor | None = None

    @classmethod
    def from_executor(cls, executor: LMExecutor, workers: Sequence[Worker],
                      lane: str = "thread") -> "ExecutorPool":
        """A pool with one lane per worker from a single executor's
        configuration: the same capacity and new_tokens, one
        ``backend.spawn()`` per lane, each lane its own residency."""
        return cls(
            workers,
            executor.variants,
            capacity_bytes=executor.swaps.capacity,
            new_tokens=executor.new_tokens,
            backend_factory=executor.backend.spawn,
            lane=lane,
        )

    def close(self) -> None:
        """Shut the coordinator and the lane threads down (waiting for
        work in flight) and close every lane's backend, which stops
        process lanes' workers.  Idempotent."""
        if self._coord is not None:
            self._coord.shutdown(wait=True)
            self._coord = None
        if self._tp is not None:
            self._tp.shutdown(wait=True)
            self._tp = None
        for lane in self.lanes.values():
            lane.executor.close()

    def __enter__(self) -> "ExecutorPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    @property
    def swap_counts(self) -> dict[int, int]:
        """Per-worker weight-swap counts (lane SwapManagers)."""
        return {w: lane.swap_count for w, lane in sorted(self.lanes.items())}

    @property
    def busy_s(self) -> dict[int, float]:
        """Per-worker busy seconds (scaled swap + prefill + decode)."""
        return {w: lane.busy_s for w, lane in sorted(self.lanes.items())}

    @property
    def launch_counts(self) -> dict[int, dict[str, int]]:
        """Per-worker kernel launches its lane caused (``WorkerExecutor.launches``)."""
        return {w: dict(lane.launches) for w, lane in sorted(self.lanes.items())}

    def utilization(self) -> dict[int, float]:
        """Per-worker busy / pool-wall fraction (0.0 before any work)."""
        if self.wall_s <= 0:
            return {w: 0.0 for w in sorted(self.lanes)}
        return {w: lane.busy_s / self.wall_s for w, lane in sorted(self.lanes.items())}

    def execute_schedule(
        self,
        schedule: Schedule,
        prompt_fn: Callable[[Request], np.ndarray],
        class_token_ids=None,
        until: float | None = None,
        on_dispatch: Callable[[list[int]], None] | None = None,
    ) -> list[ExecutionReport]:
        """Execute a placed schedule: entries split by ``entry.worker``,
        each lane running its share in order on its own lane.  ``until``
        and ``on_dispatch`` go to every lane (``WorkerExecutor.execute``).
        Reports return grouped by worker id, each lane's in dispatch
        order.

        ``prompt_fn`` and ``on_dispatch`` are called from several lane
        threads at once: derive any randomness from the request (e.g. its
        rid), not from one shared generator.  Every lane is joined before
        anything is raised; then the first failing lane's error (ascending
        worker id) is re-raised.  This is the supervised gather with its
        machinery off: no injector, no failure sinks, no deadline."""
        return self._gather(
            schedule, prompt_fn, class_token_ids, until, on_dispatch,
            injector=None, window=0, timeout_s=None, supervised=False,
        ).reports

    def execute_async(
        self,
        schedule: Schedule,
        prompt_fn: Callable[[Request], np.ndarray],
        class_token_ids=None,
        until: float | None = None,
        on_dispatch: Callable[[list[int]], None] | None = None,
        injector=None,
        window: int = 0,
        timeout_s: float | None = None,
        supervised: bool = True,
    ) -> PendingExecution:
        """Start a window's lane execution without joining it: the whole
        gather (dispatch, lane join, ``wall_s`` accounting) runs on a
        one-thread coordinator, and the returned ``PendingExecution``
        joins it later — so the serving loop schedules window k+1 while
        window k's lanes run.

        The semantics are those of ``execute_supervised`` (or, with
        ``supervised=False``, ``execute_schedule``) at the moment
        ``result()`` is awaited: the same lane split, join order and
        failure records; unsupervised lane errors re-raise out of
        ``result()``.  One execution is in flight at a time (a second
        call queues behind the first on the coordinator)."""
        if self._coord is None:
            self._coord = ThreadPoolExecutor(max_workers=1)
        t0 = time.perf_counter()

        def _run() -> tuple[PoolOutcome, float]:
            outcome = self._gather(
                schedule, prompt_fn, class_token_ids, until, on_dispatch,
                injector, window, timeout_s, supervised,
            )
            return outcome, time.perf_counter()

        return PendingExecution(self._coord.submit(_run), t0)

    def execute_supervised(
        self,
        schedule: Schedule,
        prompt_fn: Callable[[Request], np.ndarray],
        class_token_ids=None,
        until: float | None = None,
        on_dispatch: Callable[[list[int]], None] | None = None,
        injector=None,
        window: int = 0,
        timeout_s: float | None = None,
    ) -> PoolOutcome:
        """The fault-tolerant twin of ``execute_schedule``.

        Each lane runs with a per-batch failure guard and the optional
        fault ``injector``, polled per (window, worker, batch): injected
        faults and exceptions become ``BatchFailure`` records instead of
        raising, so one bad batch never loses the rest of the window.
        ``timeout_s`` bounds the wait for the whole pool's lanes (a
        deadline shared from dispatch): a lane that overruns it is
        recorded in ``timed_out`` — a health signal — and then joined
        anyway (a thread cannot be cancelled).  A lane's exception outside
        the per-batch guard fails the lane's unaccounted batches with kind
        ``"lane"``.

        Returns a ``PoolOutcome``; the serving loop withdraws
        ``failed_rids()`` through ``StreamingState.withdraw`` and re-admits
        them under its retry budget."""
        return self._gather(
            schedule, prompt_fn, class_token_ids, until, on_dispatch,
            injector, window, timeout_s, supervised=True,
        )

    def _split(self, schedule: Schedule) -> dict[int, list[ScheduleEntry]]:
        """Entries per worker id (schedule order), lanes validated and the
        lane threads made."""
        by_worker: dict[int, list[ScheduleEntry]] = {}
        for e in schedule.sorted_entries():
            by_worker.setdefault(e.worker, []).append(e)
        unknown = set(by_worker) - set(self.lanes)
        if unknown:
            raise KeyError(f"schedule places work on unpooled workers {sorted(unknown)}")
        if self._tp is None:
            if self.lane == "serial":
                self._tp = _ImmediateExecutor()
            else:
                self._tp = ThreadPoolExecutor(max_workers=len(self.lanes))
        return by_worker

    def _gather(
        self,
        schedule: Schedule,
        prompt_fn: Callable[[Request], np.ndarray],
        class_token_ids,
        until: float | None,
        on_dispatch: Callable[[list[int]], None] | None,
        injector,
        window: int,
        timeout_s: float | None,
        supervised: bool,
    ) -> PoolOutcome:
        """The one dispatch loop of every public path: split the entries
        per worker, submit every lane, join them in ascending worker id,
        account ``wall_s`` once.

        ``supervised=False``: lanes run with no failure sink (exceptions
        propagate), there is no deadline, and the first failing lane's
        error is re-raised after every lane has been joined.
        ``supervised=True`` hands each lane a ``BatchFailure`` sink, turns
        a lane's exception into ``kind="lane"`` failures of its
        unaccounted batches, and records (then joins) the lanes that
        overrun the shared ``timeout_s`` deadline."""
        by_worker = self._split(schedule)
        failures_by: dict[int, list[BatchFailure]] = {wid: [] for wid in by_worker}
        t0 = time.perf_counter()
        # Ascending-wid submission keeps the serial lane's order
        # deterministic; the join below is sorted in any case.
        futures = {
            wid: self._tp.submit(
                self.lanes[wid].execute, by_worker[wid], prompt_fn,
                class_token_ids, until, on_dispatch,
                injector, window, failures_by[wid] if supervised else None,
            )
            for wid in sorted(by_worker)
        }
        reports: list[ExecutionReport] = []
        failures: list[BatchFailure] = []
        timed_out: list[int] = []
        errors: dict[int, BaseException] = {}
        deadline = None if timeout_s is None else t0 + timeout_s
        for wid in sorted(futures):
            lane_reports: list[ExecutionReport] = []
            try:
                if deadline is None:
                    lane_reports = futures[wid].result()
                else:
                    remaining = max(0.0, deadline - time.perf_counter())
                    try:
                        lane_reports = futures[wid].result(timeout=remaining)
                    except FuturesTimeout:
                        timed_out.append(wid)
                        lane_reports = futures[wid].result()  # joined anyway
            except BaseException as err:
                if not supervised:
                    errors[wid] = err  # re-raised below, once every lane joined
                elif isinstance(err, Exception):
                    # A lane failure outside the per-batch guard: every
                    # batch not already reported or failed goes down with it.
                    done = {rid for f in failures_by[wid] for rid in f.request_ids}
                    for rep in lane_reports:
                        done.update(rep.request_ids)
                    for bi, batch in enumerate(iter_entry_batches(
                            sorted(by_worker[wid], key=lambda e: e.order))):
                        rids = [e.request.rid for e in batch]
                        if not done.intersection(rids):
                            failures_by[wid].append(BatchFailure(
                                worker=wid, request_ids=rids, model=batch[0].model,
                                kind="lane", batch_index=bi, error=repr(err)))
                    lane_reports = []
                else:
                    raise
            reports.extend(lane_reports)
            failures.extend(failures_by[wid])
        self.wall_s += time.perf_counter() - t0
        if errors:
            raise errors[min(errors)]
        return PoolOutcome(reports=reports, failures=failures, timed_out=timed_out)


def iter_entry_batches(entries: Sequence[ScheduleEntry]):
    """Group an ordered entry list into dispatchable batches: maximal runs
    of consecutive entries sharing (batch_id >= 0, model) — the grouping
    rule ``evaluate`` replays with, so realised batches match the
    scheduler's batching decisions."""
    i = 0
    while i < len(entries):
        j = i
        while (
            j + 1 < len(entries)
            and entries[j + 1].batch_id == entries[i].batch_id
            and entries[i].batch_id >= 0
            and entries[j + 1].model == entries[i].model
        ):
            j += 1
        yield entries[i : j + 1]
        i = j + 1
