"""Fault-tolerant training loop, the counterpart of
``repro.training.trainer``.

The reference's behaviours, on the port's models:

  * checkpoint/restart: atomic checkpoints every N steps; on ANY step
    failure the trainer restores the latest committed checkpoint and
    continues (bounded retries);
  * preemption handling: SIGTERM triggers checkpoint-then-stop;
  * straggler accounting: steps slower than ``straggler_factor x`` the
    running median are counted; a ``step_timeout_s`` turns a slow step
    into a failure, so the restart path covers it too;
  * data determinism: batches are a pure function of step, so restarts
    never replay or skip data.

The weights are a ``TransformerParams`` on ``device`` (the card unless
``"cpu"`` is named), trained in place by ``launch.steps.make_train_step``;
the checkpoints hold ``{"params", "opt"}`` in the reference's stacked
layout, so either package resumes the other's.  ``donate`` is accepted
for the reference's signature: the port always updates in place.

``shardings`` = (param shardings, opt-state shardings), trees of
``distributed.sharding.NamedSharding`` over a ``DeviceMesh`` that spans
the world (``distributed.sharding.named_sharding_tree``): the weights and
AdamW's state are DTensors on them and each step is ``launch.steps.
make_sharded_train_step`` (ZeRO-3, ``distributed.fsdp``) under the mesh's
train policy (``make_policy(cfg, "train", mesh)``).  Every rank draws the
weights from the seed a leaf at a time and keeps its shards; checkpoints
hold the full arrays (rank 0 writes, every rank restores its shards).

With more than one rank, the ranks agree before each step, in one
all-reduce, on preemption and on a fault from ``fault_hook`` on any rank,
so all of them save and stop, or restore and retry, together.  A
non-finite loss and the step timeout are read from the world's loss and
slowest step, the same on every rank.  Any other failure inside a
sharded step is raised: its peers may wait in one of the step's
collectives, where no agreement can reach them, so the process ends and
the launcher (``launch.train``) starts every rank again from the last
checkpoint.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed import fsdp
from repro_torch.models.transformer import TransformerParams
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
from repro_torch.trees import tree_map

__all__ = ["TrainerConfig", "Trainer", "sharded_opt_state"]


def sharded_opt_state(model, params, o_sh, opt_cfg, device) -> dict:
    """AdamW's state of sharded weights ``params``, every leaf placed by
    ``o_sh``: the master copy the weights' own shards cast to
    ``master_dtype``, the moments zeros made shard by shard from the whole
    leaves' shapes (an int8 moment's scale may be whole on a dim its codes
    split: its spec is the codes' spec without the last entry)."""
    whole = init_opt_state(model.abstract_params(), opt_cfg)
    master = None
    if whole["master"] is not None:
        local = tree_map(lambda x: x.to_local().detach().to(opt_cfg.master_dtype, copy=True),
                         params.to_tree())
        master = fsdp.from_local_tree(local, o_sh["master"])
    return {"step": whole["step"], "master": master,
            **{k: fsdp.zeros_tree(whole[k], o_sh[k], device) for k in ("m", "v")}}


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    step_timeout_s: float | None = None
    log_every: int = 10


class Trainer:
    def __init__(
        self,
        model,
        dataset,
        opt_cfg: OptimizerConfig | None = None,
        cfg: TrainerConfig | None = None,
        shardings: tuple | None = None,  # (param_shardings, opt_shardings) or None
        donate: bool = True,
        fault_hook: Optional[Callable[[int], None]] = None,  # test fault injection
        *,
        device=None,
    ):
        self.model = model
        self.dataset = dataset
        self.opt_cfg = opt_cfg or OptimizerConfig()
        self.cfg = cfg or TrainerConfig()
        self.fault_hook = fault_hook
        self.device = resolve_device(device)
        self._preempted = False
        self.step_times: list[float] = []
        self.stragglers = 0
        self.restarts = 0
        self.metrics_log: list[dict] = []

        self.shardings = shardings
        # lazy: avoids an import cycle
        from repro_torch.launch.steps import make_sharded_train_step, make_train_step

        if shardings is None:
            self._step = make_train_step(model, self.opt_cfg)
        else:
            from repro_torch.distributed.policies import make_policy

            policy = make_policy(model.cfg, "train", fsdp.first_mesh(shardings[0]))
            self._step = make_sharded_train_step(model, self.opt_cfg, shardings, policy)
        # ranks that must agree on faults and preemption
        self._peers = shardings is not None and dist.get_world_size() > 1

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0):
        if self.shardings is None:
            params = self.model.init(seed, device=self.device)
            return params, init_opt_state(params.to_tree(), self.opt_cfg)
        p_sh, o_sh = self.shardings
        params = self.model.init(seed, device=self.device, shardings=p_sh)
        return params, sharded_opt_state(self.model, params, o_sh, self.opt_cfg, self.device)

    def _save(self, step, params, opt_state):
        ckpt.save(
            self.cfg.checkpoint_dir,
            step,
            {"params": params.to_tree(), "opt": opt_state},
            metadata={"step": step},
            keep=self.cfg.keep_checkpoints,
        )

    def _restore(self):
        step = ckpt.latest_step(self.cfg.checkpoint_dir)
        if step is None:
            return None
        shardings = None
        if self.shardings is not None:
            p_sh, o_sh = self.shardings
            shardings = {"params": p_sh, "opt": {**o_sh, "step": None}}
        state, _ = ckpt.restore(self.cfg.checkpoint_dir, step, shardings=shardings,
                                device=self.device)
        params = TransformerParams(self.model.cfg, state["params"])
        opt = state["opt"]
        opt["step"] = opt["step"].cpu()  # the step count lives on the host
        return step, params, opt

    # ------------------------------------------------------------ signals

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on main thread (tests)

    def _on_any_rank(self, *flags: bool) -> list[bool]:
        """Each flag as on this rank, or, with peers, on any rank of the world."""
        if not self._peers:
            return list(flags)
        t = torch.tensor([float(f) for f in flags], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return [bool(x) for x in t.tolist()]

    def _fault(self, step: int) -> Exception | None:
        """The exception ``fault_hook`` raised at ``step``, or None."""
        if self.fault_hook is None:
            return None
        try:
            self.fault_hook(step)
        except Exception as e:  # noqa: BLE001 — any fault takes the restart path
            return e
        return None

    def _slowest(self, dt: float) -> float:
        """``dt``, or, with peers, the largest step time of the world's ranks."""
        if not self._peers:
            return dt
        t = torch.tensor([dt], dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    # ------------------------------------------------------------ loop

    def _batch(self, step: int) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in self.dataset.batch_at(step).items()}

    def train(self, seed: int = 0, resume: bool = True):
        """Runs to total_steps (or preemption).  Returns final (step, params,
        opt_state, summary)."""
        self._install_sigterm()
        start_step = 0
        restored = self._restore() if resume else None
        if restored is not None:
            start_step, params, opt_state = restored
            start_step += 1
        else:
            params, opt_state = self.init_state(seed)
            if self.cfg.checkpoint_every:
                self._save(0, params, opt_state)

        step = start_step
        while step < self.cfg.total_steps:
            t0 = time.perf_counter()
            preempted = self._preempted
            fault = None if preempted and not self._peers else self._fault(step)
            preempted, failed = self._on_any_rank(preempted, fault is not None)
            if preempted:
                self._preempted = True
                self._save(step - 1, params, opt_state)
                break
            stepped = False
            try:
                if failed:
                    raise fault or RuntimeError(f"a fault on another rank at step {step}")
                params, opt_state, metrics = self._step(params, opt_state, self._batch(step))
                stepped = True
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                dt = self._slowest(time.perf_counter() - t0)
                if self.cfg.step_timeout_s and dt > self.cfg.step_timeout_s:
                    raise TimeoutError(
                        f"step {step} exceeded {self.cfg.step_timeout_s}s ({dt:.1f}s)")
            except Exception as e:  # noqa: BLE001 — the restart path IS the feature
                if self._peers and not failed and not stepped:
                    # This rank alone failed inside the step: its peers may
                    # wait in one of the step's collectives, beyond reach.
                    raise
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(f"exceeded max_restarts={self.cfg.max_restarts}") from e
                restored = self._restore()
                if restored is None:
                    params, opt_state = self.init_state(seed)
                    step = 0
                else:
                    ck_step, params, opt_state = restored
                    step = ck_step + 1
                continue

            # straggler accounting
            self.step_times.append(dt)
            med = float(np.median(self.step_times[-50:]))
            if len(self.step_times) > 5 and dt > self.cfg.straggler_factor * med:
                self.stragglers += 1

            if self.cfg.log_every and step % self.cfg.log_every == 0:
                self.metrics_log.append({"step": step, "loss": loss, "time_s": dt})
            if self.cfg.checkpoint_every and step > 0 and step % self.cfg.checkpoint_every == 0:
                self._save(step, params, opt_state)
            step += 1

        if not self._preempted:
            self._save(self.cfg.total_steps - 1, params, opt_state)
        summary = {
            "final_step": step - 1,
            "restarts": self.restarts,
            "stragglers": self.stragglers,
            "preempted": self._preempted,
            "losses": [m["loss"] for m in self.metrics_log],
        }
        return step - 1, params, opt_state, summary
