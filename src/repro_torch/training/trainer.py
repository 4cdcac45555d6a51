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
Shardings are the port's distribution, ROADMAP item 13.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import TransformerParams
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.checkpoint import DISTRIBUTION_ITEM
from repro_torch.training.optimizer import OptimizerConfig, init_opt_state

__all__ = ["TrainerConfig", "Trainer"]


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
        if shardings is not None:
            raise NotImplementedError(
                "Trainer(shardings=...) is not ported to repro_torch yet: see ROADMAP.md, "
                f"'Modules to port', {DISTRIBUTION_ITEM}")
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

        from repro_torch.launch.steps import make_train_step  # lazy: avoids import cycle

        self._step = make_train_step(model, self.opt_cfg)

    # ------------------------------------------------------------ state

    def init_state(self, seed: int = 0):
        params = self.model.init(seed, device=self.device)
        opt_state = init_opt_state(params.to_tree(), self.opt_cfg)
        return params, opt_state

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
        state, _ = ckpt.restore(self.cfg.checkpoint_dir, step, device=self.device)
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
            if self._preempted:
                self._save(step - 1, params, opt_state)
                break
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                params, opt_state, metrics = self._step(params, opt_state, self._batch(step))
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {step}: {loss}")
                dt = time.perf_counter() - t0
                if self.cfg.step_timeout_s and dt > self.cfg.step_timeout_s:
                    raise TimeoutError(
                        f"step {step} exceeded {self.cfg.step_timeout_s}s ({dt:.1f}s)")
            except Exception as e:  # noqa: BLE001 — the restart path IS the feature
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
