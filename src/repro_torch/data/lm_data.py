"""Deterministic synthetic LM token pipeline (stateless, resumable).

The port's copy of ``repro.data.lm_data``: numpy only, so ``batch_at``
is bit-equal to the reference's for every step, host slice and kind.
The trainer moves each batch to its device.

``batch_at(step)`` is a pure function of (seed, step) — resuming from a
checkpoint needs no data-loader state, and every data-parallel host can
slice its shard of the global batch deterministically (host sharding is
a range over the batch dim).

Two stream kinds:
  * "uniform": iid tokens (loss floor = ln(vocab)) — throughput tests.
  * "markov":  a seeded order-1 Markov chain with sparse transitions — a
    learnable distribution, so smoke trainings show decreasing loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LMDataConfig", "LMDataset"]


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    kind: str = "markov"  # uniform | markov
    branching: int = 4  # out-degree of the markov chain
    seed: int = 0


class LMDataset:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        if cfg.kind == "markov":
            rng = np.random.default_rng(cfg.seed ^ 0xC0FFEE)
            v, k = cfg.vocab_size, min(cfg.branching, cfg.vocab_size)
            self._succ = rng.integers(0, v, size=(v, k), dtype=np.int32)
        elif cfg.kind != "uniform":
            raise ValueError(cfg.kind)

    def batch_at(self, step: int, host_index: int = 0, host_count: int = 1) -> dict:
        """{"tokens": (B_host, S+1) int32} for this host's slice of ``step``."""
        cfg = self.cfg
        if cfg.global_batch % host_count:
            raise ValueError("global_batch must divide host_count")
        b_host = cfg.global_batch // host_count
        rng = np.random.default_rng((cfg.seed, step, host_index))
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab_size, size=(b_host, cfg.seq_len + 1), dtype=np.int32)
            return {"tokens": toks}
        # markov walk
        toks = np.empty((b_host, cfg.seq_len + 1), dtype=np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b_host)
        choices = rng.integers(0, self._succ.shape[1], size=(b_host, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self._succ[toks[:, t], choices[:, t]]
        return {"tokens": toks}

    def entropy_floor(self) -> float:
        """Theoretical loss floor (nats/token) of the stream."""
        if self.cfg.kind == "uniform":
            return float(np.log(self.cfg.vocab_size))
        return float(np.log(min(self.cfg.branching, self.cfg.vocab_size)))
