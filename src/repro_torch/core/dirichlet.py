"""Dirichlet-Multinomial estimation of class frequencies (paper Eq. 10-11).

SneakPeek treats the class-frequency vector theta as a *parameter* and
estimates it per request:

    prior:      theta ~ Dirichlet(alpha_1, ..., alpha_|c|)          (Eq. 10)
    evidence:   y = multinomial counts from a SneakPeek model
                (k-NN votes over the training set, or a decision-rule
                 one-hot — the "low-information" variant)
    posterior:  theta | y ~ Dirichlet(alpha + y)                    (Eq. 11)

The posterior *mean* E[theta_i | y] = (alpha_i + y_i) / sum(alpha + y)
is the SneakPeek probability vector plugged into Eq. 9.

Priors (paper §VI-C3):
  * uninformative      — Jeffreys, alpha_i = 0.5
  * weakly informative — alpha_i = expected frequency of label i (sums to 1)
  * strongly informative — alpha_i = expected #requests with label i per
    scheduling window (same shape, much larger mass; the paper shows this
    suppresses the data signal and degrades estimates)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.ordered import row_sum

__all__ = [
    "DirichletPrior",
    "jeffreys_prior",
    "weakly_informative_prior",
    "strongly_informative_prior",
    "posterior",
    "posterior_mean",
    "posterior_mean_batch",
    "posterior_variance",
]


@dataclasses.dataclass(frozen=True)
class DirichletPrior:
    """A Dirichlet prior over class frequencies."""

    alpha: np.ndarray
    name: str = "custom"

    def __post_init__(self):
        object.__setattr__(self, "alpha", np.asarray(self.alpha, dtype=np.float64))
        if self.alpha.ndim != 1:
            raise ValueError("alpha must be 1-D")
        if np.any(self.alpha <= 0):
            raise ValueError("Dirichlet concentration parameters must be positive")

    @property
    def num_classes(self) -> int:
        """Number of classes |C| (length of the concentration vector)."""
        return int(self.alpha.shape[0])

    @property
    def mean(self) -> np.ndarray:
        """E[theta] = alpha / sum(alpha)."""
        return self.alpha / self.alpha.sum()


def jeffreys_prior(num_classes: int) -> DirichletPrior:
    """Uninformative (Jeffreys) prior: alpha_i = 1/2."""
    return DirichletPrior(np.full(num_classes, 0.5), name="uninformative")


def weakly_informative_prior(expected_freqs: np.ndarray) -> DirichletPrior:
    """alpha_i = expected frequency of label i (total mass 1 -> weak)."""
    f = np.asarray(expected_freqs, dtype=np.float64)
    if not np.isclose(f.sum(), 1.0, atol=1e-6):
        raise ValueError("expected_freqs must sum to 1")
    # Clip away exact zeros: Dirichlet requires alpha > 0.
    return DirichletPrior(np.maximum(f, 1e-6), name="weakly_informative")


def strongly_informative_prior(
    expected_freqs: np.ndarray, requests_per_window: int
) -> DirichletPrior:
    """alpha_i = expected number of requests with label i in a window."""
    f = np.asarray(expected_freqs, dtype=np.float64)
    if not np.isclose(f.sum(), 1.0, atol=1e-6):
        raise ValueError("expected_freqs must sum to 1")
    if requests_per_window <= 0:
        raise ValueError("requests_per_window must be positive")
    return DirichletPrior(
        np.maximum(f * float(requests_per_window), 1e-6), name="strongly_informative"
    )


def posterior(prior: DirichletPrior, evidence: np.ndarray) -> DirichletPrior:
    """Eq. 11: conjugate update theta | y ~ Dirichlet(alpha + y)."""
    y = np.asarray(evidence, dtype=np.float64)
    if y.shape != prior.alpha.shape:
        raise ValueError(f"evidence shape {y.shape} != prior shape {prior.alpha.shape}")
    if np.any(y < 0):
        raise ValueError("evidence counts must be non-negative")
    return DirichletPrior(prior.alpha + y, name=f"{prior.name}+evidence")


def posterior_mean(prior: DirichletPrior, evidence: np.ndarray) -> np.ndarray:
    """E[theta | y]: the SneakPeek probability vector (Def. 4.1.2)."""
    post = posterior(prior, evidence)
    return post.mean


def posterior_mean_batch(prior: DirichletPrior, evidence: torch.Tensor) -> torch.Tensor:
    """Eq. 11 posterior means for a whole window of evidence rows.

    ``evidence`` is an (R, C) float64 tensor of multinomial counts, one
    row per request, on the device the window runs on; returns the
    (R, C) posterior means there.  The row total is summed in numpy's
    order (``ordered.row_sum``), so each row is bit-identical to the
    reference's ``posterior_mean(prior, evidence[i])``.
    """
    if evidence.ndim != 2:
        raise ValueError(f"evidence must be (R, C), got shape {tuple(evidence.shape)}")
    if evidence.shape[1] != prior.alpha.shape[0]:
        raise ValueError(
            f"evidence has {evidence.shape[1]} classes, prior has {prior.alpha.shape[0]}"
        )
    if evidence.dtype != torch.float64:
        raise TypeError(f"evidence must be float64, got {evidence.dtype}")
    if bool((evidence < 0).any()):
        raise ValueError("evidence counts must be non-negative")
    alpha = torch.as_tensor(prior.alpha, dtype=torch.float64, device=evidence.device)
    a = alpha[None, :] + evidence
    return a / row_sum(a.unbind(1))[:, None]


def posterior_variance(prior: DirichletPrior, evidence: np.ndarray) -> np.ndarray:
    """Var[theta_i | y] — used for diagnostics / confidence gating."""
    post = posterior(prior, evidence)
    a = post.alpha
    a0 = a.sum()
    return a * (a0 - a) / (a0 * a0 * (a0 + 1.0))
