"""Class-decomposed model accuracy (paper Eq. 7-9).

The key analytical observation of the paper: for a classifier evaluated
via a confusion matrix Z = [z_ij] (rows = true class, cols = predicted),

    Accuracy(m) = tr(Z) / sum(Z)                                   (Eq. 7)
                = sum_i  theta_i * recall_i(m)                     (Eq. 9)

where theta_i is the *frequency of class i in the test set* and
recall_i(m) = z_ii / sum_j z_ij depends only on the model.  Profiled
accuracy therefore silently bakes in the test-set label distribution;
SneakPeek replaces theta with a per-request posterior estimate
(see ``core.dirichlet``).

Everything here is plain numpy: model profiles are host-side
bookkeeping.  The batched form of Eq. 9 over a whole window runs on the
device in ``repro_torch.core.fastpath``.
"""
from __future__ import annotations

import dataclasses
import numpy as np

__all__ = [
    "ModelProfile",
    "accuracy_from_confusion",
    "recalls_from_confusion",
    "class_frequencies_from_confusion",
    "expected_accuracy",
    "confusion_with_accuracy",
]


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Registered profile for one model variant (paper §II-B, §III-B).

    Attributes:
      name: variant identifier, unique within an application.
      recalls: per-class recall vector ``recall_i(m)``, shape ``(num_classes,)``.
        This is the per-target-label accuracy measurement the paper requires
        in model profiles ("accuracy measurements for every possible target
        label", §III-B).
      latency_s: profiled inference latency l(m) in seconds for a single
        request. Batch scaling is handled by ``latency_model`` when given.
      load_latency_s: latency to swap the model's weights into accelerator
        memory when it is not resident (context-switch cost in Eq. 1).
      memory_bytes: accelerator memory footprint of the resident weights.
      latency_model: optional (fixed_s, per_item_s) affine batch-latency
        model: ``l(m, b) = fixed_s + per_item_s * b``.  ``latency_s`` must
        equal ``fixed_s + per_item_s`` (b=1) when provided.
      is_short_circuit: True when this profile wraps a SneakPeek model used
        for short-circuit inference (§V-C1): zero marginal latency, and the
        scheduler must use its *profiled* accuracy (never data-sharpened).
      provenance: where the latency/memory numbers come from —
        ``"profiled"`` (stopwatch/asserted constants, the default),
        ``"costmodel"`` (roofline-derived, ``serving.profiles``), or
        ``"realized"`` (fit from executed batches,
        ``serving.backends.CompiledBackend``).  The drift correction
        (``realized_over_profiled``) reports which estimate it corrects.
    """

    name: str
    recalls: np.ndarray
    latency_s: float
    load_latency_s: float = 0.0
    memory_bytes: int = 0
    latency_model: tuple[float, float] | None = None
    is_short_circuit: bool = False
    provenance: str = "profiled"

    def __post_init__(self):
        object.__setattr__(self, "recalls", np.asarray(self.recalls, dtype=np.float64))
        if self.recalls.ndim != 1:
            raise ValueError(f"recalls must be 1-D, got shape {self.recalls.shape}")
        if np.any(self.recalls < 0) or np.any(self.recalls > 1):
            raise ValueError("recalls must lie in [0, 1]")
        if self.latency_s < 0 or self.load_latency_s < 0:
            raise ValueError("latencies must be non-negative")
        if self.provenance not in ("profiled", "costmodel", "realized"):
            raise ValueError(
                f"provenance must be profiled|costmodel|realized, got {self.provenance!r}")

    @property
    def num_classes(self) -> int:
        """Number of classes |C| (length of the recall vector)."""
        return int(self.recalls.shape[0])

    def profiled_accuracy(self, test_theta: np.ndarray | None = None) -> float:
        """Eq. 9 with theta fixed to the (test-set) class frequencies.

        With ``test_theta=None`` a uniform class distribution is assumed,
        mirroring a uniformly-sampled test split.
        """
        if test_theta is None:
            test_theta = np.full(self.num_classes, 1.0 / self.num_classes)
        return expected_accuracy(self.recalls, test_theta)

    def latency(self, batch_size: int = 1) -> float:
        """l(m, b): expected execution latency for a batch of ``batch_size``."""
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if self.latency_model is None:
            # Paper default: per-request profiled latency; a batch of b
            # back-to-back requests on the same resident model costs b*l(m).
            return self.latency_s * batch_size
        fixed, per_item = self.latency_model
        return fixed + per_item * batch_size


def recalls_from_confusion(confusion: np.ndarray) -> np.ndarray:
    """Per-class recall ``z_ii / sum_j z_ij`` (the model-dependent term of Eq. 9)."""
    z = np.asarray(confusion, dtype=np.float64)
    if z.ndim != 2 or z.shape[0] != z.shape[1]:
        raise ValueError(f"confusion must be square, got {z.shape}")
    row_sums = z.sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        rec = np.where(row_sums > 0, np.diag(z) / np.maximum(row_sums, 1e-300), 0.0)
    return rec


def class_frequencies_from_confusion(confusion: np.ndarray) -> np.ndarray:
    """theta_i: empirical class frequencies of the profiling test set (Eq. 9)."""
    z = np.asarray(confusion, dtype=np.float64)
    total = z.sum()
    if total <= 0:
        raise ValueError("confusion matrix is empty")
    return z.sum(axis=1) / total


def accuracy_from_confusion(confusion: np.ndarray) -> float:
    """Eq. 7: tr(Z) / sum(Z)."""
    z = np.asarray(confusion, dtype=np.float64)
    return float(np.trace(z) / z.sum())


def expected_accuracy(recalls: np.ndarray, theta: np.ndarray) -> float:
    """Eq. 9: Accuracy(m | theta) = sum_i theta_i * recall_i(m).

    ``theta`` may be any distribution over classes — the test-set
    frequencies (recovering profiled accuracy), a SneakPeek posterior
    mean, or a one-hot "true" distribution (the paper's oracle target in
    Fig. 6).
    """
    recalls = np.asarray(recalls, dtype=np.float64)
    theta = np.asarray(theta, dtype=np.float64)
    if recalls.shape != theta.shape:
        raise ValueError(f"shape mismatch: recalls {recalls.shape} vs theta {theta.shape}")
    return float(recalls @ theta)


def confusion_with_accuracy(
    num_classes: int,
    accuracy: float,
    rng: np.random.Generator | None = None,
    per_class_jitter: float = 0.0,
    rows: int = 1000,
) -> np.ndarray:
    """Build a synthetic confusion matrix with a specified overall accuracy.

    Used by the paper's Fig. 8 ("required accuracy") and Fig. 14 ("model
    heterogeneity") experiments: diagonal mass = target accuracy, errors
    spread uniformly over the off-diagonal entries of each row, optionally
    jittered per class while preserving the mean.
    """
    if not 0.0 <= accuracy <= 1.0:
        raise ValueError("accuracy must be in [0, 1]")
    rng = rng or np.random.default_rng(0)
    diag = np.full(num_classes, accuracy)
    if per_class_jitter > 0 and num_classes > 1:
        noise = rng.uniform(-per_class_jitter, per_class_jitter, size=num_classes)
        noise -= noise.mean()  # preserve the mean accuracy
        diag = np.clip(diag + noise, 0.0, 1.0)
    z = np.zeros((num_classes, num_classes))
    for i in range(num_classes):
        z[i, i] = diag[i] * rows
        if num_classes > 1:
            off = (1.0 - diag[i]) * rows / (num_classes - 1)
            for j in range(num_classes):
                if j != i:
                    z[i, j] = off
    return z
