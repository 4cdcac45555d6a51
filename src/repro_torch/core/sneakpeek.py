"""SneakPeek models (paper §IV, Definitions 4.1.1-4.1.2).

A SneakPeek model maps a request's raw features to *multinomial evidence*
``y`` over the class labels; the Dirichlet posterior mean (Eq. 11) is the
SneakPeek probability vector used to sharpen Eq. 9 accuracies.

Implementations:

  * ``KNNSneakPeek`` — the paper's primary mechanism: k nearest neighbors
    in the training set vote (e.g. k=5, two "no fall" + three "fall" ->
    y = <2, 3>).  The training set lives on the device from construction
    on; the distance/top-k search is the CUDA kernel
    (``repro_torch.kernels.knn``) for a CUDA device and its plain PyTorch
    version for ``device="cpu"``.
  * ``DecisionRuleSneakPeek`` — the "low-information" one-hot alternative
    discussed in §IV-B.
  * ``ConfusionSneakPeek`` — the synthetic model of Fig. 8: given a target
    accuracy, evidence is drawn from the true-label row of a synthetic
    confusion matrix (used to ask "how accurate must SneakPeek models be?").

Each SneakPeek model can also act as a *short-circuit* variant (§V-C1):
``predict`` returns a label directly, and ``profile`` wraps it in a
zero-latency ModelProfile whose accuracy stays profiled.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import (
    ModelProfile,
    confusion_with_accuracy,
    recalls_from_confusion,
)
from repro_torch.core.dirichlet import posterior_mean_batch
from repro_torch.device import KNN_DTYPE, SCHED_DTYPE, resolve_device
from repro_torch.kernels.knn import ops as knn_ops

__all__ = [
    "SneakPeekModel",
    "KNNSneakPeek",
    "knn_device",
    "DecisionRuleSneakPeek",
    "ConfusionSneakPeek",
    "ingest_window",
    "attach_sneakpeek",
]


class SneakPeekModel:
    """Interface: evidence(features) -> multinomial counts over classes."""

    num_classes: int
    name: str = "sneakpeek"

    def evidence(self, features: np.ndarray, true_label: int | None = None) -> np.ndarray:
        """Multinomial evidence counts y for one request (Eq. 11 input)."""
        raise NotImplementedError

    def evidence_batch(
        self, features: np.ndarray, true_labels: Sequence[int | None] | None = None
    ) -> np.ndarray:
        """(B, num_classes) evidence for a whole window's feature batch.

        The default loops over ``evidence`` row by row (same draws, same
        order); implementations override with a genuinely batched compute
        (k-NN kernel tiles, one vectorized multinomial draw, ...).
        """
        feats = np.atleast_2d(np.asarray(features))
        labels = true_labels if true_labels is not None else [None] * len(feats)
        return np.stack([self.evidence(f, t) for f, t in zip(feats, labels)])

    def predict(self, features: np.ndarray, true_label: int | None = None) -> int:
        """Short-circuit prediction: majority class of the evidence."""
        return int(np.argmax(self.evidence(features, true_label)))

    def measured_recalls(self) -> np.ndarray:
        """Per-class recall of ``predict`` measured on held-out data.

        Subclasses override with their own measurement; default assumes
        uniform moderate quality (used only when no holdout exists).
        """
        return np.full(self.num_classes, 0.7)

    def profile(self, latency_s: float = 0.0) -> ModelProfile:
        """Wrap as a zero-latency short-circuit candidate (§V-C1)."""
        return ModelProfile(
            name=f"{self.name}:short_circuit",
            recalls=self.measured_recalls(),
            latency_s=latency_s,
            load_latency_s=0.0,
            is_short_circuit=True,
        )


def knn_device(backend: str, device=None) -> torch.device:
    """The device a k-NN SneakPeek model runs on, from the reference's
    ``backend`` value and the port's ``device``.  Each value names one
    route of the port, and a value that asks for a route ``device`` does
    not give raises (no fallback):

      * ``"auto"``  — the route of ``device``: the CUDA kernel on the
        card, its plain version for ``device="cpu"``;
      * ``"jax"``   — the kernel route (the reference's Pallas kernel):
        ``device`` must resolve to CUDA;
      * ``"numpy"`` — the plain version on the host (the reference's
        numpy search): ``device`` must be ``"cpu"``.
    """
    if backend not in ("auto", "jax", "numpy"):
        raise ValueError(f"unknown k-NN backend {backend!r}")
    dev = resolve_device(device)
    if backend == "jax" and dev.type != "cuda":
        raise ValueError("backend='jax' asks for the k-NN kernel, which runs on CUDA; "
                         f"device is {dev}")
    if backend == "numpy" and dev.type != "cpu":
        raise ValueError("backend='numpy' asks for the plain k-NN version on the host; "
                         f"device is {dev} (pass device='cpu')")
    return dev


class KNNSneakPeek(SneakPeekModel):
    """k-NN vote evidence against the (sub-sampled) training set.

    The training rows, their squared norms and labels are copied to
    ``device`` once, here; every window's queries go to the k-NN kernel
    against them.  The holdout split is the reference's (same seed, same
    permutation).  ``backend`` takes the reference's values, each mapped
    to one route of the port by ``knn_device``.
    """

    def __init__(
        self,
        train_x: np.ndarray,
        train_y: np.ndarray,
        num_classes: int,
        k: int = 5,
        name: str = "knn",
        backend: str = "auto",
        holdout_frac: float = 0.2,
        seed: int = 0,
        *,
        device=None,
    ):
        train_x = np.asarray(train_x, dtype=np.float32)
        train_y = np.asarray(train_y, dtype=np.int32)
        if train_x.ndim != 2 or train_y.ndim != 1 or len(train_x) != len(train_y):
            raise ValueError("train_x must be (N, D), train_y (N,)")
        # Hold out a slice for measuring the short-circuit recalls.
        rng = np.random.default_rng(seed)
        n = len(train_x)
        perm = rng.permutation(n)
        n_hold = max(int(num_classes), int(n * holdout_frac))
        self.backend = backend
        self._setup(
            train_x[perm[n_hold:]], train_y[perm[n_hold:]],
            train_x[perm[:n_hold]], train_y[perm[:n_hold]],
            num_classes, k, name, knn_device(backend, device),
        )

    @classmethod
    def from_split(cls, train_x, train_y, hold_x, hold_y, num_classes: int,
                   k: int = 5, name: str = "knn", device=None) -> "KNNSneakPeek":
        """A model over an existing (training, holdout) split, as given."""
        out = cls.__new__(cls)
        out.backend = "auto"
        out._setup(
            np.asarray(train_x, dtype=np.float32), np.asarray(train_y, dtype=np.int32),
            np.asarray(hold_x, dtype=np.float32), np.asarray(hold_y, dtype=np.int32),
            num_classes, k, name, device,
        )
        return out

    def _setup(self, train_x, train_y, hold_x, hold_y, num_classes, k, name, device):
        if k < 1:
            raise ValueError("k must be >= 1")
        if len(train_x) < k:
            raise ValueError(f"k={k} exceeds the {len(train_x)} training points")
        self.num_classes = int(num_classes)
        self.k = int(k)
        self.name = name
        self.device = resolve_device(device)
        self._hold_x, self._hold_y = hold_x, hold_y
        self.train_x, self.train_y = train_x, train_y
        self._x = torch.from_numpy(np.ascontiguousarray(train_x)).to(self.device)
        self._y = torch.from_numpy(np.ascontiguousarray(train_y)).to(self.device)
        self._xn = (self._x * self._x).sum(dim=1)  # |x|^2, once per model
        self._recalls_cache: np.ndarray | None = None

    # -- evidence ----------------------------------------------------------
    def votes(self, queries) -> torch.Tensor:
        """(B, num_classes) float64 vote counts on the model's device."""
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, dtype=np.float32)))
        q = q.to(device=self.device, dtype=KNN_DTYPE).contiguous()
        return knn_ops.knn_class_votes(q, self._x, self._xn, self._y, self.k,
                                       self.num_classes)

    def evidence(self, features: np.ndarray, true_label: int | None = None) -> np.ndarray:
        """k-NN vote counts for one request's features."""
        return self.votes(features)[0].cpu().numpy()

    def evidence_batch(
        self, features: np.ndarray, true_labels: Sequence[int | None] | None = None
    ) -> torch.Tensor:
        """One batched k-NN vote tile for the whole window, on the device."""
        return self.votes(features)

    def measured_recalls(self) -> np.ndarray:
        """Held-out per-class recall of the k-NN majority vote (cached)."""
        if self._recalls_cache is None:
            votes = self.votes(self._hold_x).cpu().numpy()
            preds = votes.argmax(axis=1)
            rec = np.zeros(self.num_classes)
            for c in range(self.num_classes):
                mask = self._hold_y == c
                rec[c] = (preds[mask] == c).mean() if mask.any() else 0.5
            self._recalls_cache = rec
        return self._recalls_cache


class DecisionRuleSneakPeek(SneakPeekModel):
    """One-hot evidence from an arbitrary classifier's decision rule (§IV-B).

    Low-information update: the full evidence weight k lands on a single
    predicted class, amplifying errors when the prediction is wrong.
    """

    def __init__(self, base: SneakPeekModel, weight: int = 5, name: str | None = None):
        self.base = base
        self.weight = int(weight)
        self.num_classes = base.num_classes
        self.name = name or f"{base.name}:decision_rule"

    def evidence(self, features: np.ndarray, true_label: int | None = None) -> np.ndarray:
        """One-hot evidence: full weight on the base model's prediction."""
        pred = self.base.predict(features, true_label)
        y = np.zeros(self.num_classes)
        y[pred] = self.weight
        return y

    def measured_recalls(self) -> np.ndarray:
        """Recalls of the underlying base model (the rule adds no skill)."""
        return self.base.measured_recalls()


class ConfusionSneakPeek(SneakPeekModel):
    """Synthetic SneakPeek model with controlled accuracy (paper Fig. 8).

    Evidence for a data point with true label t is a multinomial draw of k
    votes from row t of a confusion matrix with the requested accuracy
    (errors uniform over the other classes).
    """

    def __init__(
        self,
        num_classes: int,
        accuracy: float,
        k: int = 5,
        seed: int = 0,
        name: str | None = None,
    ):
        self.num_classes = int(num_classes)
        self.accuracy = float(accuracy)
        self.k = int(k)
        self.rng = np.random.default_rng(seed)
        self.name = name or f"confusion@{accuracy:.2f}"
        z = confusion_with_accuracy(num_classes, accuracy)
        self._rows = z / z.sum(axis=1, keepdims=True)

    def evidence(self, features: np.ndarray, true_label: int | None = None) -> np.ndarray:
        """k votes drawn from the true label's confusion-matrix row."""
        if true_label is None:
            raise ValueError("ConfusionSneakPeek requires the true label")
        return self.rng.multinomial(self.k, self._rows[true_label]).astype(np.float64)

    def evidence_batch(
        self, features: np.ndarray, true_labels: Sequence[int | None] | None = None
    ) -> np.ndarray:
        """One vectorized multinomial draw for the whole batch.

        numpy's Generator draws batched multinomials row by row from the
        same stream, so this consumes the RNG exactly like ``evidence``
        called once per request in batch order — the batched ingest and
        the scalar path agree under a fixed seed.
        """
        if true_labels is None or any(t is None for t in true_labels):
            raise ValueError("ConfusionSneakPeek requires the true labels")
        labels = np.asarray(list(true_labels), dtype=np.int64)
        return self.rng.multinomial(self.k, self._rows[labels]).astype(np.float64)

    def measured_recalls(self) -> np.ndarray:
        """Per-class recall of the synthetic confusion matrix."""
        return recalls_from_confusion(self._rows)


def ingest_window(
    requests,
    apps,
    sneakpeeks: dict[str, SneakPeekModel],
    device=None,
) -> None:
    """Batched SneakPeek stage: fill request.evidence and request.theta.

    One SneakPeek inference per request updates the accuracy estimate for
    *every* variant of its application (the paper's single-inference
    amortization, §IV-B).  The window is partitioned per application and
    each partition runs as ONE batched evidence compute (k-NN kernel tile
    or vectorized multinomial) followed by ONE batched Dirichlet update
    (Eq. 11) on ``device``, preserving within-app request order so
    stochastic evidence models draw exactly as the per-request loop
    would.  The rows come back to the host once per application.
    Requests of applications without a SneakPeek model are left untouched
    (they fall back to profiled accuracy), and so are requests that
    already carry evidence: the SneakPeek draw happens ONCE per request.
    """
    dev = resolve_device(device)
    by_app: dict[str, list[int]] = {}
    for i, r in enumerate(requests):
        if r.evidence is None and sneakpeeks.get(r.app) is not None:
            by_app.setdefault(r.app, []).append(i)
    for app_name, idxs in by_app.items():
        sp = sneakpeeks[app_name]
        if any(requests[i].features is None for i in idxs):
            # Feature-free evidence models (ConfusionSneakPeek) ignore this;
            # feature-based ones fail on the shape mismatch, as they should.
            feats = np.zeros((len(idxs), 0), dtype=np.float32)
        else:
            feats = np.stack([np.asarray(requests[i].features) for i in idxs])
        labels = [requests[i].true_label for i in idxs]
        ev = torch.as_tensor(sp.evidence_batch(feats, labels))
        ev = ev.to(device=dev, dtype=SCHED_DTYPE)
        theta = posterior_mean_batch(apps[app_name].prior, ev).cpu().numpy()
        evidence = ev.cpu().numpy()
        for row, i in enumerate(idxs):
            requests[i].evidence = evidence[row]
            requests[i].theta = theta[row]


def attach_sneakpeek(
    requests,
    apps,
    sneakpeeks: dict[str, SneakPeekModel],
    device=None,
) -> None:
    """Run the SneakPeek stage (delegates to the batched ``ingest_window``)."""
    ingest_window(requests, apps, sneakpeeks, device=device)
