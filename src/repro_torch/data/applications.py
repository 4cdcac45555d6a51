"""Synthetic surrogates for the paper's three applications (Table I).

MMAct / Speech Commands / MIT-BIH are not available offline, so each
application is realized as:

  * a Gaussian-mixture feature generator with per-class separability
    tuned so k-NN SneakPeek models land in the paper's useful accuracy
    band (~70-95%),
  * a set of model variants as ModelProfiles with per-class recalls
    (synthetic confusion matrices spanning the paper's latency/accuracy
    trade-off — small/fast & less accurate .. large/slow & accurate),
  * the paper's streaming label distributions (§VI-A): fall detection
    95/5 negatives/positives, voice commands uniform over 6 classes,
    heart monitoring 80% normal + 20% uniform over 6 arrhythmia types.

Latencies follow the paper's regime (tens of ms per inference on the
profiled worker; the fusion model slowest & most accurate).

The port of ``repro.data.applications``: the same generators, seeds and
draws, so the arrays are byte-identical to the reference's; the k-NN
SneakPeek models keep their training sets on ``device``.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Sequence

import numpy as np

from repro_torch.core.accuracy import ModelProfile
from repro_torch.core.dirichlet import (
    DirichletPrior,
    jeffreys_prior,
    strongly_informative_prior,
    weakly_informative_prior,
)
from repro_torch.core.sneakpeek import KNNSneakPeek
from repro_torch.core.types import Application, Request


def _stable_hash(name: str) -> int:
    """Process-stable string hash (builtin hash() is salted per process)."""
    return zlib.crc32(name.encode())

__all__ = [
    "AppSpec",
    "APP_SPECS",
    "make_dataset",
    "make_application",
    "make_sneakpeek",
    "make_requests",
    "build_benchmark_suite",
]


@dataclasses.dataclass(frozen=True)
class AppSpec:
    """Static description of one synthetic application."""

    name: str
    num_classes: int
    stream_freqs: tuple[float, ...]  # label distribution of the live stream
    feature_dim: int
    class_sep: float  # Gaussian mean separation (controls k-NN quality)
    # (name, mean_recall, recall_spread, latency_s, load_latency_s, mem_mb)
    variants: tuple[tuple[str, float, float, float, float, int], ...]


def _fall_variants():
    # Paper: X3D small/medium/large (video), MiniRocket (ts), fusion.
    return (
        ("minirocket-ts", 0.82, 0.10, 0.008, 0.020, 20),
        ("x3d-s", 0.86, 0.08, 0.020, 0.060, 120),
        ("x3d-m", 0.90, 0.06, 0.035, 0.090, 240),
        ("x3d-l", 0.93, 0.05, 0.060, 0.150, 480),
        ("fusion", 0.96, 0.03, 0.080, 0.180, 600),
    )


def _voice_variants():
    # Paper: Howl framework with LSTM and MobileNet backends.
    return (
        ("howl-lstm", 0.85, 0.08, 0.012, 0.030, 40),
        ("howl-mobilenet", 0.92, 0.05, 0.030, 0.070, 160),
    )


def _ecg_variants():
    # Paper: EcgResNet34 and a CNN.
    return (
        ("ecg-cnn", 0.84, 0.10, 0.010, 0.025, 30),
        ("ecg-resnet34", 0.93, 0.05, 0.028, 0.080, 180),
    )


APP_SPECS: dict[str, AppSpec] = {
    "fall_detection": AppSpec(
        name="fall_detection",
        num_classes=2,
        stream_freqs=(0.95, 0.05),  # 95% no-fall, 5% fall (§VI-A)
        feature_dim=24,
        class_sep=2.4,
        variants=_fall_variants(),
    ),
    "voice_commands": AppSpec(
        name="voice_commands",
        num_classes=6,
        stream_freqs=tuple([1.0 / 6] * 6),  # uniform (§VI-A)
        feature_dim=32,
        class_sep=2.8,
        variants=_voice_variants(),
    ),
    "heart_monitoring": AppSpec(
        name="heart_monitoring",
        num_classes=7,
        stream_freqs=tuple([0.80] + [0.20 / 6] * 6),  # 80% normal (§VI-A)
        feature_dim=28,
        class_sep=2.6,
        variants=_ecg_variants(),
    ),
}


def _class_means(spec: AppSpec, rng: np.random.Generator) -> np.ndarray:
    """Well-separated random unit directions scaled by class_sep."""
    means = rng.normal(size=(spec.num_classes, spec.feature_dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    return means * spec.class_sep


def make_dataset(
    spec: AppSpec,
    n: int,
    rng: np.random.Generator,
    freqs: Sequence[float] | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample (features, labels) from the app's Gaussian mixture.

    ``freqs=None`` samples uniformly (the paper's test-set construction:
    "a uniform random sample from the entire dataset"); pass
    ``spec.stream_freqs`` for live-stream draws.
    """
    means = _class_means(spec, np.random.default_rng(_stable_hash(spec.name) % (2**32)))
    p = np.full(spec.num_classes, 1.0 / spec.num_classes) if freqs is None else np.asarray(freqs)
    labels = rng.choice(spec.num_classes, size=n, p=p / p.sum())
    feats = means[labels] + rng.normal(size=(n, spec.feature_dim))
    return feats.astype(np.float32), labels.astype(np.int32)


def _variant_recalls(
    spec: AppSpec, mean_recall: float, spread: float, rng: np.random.Generator
) -> np.ndarray:
    """Per-class recalls around the variant's mean — the class-dependent
    accuracy heterogeneity SneakPeek exploits (§IV-A: "some actions, such
    as walking and sitting, are easier for a model to distinguish").

    Class difficulty is a property of the DATA (shared across variants,
    seeded per app); weaker models suffer ~2x more on hard classes, so
    per-label model choice genuinely matters (the paper's premise)."""
    diff_rng = np.random.default_rng(_stable_hash(spec.name) % (2**31))
    difficulty = diff_rng.uniform(0.0, 1.0, size=spec.num_classes)
    # rare/critical classes are the harder ones (falls, arrhythmias)
    order = np.argsort(spec.stream_freqs)  # ascending frequency
    difficulty[order] += np.linspace(0.6, 0.0, spec.num_classes)
    weakness = 1.0 - mean_recall  # weak models feel difficulty more
    rec = (
        mean_recall
        - 2.2 * spread * difficulty * (0.5 + 2.0 * weakness)
        + rng.uniform(-0.02, 0.02, size=spec.num_classes)
    )
    return np.clip(rec, 0.05, 0.995)


def make_application(
    spec: AppSpec,
    penalty: str = "sigmoid",
    prior: str = "uninformative",
    requests_per_window: int = 4,
    seed: int = 0,
) -> Application:
    """Instantiate an Application with profiled variants and a prior (§VI-C3)."""
    rng = np.random.default_rng(seed + (_stable_hash(spec.name) % 1000))
    models = [
        ModelProfile(
            name=name,
            recalls=_variant_recalls(spec, mr, spread, rng),
            latency_s=lat,
            load_latency_s=load,
            memory_bytes=mem_mb * 2**20,
            # Paper-faithful latency: l(m, b) = b * l(m) — batching saves the
            # swap, not per-item compute (the paper profiles per-request
            # latency).
            latency_model=None,
        )
        for (name, mr, spread, lat, load, mem_mb) in spec.variants
    ]
    freqs = np.asarray(spec.stream_freqs)
    if prior == "uninformative":
        pr: DirichletPrior = jeffreys_prior(spec.num_classes)
    elif prior == "weak":
        pr = weakly_informative_prior(freqs)
    elif prior == "strong":
        pr = strongly_informative_prior(freqs, requests_per_window)
    elif prior == "weak_test":  # prior reflecting the (uniform) test set, Fig. 9b
        pr = weakly_informative_prior(np.full(spec.num_classes, 1.0 / spec.num_classes))
    elif prior == "strong_test":
        pr = strongly_informative_prior(
            np.full(spec.num_classes, 1.0 / spec.num_classes), requests_per_window
        )
    else:
        raise ValueError(f"unknown prior {prior!r}")
    return Application(
        name=spec.name,
        models=models,
        penalty=penalty,
        prior=pr,
        expected_freqs=freqs,
    )


def make_sneakpeek(
    spec: AppSpec, k: int = 5, train_n: int = 600, seed: int = 0, backend: str = "auto",
    *, device=None,
) -> KNNSneakPeek:
    """Train-set-backed k-NN SneakPeek model for the application, its
    training set on ``device`` (the card unless ``"cpu"`` is named).
    ``backend`` maps to one route of the port as
    ``core.sneakpeek.knn_device`` states ("auto": ``device``'s route,
    "jax": the CUDA kernel, "numpy": the plain version on the CPU)."""
    rng = np.random.default_rng(seed + 17)
    x, y = make_dataset(spec, train_n, rng)  # uniform training draw
    return KNNSneakPeek(x, y, spec.num_classes, k=k, name=f"{spec.name}-knn",
                        backend=backend, device=device)


def make_requests(
    specs: Sequence[AppSpec],
    per_app: int,
    window_s: float = 0.1,
    mean_deadline_s: float = 0.15,
    deadline_std_s: float = 0.0,
    seed: int = 0,
    start_rid: int = 0,
) -> list[Request]:
    """Generate one scheduling window of requests (paper default: 12 requests,
    4 per app, uniform arrivals over 100 ms, deadline ~150 ms after arrival)."""
    rng = np.random.default_rng(seed)
    requests: list[Request] = []
    rid = start_rid
    for spec in specs:
        feats, labels = make_dataset(spec, per_app, rng, freqs=spec.stream_freqs)
        arrivals = np.sort(rng.uniform(0.0, window_s, size=per_app))
        for i in range(per_app):
            dl = mean_deadline_s
            if deadline_std_s > 0:
                dl = max(0.01, rng.normal(mean_deadline_s, deadline_std_s))
            requests.append(
                Request(
                    rid=rid,
                    app=spec.name,
                    arrival_s=float(arrivals[i]),
                    deadline_s=float(arrivals[i] + dl),
                    features=feats[i],
                    true_label=int(labels[i]),
                )
            )
            rid += 1
    return requests


def build_benchmark_suite(
    penalty: str = "sigmoid",
    prior: str = "uninformative",
    k: int = 5,
    seed: int = 0,
    apps: Sequence[str] | None = None,
    backend: str = "auto",
    *,
    train_n: int = 600,
    device=None,
):
    """(apps, sneakpeeks) for the default three-application testbed.
    ``backend`` maps to the k-NN route as in ``make_sneakpeek``; the
    port's ``train_n`` (the reference fixes 600) and ``device`` are
    keyword-only."""
    names = list(apps) if apps else list(APP_SPECS)
    app_map = {
        n: make_application(APP_SPECS[n], penalty=penalty, prior=prior, seed=seed)
        for n in names
    }
    sneaks = {
        n: make_sneakpeek(APP_SPECS[n], k=k, train_n=train_n, seed=seed, backend=backend,
                          device=device)
        for n in names
    }
    return app_map, sneaks
