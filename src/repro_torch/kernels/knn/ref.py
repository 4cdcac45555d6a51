"""Plain PyTorch version of the k-NN evidence kernel.

Distances follow the kernel's convention, ``|x|^2 - 2 q.x`` (the
ranking-invariant ``|q|^2`` is dropped), in float32 with TF32 switched
off for the product: TF32 keeps about three decimal digits and would
reorder neighbours.  ``torch.topk`` leaves the order of equal values
unspecified, so the top k come from a stable sort: equal distances keep
the lower training index first, the kernel's tie rule.  Queries are
taken in chunks so the (chunk, N) distance tile stays bounded.
"""
from __future__ import annotations

import torch

__all__ = ["knn_topk_ref", "votes_from_labels"]

_QUERY_CHUNK = 1024


def knn_topk_ref(queries, train_x, train_norms, train_y, k: int):
    """(dists (Q, k) float32, labels (Q, k) int32), ascending by (d, index)."""
    if queries.shape[0] == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=queries.device),
                torch.empty((0, k), dtype=torch.int32, device=queries.device))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dists, labels = [], []
        for q in queries.split(_QUERY_CHUNK):
            d2 = train_norms[None, :] - 2.0 * (q @ train_x.T)
            idx = torch.sort(d2, dim=1, stable=True).indices[:, :k]
            dists.append(torch.gather(d2, 1, idx))
            labels.append(train_y[idx])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return torch.cat(dists), torch.cat(labels).to(torch.int32)


def votes_from_labels(labels, num_classes: int) -> torch.Tensor:
    """(Q, num_classes) float64 vote counts — the multinomial evidence y."""
    one_hot = torch.nn.functional.one_hot(labels.long(), num_classes)
    return one_hot.sum(dim=1).to(torch.float64)
