"""Step functions of the trainer and the server, the counterpart of
``repro.launch.steps``.

Each factory closes over the model and the optimizer config.  The
reference's are pure functions for ``jax.jit``; the port's train step
runs eagerly and updates the weights in place: the loss, its backward
(through K3b and K5b on the card), then ``adamw_step`` on the stacked
trees (``TransformerParams.grad_tree``/``to_tree``), whose result is
copied back into the weights (``load_tree_``).  ``input_specs`` belongs
with the dry-run tooling, ROADMAP item 13.
"""
from __future__ import annotations

from repro_torch.training.optimizer import OptimizerConfig, adamw_step

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(model, opt_cfg: OptimizerConfig):
    def train_step(params, opt_state, batch):
        """One step on ``params`` (a ``TransformerParams``, updated in place
        and returned); metrics as the reference's, 0-dim tensors."""
        params.requires_grad_(True)
        params.zero_grad(set_to_none=True)
        loss, metrics = model.loss(params, batch)
        loss.backward()
        grads = params.grad_tree()
        params.zero_grad(set_to_none=True)
        new_tree, new_opt, opt_metrics = adamw_step(grads, opt_state, params.to_tree(), opt_cfg)
        del grads
        params.load_tree_(new_tree)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, new_opt, {**metrics, **opt_metrics, "total_loss": loss.detach()}

    return train_step


def make_prefill_step(model, max_len: int):
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, max_len=max_len)

    return prefill_step


def make_decode_step(model):
    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step
