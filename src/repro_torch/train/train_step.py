"""Training step: causal-LM loss, grad clip, AdamW, optional DiSketch
gradient compression (port of ``repro/train/train_step.py``).

``make_train_step`` builds a function
    (state: TrainState, batch) -> (TrainState, metrics)
where ``TrainState = (params, opt, comp, step)``; ``comp`` is the gradient
compressor's state (the error-feedback residual) or an empty tuple when
compression is off.  The fields and their leaf order are the reference's,
so a checkpoint of either package's state restores through the other's.

Gradients come from ``torch.autograd.grad`` over the parameter leaves.  A
parameter the forward does not use (the embedding table of an
``embed_inputs`` arch) gets a zero gradient where torch gives ``None``, as
``jax.grad`` gives zeros: weight decay and the compressor's residual act on
it all the same.  The step runs on the parameters' device and reads no
device scalar back to the host; AdamW and the compressor update the state's
tensors in place.

Loss is computed in float32 (the logits are f32).  Labels < 0 are masked.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..models import model as MDL
from ..tree import flatten
from .optimizer import adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Any
    opt: Any
    comp: Any            # gradient-compressor state (or ())
    step: torch.Tensor


def loss_fn(params, tokens, labels, cfg, *, aux_weight: float = 0.01,
            remat: bool = False):
    """Mean next-token cross-entropy + MoE aux loss.  Returns
    ``(total, (loss, aux))``."""
    logits, aux = MDL.forward(params, tokens, cfg, remat=remat)
    logits = logits.float()
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux, (loss, aux)


def init_train_state(params, compressor=None) -> TrainState:
    comp = compressor.init(params) if compressor is not None else ()
    dev = flatten(params)[0][0].device
    return TrainState(params, adamw_init(params), comp,
                      torch.zeros((), dtype=torch.int32, device=dev))


def grads_of(params, tokens, labels, cfg, *, aux_weight: float = 0.01,
             remat: bool = False):
    """``(grads, loss, aux)``: the gradient tree of ``loss_fn``'s total
    (zeros for unused parameters, contiguous, each in its parameter's
    dtype) and the detached loss and aux loss."""
    leaves, treedef = flatten(params)
    with torch.enable_grad():
        inputs = [p.detach().requires_grad_() for p in leaves]
        total, (loss, aux) = loss_fn(treedef.unflatten(inputs), tokens,
                                     labels, cfg, aux_weight=aux_weight,
                                     remat=remat)
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.contiguous()
             for p, g in zip(leaves, grads)]
    return treedef.unflatten(grads), loss.detach(), aux.detach()


def make_train_step(cfg, lr_schedule: Callable, *,
                    compressor=None,
                    aux_weight: float = 0.01,
                    weight_decay: float = 0.1,
                    grad_clip: float = 1.0,
                    remat: bool = True):
    """Build the train step.  ``compressor``: optional DiSketch gradient
    compressor (train/compress.py).  ``remat``: recompute each layer block
    in the backward pass (see models/model.py).  The reference's ``sp``
    (sequence-parallel residuals over a ``model`` mesh axis) has no
    counterpart on one card.  ``batch``: ``{"tokens", "labels"}`` tensors
    on the parameters' device."""

    def step_fn(state: TrainState, batch):
        grads, loss, aux = grads_of(state.params, batch["tokens"],
                                    batch["labels"], cfg,
                                    aux_weight=aux_weight, remat=remat)
        comp = state.comp
        if compressor is not None:
            grads, comp = compressor.apply(grads, comp, state.step)
        lr = lr_schedule(state.step)
        params, opt, gnorm = adamw_update(
            state.params, grads, state.opt, lr=lr,
            weight_decay=weight_decay, grad_clip=grad_clip)
        metrics = {"loss": loss, "aux_loss": aux, "grad_norm": gnorm,
                   "lr": lr}
        return TrainState(params, opt, comp, state.step + 1), metrics

    return step_fn


def make_eval_step(cfg):
    def eval_fn(params, batch):
        with torch.no_grad():
            _, (loss, _) = loss_fn(params, batch["tokens"], batch["labels"],
                                   cfg)
        return loss
    return eval_fn
