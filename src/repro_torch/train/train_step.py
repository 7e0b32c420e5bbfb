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

Sharded (the parameters DTensors placed by ``launch/shardings.py``, under
``models.sharding.sharding_env``): tokens and labels are constrained to
the batch axes, each gradient is brought to its parameter's placements,
and the metrics come back as plain replicated tensors.  The logits stay
vocab-sharded through the loss: its log-sum-exp reduces the local max
and sum of exponentials across "model", as GSPMD partitions the
reference's (an all-gather would put the whole (B, S, V) f32 logits on
every rank).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from ..models import model as MDL
from ..models.sharding import BATCH_AXES, from_shard, shard
from ..tree import flatten
from .optimizer import adamw_init, adamw_update


class TrainState(NamedTuple):
    params: Any
    opt: Any
    comp: Any            # gradient-compressor state (or ())
    step: torch.Tensor


def _logsumexp(logits):
    """``torch.logsumexp`` over the last dim; for a DTensor, the same
    steps (max, exp-sum, log, add) as DTensor ops, so a vocab-sharded
    dim reduces across ranks instead of being gathered, with
    ``torch.logsumexp``'s own backward (``grad * exp(x - result)``)."""
    if not isinstance(logits, DTensor):
        return torch.logsumexp(logits, dim=-1)
    return _ShardedLogSumExp.apply(logits)


def _gold(logits, labels):
    """``logits[..., labels]``.  For logits whose vocab dim is sharded over
    "model", each rank gathers the labels that fall in its vocab slice
    (the others count 0) and the slices' pending sum is taken across
    "model": every op stays on the rank's own shard, in the backward
    too."""
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, labels[..., None])[..., 0]
    mesh, places = logits.device_mesh, list(logits.placements)
    vdim = logits.ndim - 1
    split = [j for j, pl in enumerate(places)
             if isinstance(pl, Shard) and pl.dim == vdim]
    rest = [Replicate() if j in split else pl for j, pl in enumerate(places)]
    if isinstance(labels, DTensor):
        lab = labels.redistribute(mesh, rest).to_local()
    else:
        lab = distribute_tensor(labels, mesh, rest,
                                src_data_rank=None).to_local()
    ll = logits.to_local(grad_placements=places)
    n = ll.shape[-1]
    off, size = 0, logits.shape[-1]
    coord = mesh.get_coordinate()
    for j in split:
        size //= mesh.size(j)
        off += coord[j] * size
    idx = lab - off
    mine = (idx >= 0) & (idx < n)
    g = torch.gather(ll, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    g = torch.where(mine, g, 0.0)
    out = [Partial() if j in split else pl for j, pl in enumerate(rest)]
    return shard(from_shard(g, labels.shape, out, mesh), BATCH_AXES, None)


class _ShardedLogSumExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits):
        # each reduction over the vocab summed across ranks at once
        # (batch-sharded, replicated over "model"), so no pending sum
        # reaches the backward sequence-sharded
        m = shard(logits.amax(dim=-1, keepdim=True), BATCH_AXES, None,
                  None)
        m = torch.where(m.abs() == float("inf"), 0.0, m)
        e = shard(torch.exp(logits - m).sum(dim=-1), BATCH_AXES, None)
        out = torch.log(e) + m[..., 0]
        ctx.save_for_backward(logits, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        logits, out = ctx.saved_tensors
        return grad[..., None] * torch.exp(logits - out[..., None])


def loss_fn(params, tokens, labels, cfg, *, aux_weight: float = 0.01,
            remat: bool = False, sp: bool = False):
    """Mean next-token cross-entropy + MoE aux loss.  Returns
    ``(total, (loss, aux))``."""
    logits, aux = MDL.forward(params, tokens, cfg, remat=remat, sp=sp)
    logits = logits.float()
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0).long()
    logz = _logsumexp(logits)
    gold = _gold(logits, labels_safe)
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss + aux_weight * aux, (loss, aux)


def init_train_state(params, compressor=None) -> TrainState:
    comp = compressor.init(params) if compressor is not None else ()
    dev = flatten(params)[0][0].device
    return TrainState(params, adamw_init(params), comp,
                      torch.zeros((), dtype=torch.int32, device=dev))


def _like(g, p):
    """``g`` with ``p``'s placements when ``p`` is a DTensor (a pending
    sum resolved, a shard taken), contiguous."""
    if isinstance(p, DTensor) and tuple(g.placements) != \
            tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.contiguous()


def _plain(x):
    """A replicated DTensor scalar as a plain tensor (no collective);
    a plain tensor unchanged."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def grads_of(params, tokens, labels, cfg, *, aux_weight: float = 0.01,
             remat: bool = False, sp: bool = False):
    """``(grads, loss, aux)``: the gradient tree of ``loss_fn``'s total
    (zeros for unused parameters, contiguous, each in its parameter's
    dtype and placements) and the detached loss and aux loss."""
    leaves, treedef = flatten(params)
    with torch.enable_grad():
        inputs = [p.detach().requires_grad_() for p in leaves]
        total, (loss, aux) = loss_fn(treedef.unflatten(inputs), tokens,
                                     labels, cfg, aux_weight=aux_weight,
                                     remat=remat, sp=sp)
        grads = torch.autograd.grad(total, inputs, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p)
             for p, g in zip(leaves, grads)]
    return treedef.unflatten(grads), _plain(loss.detach()), \
        _plain(aux.detach())


def make_train_step(cfg, lr_schedule: Callable, *,
                    compressor=None,
                    aux_weight: float = 0.01,
                    weight_decay: float = 0.1,
                    grad_clip: float = 1.0,
                    remat: bool = True,
                    sp: bool = True):
    """Build the train step.  ``compressor``: optional DiSketch gradient
    compressor (train/compress.py).  ``remat``/``sp``: activation
    checkpointing + sequence-parallel residuals (see models/model.py;
    ``sp`` acts only under a sharding env).  ``batch``: ``{"tokens",
    "labels"}`` tensors on the parameters' device (DTensors, or plain
    tensors taken as replicated, under a sharding env)."""
    def step_fn(state: TrainState, batch):
        tokens = shard(batch["tokens"], BATCH_AXES, None)
        labels = shard(batch["labels"], BATCH_AXES, None)
        grads, loss, aux = grads_of(state.params, tokens, labels, cfg,
                                    aux_weight=aux_weight, remat=remat,
                                    sp=sp)
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
