"""Per-family masked-loss lowerings for the batched cohort engine.

The engine's step must (a) take a per-row loss mask — padded batch rows
contribute exactly zero gradient (the ragged-tail fix) — and (b) run the
whole cohort of S models, each with its *own* weights, as one batch.

Two forms are offered for each task:

* per model — :func:`masked_loss_for` / :func:`eval_metrics_for`, the
  scalar loss and the metrics of one model (the family's own ``loss_fn``);
* stacked over the cohort — :func:`stacked_grads_for` /
  :func:`stacked_metrics_for`, which take a parameter tree whose every leaf
  has a leading S axis.

The stacked form is written for the CNN and MF families, with the stack
axis written out by hand; since the S losses are independent, one backward
pass of their sum yields every model's own gradient. It avoids per-op
batching rules on the hot path and costs one autograd graph per step.
The dense LM family takes its model's own masked loss under
``torch.func.vmap``, built once a task: every product of the layers then
carries the S axis (batched matrix products), so a step is one pass over
all S members, and, as for the CNN and MF, one backward pass of the S
losses' sum gives every member's own gradient. The reference vmaps
``jax.grad`` instead; ``vmap(grad(loss))`` gives the same gradients but
took 23–28 ms a TinyLlama-width cohort step on one H100 where this form
took 18–20 ms, with 2.3 GB more memory at its peak (PERF.md).
Other families raise ``NotImplementedError``.

* Dense LM: ``models/transformer.py::loss_fn`` of one model, the row mask
  broadcast over the sequence. Leaves keep the model's dtype (bf16 for the
  published configs, cast from the fp32 buffer by ``unpack_stacked``), so
  the gradients come back in it and are packed to fp32 by the engine, as
  in the reference. ``cfg.remat`` changes no value and is not read. The
  evaluation sweep vmaps the model's metrics over the M snapshots in
  chunks of the model axis (:data:`EVAL_LOGIT_BYTES`), which changes no
  value. Training with ``use_flash`` raises (no backward; as the
  reference, whose gradient through its Pallas kernel fails).

* CNN: the S models become the ``groups`` of one grouped convolution
  (channels laid out model-major) and the dense layers one batched matrix
  product. The math per model is that of ``models/cnn.py`` (conv SAME →
  relu → 2×2 max pool, twice, then three dense layers).
* MF: a model is two embedding tables, two bias vectors and a scalar, and
  its prediction two gathers and a dot product. The S tables are viewed as
  one table of S·U (S·I) rows and model s's row u is row ``s·U + u``, so
  the stack axis is only an offset into the gathers. The math per model is
  that of ``models/mf.py``'s ``loss_fn``, the L2 term and the row mask
  included. Its backward scatters into the tables with atomics on the
  card, so card runs are not bit-reproducible (the trajectory of events
  is).

Pooling ties: ``F.max_pool2d`` routes the gradient of a window to one of
its tied maxima, where the reference's reshape-max splits it evenly. The
only ties that occur after a ReLU are zeros, whose ReLU gradient is 0
either way, so both give the same parameter gradients; ``max_pool2d`` is
used because it needs no reshape copies and floors odd sizes like the
reference model's own pool.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# the dense evaluation sweep holds M x B x T x vocab fp32 logits; it runs
# the model axis in chunks of at most this many bytes of logits (at least
# one model a chunk)
EVAL_LOGIT_BYTES = 1 << 30


def _conv_stacked(h, w, b, S):
    """h: (B, S·ci, H, W); w: (S, kh, kw, ci, co); b: (S, co) -> relu(conv)
    (B, S·co, H, W), model s reading only its own ci channels."""
    _, kh, kw, ci, co = w.shape
    wg = w.permute(0, 4, 3, 1, 2).reshape(S * co, ci, kh, kw)
    y = F.conv2d(h, wg, b.reshape(S * co), padding=(kh // 2, kw // 2),
                 groups=S)
    return F.relu(y)


def _cnn_apply_stacked(params, x):
    """params: leaves with a leading S axis; x: (S, B, H, W, C) ->
    logits (S, B, classes)."""
    S, B, H, W, C = x.shape
    h = x.permute(1, 0, 4, 2, 3).reshape(B, S * C, H, W)
    h = _conv_stacked(h.to(params["conv1"].dtype), params["conv1"],
                      params["b1"], S)
    h = F.max_pool2d(h, 2)
    h = _conv_stacked(h, params["conv2"], params["b2"], S)
    h = F.max_pool2d(h, 2)
    c2 = params["conv2"].shape[-1]
    h = h.reshape(B, S, c2, h.shape[2], h.shape[3])
    h = h.permute(1, 0, 3, 4, 2).reshape(S, B, -1)      # (H, W, C) order
    h = F.relu(torch.bmm(h, params["fc1"]))
    h = F.relu(torch.bmm(h, params["fc2"]))
    return torch.bmm(h, params["out"])


def _rows_xent(logits, labels, mask=None):
    """Per-model masked mean cross entropy: (S, B, K), (S, B) -> (S,).
    Row s equals ``softmax_xent`` of model s alone."""
    logits = logits.to(torch.float32)
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(
        logits, -1, labels[..., None])[..., 0]
    if mask is None:
        return torch.mean(nll, dim=1)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask, dim=1) / torch.clamp_min(
        torch.sum(mask, dim=1), 1.0)


def masked_loss_for(task):
    """Scalar masked loss ``f(params, batch)`` for one model of ``task``.

    ``batch`` carries ``mask`` (B,) alongside the family's usual keys.
    """
    def loss(params, batch):
        value, _metrics = task.model.loss_fn(params, batch)
        return value

    return loss


def eval_metrics_for(task):
    """Metrics fn ``f(params, batch) -> dict`` for one model of ``task``."""
    def metrics(params, batch):
        return task.model.loss_fn(params, batch)[1]

    return metrics


def _mf_rows(params, pairs, y, mask=None):
    """Per-model MF loss and mse: leaves with a leading S axis, pairs
    ``(S, B, 2)``, ratings and mask ``(S, B)`` -> ``(loss (S,), mse (S,))``.
    Row s equals ``mf.loss_fn`` of model s alone."""
    from repro_torch.models.mf import L2

    users, items = params["users"], params["items"]
    S, U, d = users.shape
    n_items = items.shape[1]
    off = torch.arange(S, device=pairs.device)[:, None]
    u = pairs[..., 0].long() + off * U                    # (S, B)
    i = pairs[..., 1].long() + off * n_items
    pu = users.reshape(S * U, d)[u]                       # (S, B, d)
    qi = items.reshape(S * n_items, d)[i]
    pred = (params["mu"][:, None] + params["b_user"].reshape(-1)[u]
            + params["b_item"].reshape(-1)[i] + torch.sum(pu * qi, dim=-1))
    err = torch.square(pred - y)
    reg_u = torch.sum(torch.square(pu), -1)
    reg_i = torch.sum(torch.square(qi), -1)
    if mask is None:
        mse = torch.mean(err, dim=1)
        reg = L2 * (torch.mean(reg_u, dim=1) + torch.mean(reg_i, dim=1))
    else:
        m = mask.to(torch.float32)
        denom = torch.clamp_min(torch.sum(m, dim=1), 1.0)
        mse = torch.sum(err * m, dim=1) / denom
        reg = L2 * (torch.sum(reg_u * m, dim=1)
                    + torch.sum(reg_i * m, dim=1)) / denom
    return mse + reg, mse


def _family(task) -> str:
    family = task.cfg.family
    if family not in ("cnn", "mf", "dense"):
        raise NotImplementedError(
            f"no stacked lowering for the {family!r} family")
    return family


def _dense_grads(task):
    """Per-member gradients of one dense LM's masked loss: the S losses of
    ``vmap(loss)`` summed, one backward pass; ``xb`` tokens and ``yb``
    labels ``(S, B, T)``, ``mb`` the row mask ``(S, B)``."""
    from repro_torch.models import transformer
    from repro_torch.models.tasks import refuse_flash_training
    from repro_torch.utils.pytree import tree_flatten

    cfg = task.cfg

    def loss(params, tokens, labels, mask):
        batch = {"tokens": tokens, "labels": labels, "mask": mask}
        return transformer.loss_fn(params, cfg, batch)[0]

    losses = torch.func.vmap(loss)

    def grads(ptree, xb, yb, mb):
        refuse_flash_training(cfg)
        leaves, treedef = tree_flatten(ptree)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        total = torch.sum(losses(treedef.unflatten(leaves), xb, yb,
                                 mb[:, :, None].expand(xb.shape)))
        return treedef.unflatten(list(torch.autograd.grad(total, leaves)))

    return grads


def _dense_metrics(task):
    """The model's own metrics, vmapped over M stacked models on one shared
    batch, the model axis in chunks of :data:`EVAL_LOGIT_BYTES` logits."""
    from repro_torch.models import transformer
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = task.cfg

    def metrics(params, tokens, labels):
        return transformer.loss_fn(params, cfg, {"tokens": tokens,
                                                 "labels": labels})[1]

    per_model = torch.func.vmap(metrics, in_dims=(0, None, None))

    def sweep(ptree, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        M = tree_leaves(ptree)[0].shape[0]
        per = max(1, EVAL_LOGIT_BYTES // (tokens.numel() * cfg.vocab * 4))
        outs = [per_model(tree_map(lambda t: t[lo:lo + per], ptree), tokens,
                          labels)
                for lo in range(0, M, per)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return sweep


def stacked_grads_for(task):
    """``f(ptree, xb, yb, mb) -> gtree``: per-model gradients of the masked
    loss over a cohort. Every leaf of ``ptree``/``gtree`` and ``xb``
    ``(S, B, ...)``, ``yb`` ``(S, B)``, ``mb`` ``(S, B)`` carry the stack
    axis."""
    family = _family(task)
    if family == "dense":
        return _dense_grads(task)

    def grads(ptree, xb, yb, mb):
        keys = sorted(ptree)
        leaves = {k: ptree[k].detach().requires_grad_(True) for k in keys}
        if family == "cnn":
            logits = _cnn_apply_stacked(leaves, xb)
            total = torch.sum(_rows_xent(logits, yb.long(), mb))
        else:
            total = torch.sum(_mf_rows(leaves, xb, yb, mb)[0])
        gs = torch.autograd.grad(total, [leaves[k] for k in keys])
        return dict(zip(keys, gs))

    return grads


def stacked_metrics_for(task):
    """``f(ptree, batch) -> {metric: (M,)}``: the metrics of M stacked
    models on one shared, unmasked batch (the evaluation sweep): the
    family's ``loss_fn`` metrics, model by model."""
    family = _family(task)
    if family == "dense":
        return _dense_metrics(task)

    def metrics(ptree, batch):
        x, y = batch["x"], batch["y"]
        if family == "mf":
            M = ptree["mu"].shape[0]
            _, mse = _mf_rows(ptree, x.expand((M,) + tuple(x.shape)),
                              y.expand(M, y.shape[0]))
            return {"loss": mse, "mse": mse}
        M = ptree["b1"].shape[0]
        labels = y.long()
        logits = _cnn_apply_stacked(ptree, x.expand((M,) + tuple(x.shape)))
        yb = labels.expand(M, labels.shape[0])
        acc = torch.mean((torch.argmax(logits, -1) == yb).to(torch.float32),
                         dim=1)
        return {"loss": _rows_xent(logits, yb), "accuracy": acc}

    return metrics
