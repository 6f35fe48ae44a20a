"""Concrete learning tasks (CNN / MF / dense LM) wiring the model zoo into
the protocol core's :class:`~repro_torch.core.tasks.LearningTask`
interface.

One task is shared by all simulated nodes (they share architecture and
hyperparameters per the paper's system model).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.core.tasks import LearningTask
from repro_torch.data.loader import ClientDataset
from repro_torch.engine.flat import FlatModel, FlatSpec, as_tree
from repro_torch.models import build
from repro_torch.utils.device import resolve_device
from repro_torch.utils.pytree import tree_flatten


class TorchTask(LearningTask):
    """Generic task: model family chosen by cfg.family.

    Carries the FlatModel surface of the compute engine: a per-task
    :class:`~repro_torch.engine.flat.FlatSpec` (computed once),
    FlatModel-aware ``local_train``/``evaluate``/``aggregate`` (trees are
    accepted everywhere; FlatModels skip the pack), and stacked many-model
    evaluation. Aggregation runs the whole-model one-pass kernel and
    returns a FlatModel so consecutive rounds never rebuild pytrees.

    ``device``: where parameters, batches and every computation of the
    task live; None means the card.
    """

    supports_cohort = True

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.model = build(cfg)
        self.name = cfg.name
        self._opt = optim.build(tcfg)
        self._flat_spec: Optional[FlatSpec] = None
        from repro_torch.engine.lowering import stacked_metrics_for
        self._eval_many = stacked_metrics_for(self)

    def _step(self, params, opt_state, batch):
        refuse_flash_training(self.cfg)
        leaves, treedef = tree_flatten(params)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        loss, _metrics = self.model.loss_fn(treedef.unflatten(leaves), batch)
        grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
        upd, opt_state = self._opt.update(grads, opt_state, params)
        return optim.apply_updates(params, upd), opt_state, loss.detach()

    def _eval(self, params, batch):
        with torch.no_grad():
            return self.model.loss_fn(params, batch)[1]

    @property
    def flat_spec(self) -> FlatSpec:
        """Flat-buffer layout of this task's parameter pytree (computed
        once, from an init on the ``meta`` device: shapes and dtypes, no
        weights)."""
        if self._flat_spec is None:
            tree = self.model.init(torch.Generator().manual_seed(0), "meta")
            self._flat_spec = FlatSpec.from_tree(tree)
        return self._flat_spec

    # -- batch adaptation per family ------------------------------------------

    def _to_batch(self, x, y, mask=None) -> dict:
        """Host arrays -> device tensors in their own dtypes: the CNN's
        images float and labels integer, MF's pairs integer and ratings
        float, the LMs' tokens and labels integer. Token families mask per
        position: a row mask broadcasts over the sequence."""
        dev = self.device
        if self.cfg.family in ("cnn", "mf"):
            b = {"x": torch.as_tensor(x, device=dev),
                 "y": torch.as_tensor(y, device=dev)}
            if mask is not None:
                b["mask"] = torch.as_tensor(mask, device=dev)
            return b
        b = {"tokens": torch.as_tensor(x, device=dev),
             "labels": torch.as_tensor(y, device=dev)}
        if mask is not None:
            b["mask"] = torch.as_tensor(mask, device=dev)[:, None].expand(
                b["tokens"].shape)
        return b

    def _padded_batches(self, client: ClientDataset, batch_size: int, *,
                        seed: int = 0, epochs: int = 1):
        """[(x, y, mask)] with every batch padded to ``batch_size``.

        Padded rows repeat real samples but carry mask 0, so they
        contribute exactly zero gradient (replicating samples into the
        batch instead would silently upweight them). Shapes are constant
        across batches.
        """
        out = []
        for x, y in client.batches(batch_size, seed=seed, epochs=epochs):
            mask = np.ones(batch_size, np.float32)
            if len(x) < batch_size:
                reps = -(-batch_size // len(x))
                mask[len(x):] = 0.0
                x = np.concatenate([x] * reps)[:batch_size]
                y = np.concatenate([y] * reps)[:batch_size]
            out.append((x, y, mask))
        return out

    # -- LearningTask interface ---------------------------------------------

    def init_params(self, seed: int = 0):
        return self.model.init(torch.Generator().manual_seed(seed),
                               self.device)

    def local_train(self, params, client: ClientDataset, *, batch_size: int,
                    epochs: int = 1, seed: int = 0, lr_scale: float = 1.0):
        params = as_tree(params)                # boundary: FlatModel -> tree
        opt_state = self._opt.init(params)      # fresh per round (paper: SGD)
        for x, y, mask in self._padded_batches(client, batch_size,
                                               seed=seed, epochs=epochs):
            params, opt_state, _ = self._step(params, opt_state,
                                              self._to_batch(x, y, mask))
        return params

    def _eval_batches(self, test: ClientDataset, bs: int = 64):
        for lo in range(0, len(test), bs):
            x, y = test.x[lo:lo + bs], test.y[lo:lo + bs]
            if len(x) < bs:
                pad = bs - len(x)
                w = len(x)
                x = np.concatenate([x, x[:1].repeat(pad, 0)])
                y = np.concatenate([y, y[:1].repeat(pad, 0)])
            else:
                w = bs
            yield x, y, w

    def evaluate(self, params, test: ClientDataset) -> dict:
        params = as_tree(params)
        agg: dict = {}
        n = 0
        for x, y, w in self._eval_batches(test):
            m = self._eval(params, self._to_batch(x, y))
            for k, v in m.items():
                agg[k] = agg.get(k, 0.0) + float(v) * w   # host sync
            n += w
        return {k: v / n for k, v in agg.items()}

    def evaluate_many(self, models: Sequence, test: ClientDataset):
        """Evaluate many models in one stacked sweep per test batch.

        Same batch slicing/padding/weighting as :meth:`evaluate`, so the
        numbers match the sequential path; the models axis is batched
        (sessions evaluate their collected round snapshots this way).
        """
        if not models:
            return []
        spec = self.flat_spec
        stacked = spec.unpack_stacked(torch.stack(
            [m.buffer if isinstance(m, FlatModel) else spec.pack(m)
             for m in models]))
        aggs = [dict() for _ in models]
        n = 0
        for x, y, w in self._eval_batches(test):
            with torch.no_grad():
                ms = self._eval_many(stacked, self._to_batch(x, y))
            for k, v in ms.items():
                v_np = v.cpu().numpy()         # one host sync per metric
                for i in range(len(models)):
                    aggs[i][k] = aggs[i].get(k, 0.0) + float(v_np[i]) * w
            n += w
        return [{k: v / n for k, v in a.items()} for a in aggs]

    def aggregate(self, models: Sequence,
                  weights: Optional[Sequence[float]] = None, *,
                  shardings=None):
        """AVG(Θ) via the whole-model one-pass kernel; returns a FlatModel
        (unflattened lazily at task boundaries). Inputs may be FlatModels
        or pytrees (mixed is fine). ``shardings`` (a
        :class:`repro_torch.sharding.FlatShardings`) runs the kernel per
        model-axis shard — the MeshEngine passes its mesh layout here."""
        from repro_torch.kernels.ops import aggregate_flatmodel
        return aggregate_flatmodel(list(models), weights,
                                   spec=self.flat_spec, device=self.device,
                                   shardings=shardings)

    def aggregate_masked(self, models: Sequence, seeds, signs,
                         weights: Optional[Sequence[float]] = None, *,
                         shardings=None):
        """Secure-agg AVG over *sealed* FlatModels (repro_torch.secureagg):
        the fused kernel regenerates each row's mask from ``seeds``/``signs``
        ``(P, R)`` matrices, removes it exactly and aggregates — bit-
        identical to :meth:`aggregate` on the unsealed rows, per shard
        with ``shardings`` as for :meth:`aggregate`."""
        from repro_torch.kernels.ops import masked_aggregate_flatmodel
        return masked_aggregate_flatmodel(list(models), weights, seeds=seeds,
                                          signs=signs, spec=self.flat_spec,
                                          device=self.device,
                                          shardings=shardings)

    def aggregate_sequential(self, models: Sequence,
                             weights: Optional[Sequence[float]] = None):
        """Legacy per-leaf reference aggregation over pytrees."""
        return super().aggregate([as_tree(m) for m in models], weights)

    def model_bytes(self, params=None) -> int:
        return self.flat_spec.nbytes


def cnn_task(tcfg: Optional[TrainConfig] = None, device=None,
             **cfg_overrides) -> TorchTask:
    from repro_torch.configs import get_config
    cfg = get_config("paper-cnn").with_(**cfg_overrides)
    return TorchTask(cfg, tcfg or TrainConfig(optimizer="momentum", lr=0.002,
                                              momentum=0.9), device=device)


def mf_task(tcfg: Optional[TrainConfig] = None, device=None,
            **cfg_overrides) -> TorchTask:
    from repro_torch.configs import get_config
    cfg = get_config("paper-mf").with_(**cfg_overrides)
    return TorchTask(cfg, tcfg or TrainConfig(optimizer="sgd", lr=0.2),
                     device=device)


def lm_task(arch: str = "tinyllama-1.1b", tcfg: Optional[TrainConfig] = None,
            reduce: bool = True, device=None, **cfg_overrides) -> TorchTask:
    """A dense LM of the zoo as a learning task: the 2-layer smoke variant
    of ``arch`` (``configs.reduced``) unless ``reduce=False``, then
    ``cfg_overrides``; plain SGD at lr 0.05. Training never takes the
    flash path (:func:`refuse_flash_training`)."""
    from repro_torch.configs import get_config, reduced
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    cfg = cfg.with_(**cfg_overrides)
    return TorchTask(cfg, tcfg or TrainConfig(optimizer="sgd", lr=0.05),
                     device=device)


def refuse_flash_training(cfg) -> None:
    """Training with ``use_flash`` raises, on every device: the flash
    kernel has no backward, and the reference's gradient through its
    Pallas kernel fails too, so no reference path trains with it. Training
    through the plain attention instead would be a silent change of
    path."""
    if getattr(cfg, "use_flash", False):
        raise NotImplementedError(
            f"{cfg.name}: training with use_flash=True: the flash-attention "
            "kernel has no backward (the reference cannot differentiate "
            "its Pallas kernel either); train with use_flash=False")
