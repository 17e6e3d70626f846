"""train_step: microbatched grad accumulation + AdamW.

``cfg.num_microbatches`` splits the global batch inside the step, so
peak activation memory scales with the microbatch. Grads come from
``torch.autograd.grad`` of the model's ``loss_fn`` with respect to
detached leaves that share the parameters' storage; the AdamW update
then writes the parameters and moments in place under
``torch.no_grad()`` (``optim.adamw_step``). With more than one
microbatch the float32 grads and losses are summed over the splits and
divided by their count, and ``metrics["aux"]`` is 0, as in the
reference. Under a traced step (``models.probe.ACTIVE``) the update is
marked as the region ``train.adamw``.
"""
from __future__ import annotations

import torch

from .. import sharding
from ..models import layers, probe
from ..models.transformer import LM, map_paths, map_tree, tree_leaves
from . import optim


def loss_and_grads(lm: LM, params, batch):
    """(loss metrics, float32 grads of the tree ``params``)."""
    leaves = map_tree(lambda p: sharding.detach(p).requires_grad_(True),
                      params)
    paths, flat = zip(*tree_leaves(leaves))
    loss, metrics = lm.loss_fn(leaves, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    by_path = {path: (torch.zeros_like(x) if g is None else g).float()
               for path, g, x in zip(paths, grads, flat)}
    return ({k: v.detach() for k, v in metrics.items()},
            map_paths(lambda path, _: by_path[path], params))


def make_train_step(lm: LM, opt_cfg: optim.OptConfig):
    cfg = lm.cfg

    def train_step(state, batch):
        params = state["params"]
        nmb = max(1, cfg.num_microbatches)

        if nmb == 1:
            metrics, grads = loss_and_grads(lm, params, batch)
        else:
            def split(x, i):
                # a DTensor's batch dim gathered explicitly (DTensor's
                # slice of a split dim gathers it as it chooses), cut,
                # and split again as it came
                mb = x.shape[0] // nmb
                cut = sharding.gather(x, 0)[i * mb:(i + 1) * mb]
                return sharding.move(cut, getattr(x, "placements", None))
            grads = map_tree(optim.zeros_f32, params)
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=tree_leaves(params)[0][1].device)
            for i in range(nmb):
                m, g = loss_and_grads(lm, params,
                              {k: split(v, i) for k, v in batch.items()})
                for (_, acc), (_, gi) in zip(tree_leaves(grads),
                                             tree_leaves(g)):
                    optim.local(acc).add_(optim.local(gi, like=acc))
                loss_sum = loss_sum + m["loss"]
            for _, acc in tree_leaves(grads):
                optim.local(acc).div_(nmb)
            metrics = {"loss": loss_sum / nmb,
                       "aux": torch.zeros_like(loss_sum)}

        pr = probe.ACTIVE
        if pr:
            pr.mark("train.adamw")
        params, opt_state, opt_metrics = optim.adamw_step(
            params, grads, {k: state[k] for k in ("mu", "nu", "step")},
            opt_cfg)
        if pr:
            pr.mark(None)
        new_state = {"params": params, **opt_state}
        return new_state, {**metrics, **opt_metrics}

    return train_step


def init_state(lm: LM, generator: torch.Generator):
    params = lm.init(generator)
    return {"params": params, **optim.init_opt_state(params)}


def abstract_state(lm: LM, device) -> dict:
    """The train state's layout as empty tensors on ``device``: the
    restore template (``lm.param_specs()``' shapes in
    ``cfg.param_dtype``, float32 moments, an int32 step). ``device`` is
    explicit: a ``meta`` template would restore onto the GPU wherever
    the trainer runs. On ``"meta"`` it is the abstract train state (the
    dry-run's), whose axes are :func:`state_axes`'."""
    dtype = layers.dtype_of(lm.cfg.param_dtype)
    specs = lm.param_specs()

    def empty(dt):
        return layers.map_specs(lambda _, s: torch.empty(
            s.shape, dtype=dt, device=device), specs)
    return {"params": empty(dtype), "mu": empty(torch.float32),
            "nu": empty(torch.float32),
            "step": torch.empty((), dtype=torch.int32, device=device)}


def state_axes(lm: LM) -> dict:
    """The train state's logical axes (``abstract_state``'s tree)."""
    axes = lm.param_axes()
    return {"params": axes, "mu": axes, "nu": axes, "step": ()}
