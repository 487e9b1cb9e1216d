"""Training over a (data, model) mesh: data parallelism, Megatron TP and
FSDP / ZeRO-3 on the SPMD ranks of `torch.distributed`.

The JAX package has no module of this name: there, `jit` over parameters
placed by `parallel/mesh.py:fsdp_param_pspecs` (or `param_pspecs`) lets
the partitioner derive the whole schedule (JAX `mesh.py:136-176`). An SPMD
rank does by hand what the partitioner derives:

* `FSDP(model, mesh, specs)` keeps this rank's piece of every leaf: the
  `model` axis's TP shard (`param_pspecs`, or `models/moe.py:
  moe_param_pspecs` for experts), and of the leaves the specs cut over
  `data`, the data rank's piece of that (ZeRO-3). AdamW built on
  `FSDP.model` keeps its moments on those pieces.
* Before a layer computes, its cut weights are gathered over `data`
  (`collectives.fsdp_gather`, `gather_fn` of `models/llama.py:forward`),
  inside the layer's remat body, so remat gathers them again in the
  backward; the gather's backward reduce-scatters the weight gradients
  (summed over the data ranks, each keeping its piece).
* Leaves the specs leave whole on every data rank (norms; every leaf under
  plain DP) get their gradients summed over `data` after the backward.
* The loss each rank differentiates is its batch's mean over dp, so the
  sums are the gradient of the global batch's mean (equal batches a rank),
  the single-device loss; the reported loss is the mean over `data`.
* `grad_norm` is the norm of the whole gradient (`utils/resilience.py:
  global_grad_norm`): each leaf's squares summed over the axes that cut it.

Over the `model` axis the ranks compute with the TP formulation of
`models/llama.py` (`tp_group`), whose replicated leaves (norms, the
embedding) get equal gradients on every TP rank, so nothing is summed over
`model`.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from fa2_triton_tpu_torch.parallel import collectives as coll
from fa2_triton_tpu_torch.parallel.mesh import (
    AXIS_DATA, AXIS_MODEL, Spec, axis_group, axis_rank, axis_size, fsdp_param_pspecs,
    param_pspecs, shard_params,
)


def train_specs(model, mesh, fsdp: bool = False, moe: bool = False,
                min_size: int = 2 ** 14) -> Dict[str, Spec]:
    """The specs a training mesh takes (the JAX trainer's choice,
    `examples/train.py:78-116`): TP specs over `model` (`param_pspecs`, or
    `moe_param_pspecs` for an MoE model, whose experts shard on E), and
    with `fsdp` a data-axis cut on top of them (`fsdp_param_pspecs`)."""
    tp = axis_size(mesh, AXIS_MODEL)
    if moe:
        from fa2_triton_tpu_torch.models.moe import moe_param_pspecs

        base = moe_param_pspecs(model)
    else:
        base = param_pspecs(model)
    if fsdp:
        return fsdp_param_pspecs(model, mesh, min_size=min_size, base=base)
    return base if tp > 1 else {name: () for name in base}


def _view(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> nn.Module:
    """A shallow copy of `module` (sharing its children) in which each
    parameter named in `tensors` is that tensor."""
    out = copy.copy(module)
    out.__dict__["_parameters"] = dict(module._parameters)
    for name, t in tensors.items():
        out._parameters.pop(name, None)
        object.__setattr__(out, name, t)
    return out


class FSDP:
    """This rank's shard of `model` for training over `mesh` under `specs`
    ({parameter name: spec}, `train_specs`). `model` is the whole model,
    the same on every rank (its uncut leaves are shared, not copied);
    `self.model` is the rank's `LlamaModel`, whose parameters the optimizer
    takes, and whose config holds the local head counts under TP."""

    def __init__(self, model, mesh, specs: Mapping[str, Spec]):
        self.mesh = mesh
        self.specs = dict(specs)
        self.dp = axis_size(mesh, AXIS_DATA)
        self.tp = axis_size(mesh, AXIS_MODEL)
        self.coords = {a: axis_rank(mesh, a) for a in (AXIS_DATA, AXIS_MODEL)}
        self.groups = {name: axis_group(mesh, name)
                       for name in (AXIS_DATA, AXIS_MODEL) if axis_size(mesh, name) > 1}
        self.data_group = self.groups.get(AXIS_DATA)
        self.tp_group = self.groups.get(AXIS_MODEL)
        self.model = shard_params(model, mesh, self.specs)
        # The data-axis part of each spec: what fsdp_gather gathers.
        self.data_spec = {name: tuple(a if a == AXIS_DATA else None for a in spec)
                          for name, spec in self.specs.items()}
        self.cut = {name: self.dp > 1 and AXIS_DATA in spec for name, spec in self.specs.items()}
        self.sharded = any(self.cut.values())
        self._prefix = {id(self.model): ""}
        self._prefix.update({id(layer): f"layers.{i}."
                             for i, layer in enumerate(self.model.layers)})
        self.names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        self.params = [p for p in self.model.parameters() if p.requires_grad]

    # -- the forward ----------------------------------------------------------

    def gather_fn(self, module: nn.Module) -> nn.Module:
        """`module` (the rank's model or one of its layers) with each of its
        own data-cut parameters gathered over `data` (its children as they
        are): the `gather_fn` of `llama.forward` / `moe.forward`."""
        prefix = self._prefix[id(module)]
        full = {}
        for attr, p in module._parameters.items():
            name = prefix + attr
            if p is not None and self.cut.get(name):
                full[attr] = coll.fsdp_gather(p, self.data_spec[name], self.groups)
        return _view(module, full) if full else module

    def loss(self, loss_fn: Callable, tokens: torch.Tensor, **kw) -> torch.Tensor:
        """`loss_fn(model, tokens, tp_group=..., gather_fn=..., **kw)` on this
        rank's batch rows (`models/llama.py:loss_fn`, `models/moe.py:
        loss_fn`)."""
        return loss_fn(self.model, tokens, tp_group=self.tp_group,
                       gather_fn=self.gather_fn if self.sharded else None, **kw)

    # -- the gradients --------------------------------------------------------

    def value_and_grad(self, loss_fn: Callable, tokens: torch.Tensor, **kw
                       ) -> Tuple[torch.Tensor, List[Optional[torch.Tensor]]]:
        """(the global batch's loss, this rank's gradient pieces) for this
        rank's rows `tokens`: the local mean divided by dp is differentiated,
        the data-cut leaves' gradients come back reduce-scattered and the
        others are summed over `data` here. The loss is the mean over the
        data ranks (every rank gets the same value)."""
        local = self.loss(loss_fn, tokens, **kw)
        grads = list(torch.autograd.grad(local / self.dp, self.params, allow_unused=True))
        if self.data_group is not None:
            for i, name in enumerate(self.names):
                if not self.cut[name] and grads[i] is not None:
                    grads[i] = coll.all_reduce(grads[i], self.data_group)
            local = coll.all_reduce(local.detach(), self.data_group) / self.dp
        return local.detach(), grads

    def cut_by(self) -> List[Tuple[str, ...]]:
        """Per trainable parameter, the axes whose ranks hold different
        pieces of it."""
        return [tuple(a for a in set(self.specs.get(n, ())) if a in self.groups)
                for n in self.names]

    def grad_norm(self, grads: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
        """The norm of the whole (sharded) gradient, the same on every rank."""
        from fa2_triton_tpu_torch.utils.resilience import global_grad_norm

        return global_grad_norm(grads, self.cut_by(), self.groups)

    # -- bookkeeping -----------------------------------------------------------

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.model.parameters())

    @staticmethod
    def moment_bytes(opt: torch.optim.Optimizer) -> int:
        """The bytes of the optimizer's tensors of one element or more (AdamW:
        its two moments) on this rank."""
        return sum(t.numel() * t.element_size() for st in opt.state.values()
                   for t in st.values() if isinstance(t, torch.Tensor) and t.dim() > 0)
