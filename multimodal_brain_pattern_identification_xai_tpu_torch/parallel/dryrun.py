"""One DP × TP × SP training step (counterpart of the JAX package's
``parallel/dryrun.py``), the program of ``entry.dryrun_multichip``.

On a (data, model, seq) mesh:

* the batch is split over ``data``; the loss is the sum over ``data`` of
  each rank's summed cross-entropy over the global batch size;
* the long-EEG encoder's time axis is split over ``seq``
  (:mod:`.seqparallel`: gathered keys and values, the pool summed over
  ``seq``);
* the classifier head is tensor parallel over ``model`` (:mod:`.tp`:
  column → ReLU → row).

Every rank backpropagates the same replicated loss through its own part.
A parameter's gradient is then the sum over the axes along which its
ranks saw different data: the encoder's layers before the pool over
``data`` and ``seq``; the encoder's head and the TP head, which see the
pooled features (alike across ``seq``), over ``data`` only.  The TP
shards keep their own gradient over ``model``, and every other gradient is
already whole on each ``model`` rank (:func:`.tp.copy_in`).  The result
is the JAX step's with replication checking on, which JAX's tests hold
equal to the unsharded step.
"""

from __future__ import annotations

import copy
from typing import TYPE_CHECKING, Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import tp
from .mesh import axis_index, axis_size
from .seqparallel import LongEEGEncoder, lecun_normal

if TYPE_CHECKING:
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Placement

#: the encoder's parameters applied after the pool over ``seq``
POOLED_ENC = ("enc.head", "enc.head_b")


def init_dp_tp_sp_params(generator: torch.Generator, encoder: LongEEGEncoder,
                         head_hidden: int = 128) -> Dict[str, torch.Tensor]:
    """Full-size parameters, ``enc.<name>`` for the encoder (its head an
    identity, D → D: the TP head classifies the pooled embedding) and the
    TP head's ``k1`` (D, hidden), ``b1``, ``k2`` (hidden, n_classes),
    ``b2``; kernels lecun-normal from ``generator``, biases 0."""
    D = encoder.d_model
    fresh = copy.deepcopy(encoder).init(generator)
    params = {f"enc.{k}": v.detach().clone()
              for k, v in fresh.named_parameters()}
    params["enc.head"] = torch.eye(D)
    params["enc.head_b"] = torch.zeros(D)
    params["k1"] = lecun_normal((D, head_hidden), generator)
    params["b1"] = torch.zeros(head_hidden)
    params["k2"] = lecun_normal((head_hidden, encoder.n_classes), generator)
    params["b2"] = torch.zeros(encoder.n_classes)
    return params


def param_specs(params: Dict[str, torch.Tensor]
                ) -> Dict[str, List[Placement]]:
    """Placements on (data, model, seq): ``k1`` columns, ``b1`` and ``k2``
    rows over ``model``; everything else replicated."""
    from torch.distributed.tensor import Replicate, Shard
    specs = {k: [Replicate()] * 3 for k in params}
    specs["k1"] = [Replicate(), Shard(1), Replicate()]
    specs["b1"] = [Replicate(), Shard(0), Replicate()]
    specs["k2"] = [Replicate(), Shard(0), Replicate()]
    return specs


def _local(t: torch.Tensor, placements: List[Placement], mesh: DeviceMesh
           ) -> torch.Tensor:
    """This rank's part of a full tensor under ``placements``."""
    from torch.distributed.tensor import Shard
    for axis, p in zip(("data", "model", "seq"), placements):
        if isinstance(p, Shard):
            n, i = axis_size(mesh, axis), axis_index(mesh, axis)
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, i * size, size)
    return t


def place_inputs(mesh: DeviceMesh, params: Dict[str, torch.Tensor], x, y,
                 device=None):
    """This rank's parameters (its TP shards), batch rows (``data``) and
    time part (``seq``) of full host tensors, on ``device``: x (B, C, T)
    as ('data', None, 'seq'), y (B, n_classes) as ('data',)."""
    from torch.distributed.tensor import Replicate, Shard
    sp = param_specs(params)
    local = {k: _local(v, sp[k], mesh).to(device).contiguous()
             for k, v in params.items()}
    x = _local(torch.as_tensor(x), [Shard(0), Replicate(), Shard(2)], mesh)
    y = _local(torch.as_tensor(y), [Shard(0), Replicate(), Replicate()], mesh)
    return local, x.to(device).contiguous(), y.to(device).contiguous()


def grad_axes(name: str) -> tuple:
    """The axes over which the gradient of parameter ``name`` is summed."""
    if name.startswith("enc.") and name not in POOLED_ENC:
        return ("data", "seq")
    return ("data",)


def make_dp_tp_sp_train_step(mesh: DeviceMesh, encoder: LongEEGEncoder,
                             lr: float = 1e-3):
    """``step(params, x, y) -> (new_params, loss)`` on this rank's parts
    (:func:`place_inputs`): one SGD step; the loss is the global one,
    alike on every rank."""
    groups = {a: mesh.get_group(a) for a in ("data", "model", "seq")}
    n_data = axis_size(mesh, "data")

    def step(params: Dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor):
        ps = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        enc = {k[4:]: v for k, v in ps.items() if k.startswith("enc.")}
        pooled = torch.func.functional_call(encoder, enc, (x,),
                                            {"group": groups["seq"]})
        logits = tp.tp_mlp(pooled, ps["k1"], ps["b1"], ps["k2"], ps["b2"],
                           activation=F.relu, group=groups["model"])
        logp = F.log_softmax(logits, dim=-1)
        total = tp.reduce_out(-(y * logp).sum(), groups["data"])
        loss = total / (y.shape[0] * n_data)
        names = list(ps)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [ps[k] for k in names])))
        for axes in (("data", "seq"), ("data",)):
            sel = [k for k in names if grad_axes(k) == axes]
            vec = torch.cat([grads[k].reshape(-1) for k in sel])
            for a in axes:
                if axis_size(mesh, a) > 1:
                    dist.all_reduce(vec, group=groups[a])
            off = 0
            for k in sel:
                grads[k] = vec[off:off + grads[k].numel()].view_as(grads[k])
                off += grads[k].numel()
        new = {k: (params[k] - lr * grads[k]).detach() for k in names}
        return new, loss.detach()

    return step
