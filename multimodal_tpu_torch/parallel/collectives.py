"""The collectives of the distributed layer, with their gradients where a step needs one.

JAX inserts these from ``lax`` primitives inside ``shard_map`` and differentiates them by
their transposes; here they are explicit ``torch.distributed`` calls, and the ones a loss or
a parameter gather runs under autograd are ``torch.autograd.Function`` s with the transpose
written out:

* ``all_gather(x, group, dim)``: the tiled gather along ``dim``; its backward is the
  reduce-scatter of the cotangent (``lax.all_gather``'s transpose), summed, or averaged when
  the ranks of ``group`` computed the same thing (``op="avg"``);
* ``mean_over(x, group)``: the value is the mean over the ranks (``lax.pmean``), the
  backward hands each rank ``1 / W`` of the cotangent: each rank differentiates its own term
  of the mean;
* ``ring_shift(tensors, group)``: every rank sends to the next rank of the group and
  receives from the one before (``lax.ppermute`` over a ring), one ``batch_isend_irecv``;
  not differentiable: the ring losses and ring attention write their backward rotation out.

``group`` None is a world of one rank: every collective is the identity, no process group
needed.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The tiled all-gather of ``x`` along ``dim`` (gloo and NCCL gather along dim 0 only, so
    ``dim`` goes to the front and back)."""
    w = group_size(group)
    if w == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((w * front.shape[0],) + front.shape[1:], dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, front, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, group, dim: int, op: str) -> torch.Tensor:
    """The sum (``op="sum"``) or mean (``"avg"``) over ``group`` of ``x``, each rank keeping
    its tile along ``dim``. Gloo has no average: sum, then divide."""
    w = group_size(group)
    if w == 1:
        return x
    front = x.movedim(dim, 0).contiguous()
    out = torch.empty((front.shape[0] // w,) + front.shape[1:], dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, front, op=dist.ReduceOp.SUM, group=group)
    if op == "avg":
        out.div_(w)
    return out.movedim(0, dim)


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` summed (or averaged, ``op="avg"``) over ``group``, in place."""
    w = group_size(group)
    if w > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        if op == "avg":
            t.div_(w)
    return t


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim: int, op: str):
        ctx.group, ctx.dim, ctx.op = group, dim, op
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, ct):
        return _reduce_scatter(ct, ctx.group, ctx.dim, ctx.op), None, None, None


def all_gather(x: torch.Tensor, group, dim: int = 0, op: str = "sum") -> torch.Tensor:
    """``x`` of every rank of ``group``, concatenated along ``dim`` in rank order; the
    gradient is the reduce-scatter of the cotangent: summed over the ranks (each rank's
    cotangent is its own loss term's), or with ``op="avg"`` averaged (ranks that computed the
    same loss from the same rows)."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, group, dim, op)


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.w = group_size(group)
        return all_reduce_(x.detach().clone(), group) / ctx.w

    @staticmethod
    def backward(ctx, ct):
        return ct / ctx.w, None


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (``lax.pmean``): the same value on every
    rank; its gradient reaches each rank's ``x`` as ``1 / W`` of the cotangent, so that the
    gradients of the ranks add up to the gradient of the mean."""
    if group_size(group) == 1:
        return x
    return _MeanOver.apply(x, group)


def ring_shift(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Send every tensor to the next rank of ``group`` (mod W) and return what the rank before
    sent: one ``batch_isend_irecv``, waited on."""
    w = group_size(group)
    if w == 1:
        return list(tensors)
    me = group_rank(group)
    dst = dist.get_global_rank(group, (me + 1) % w)
    src = dist.get_global_rank(group, (me - 1) % w)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, src, group) for r in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def broadcast_object(obj):
    """``obj`` as rank 0 has it, on every rank of the process group (a picklable object); the
    object itself without a group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
