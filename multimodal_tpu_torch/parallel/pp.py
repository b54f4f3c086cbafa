"""Pipeline parallelism: the towers' blocks split into stages over a ``stage`` axis, run with
the GPipe schedule (port of ``multimodal_tpu/parallel/pp.py``; a library, no CLI flag).

With M microbatches and S stages the schedule runs M + S - 1 ticks: at tick t stage s applies
its blocks to microbatch t - s and hands the result to stage s + 1 by P2P
(``batch_isend_irecv``). ``pipeline_blocks`` is one ``torch.autograd.Function``: P2P has no
gradient, so its backward is the reverse schedule written out (each live tick recomputed and
differentiated, the activation gradients handed back a stage per tick), and the last stage's
outputs are broadcast to every stage, so the loss after them runs on every rank.

The parameter trees: ``stack_block_params`` / ``unstack_block_params`` turn a tower's
``resblocks.<i>.*`` entries into one ``[L, ...]`` tensor per leaf and back, and
``to_pipeline_params`` / ``from_pipeline_params`` do it for both towers of a state dict
(``visual_blocks.*``, ``text_blocks.*``), the layout in which the reference shards dim 0 over
``stage``.

``make_pp_train_step`` trains two-tower CLIP (not MoE: a MoE block's parameters do not stack
with the others) on a ``('data', 'stage')`` mesh: the train step of ``train.engine``, with the
towers' block loops swapped for the pipeline (``pipelined``) and a ``Placement`` whose block
parameters are owned by their stage. Every rank builds the whole model; stage s owns blocks
``[s L / S, (s + 1) L / S)`` of each tower, stacks them at use and trains them with the stems
and heads (``pp_parameters`` names what its optimizer holds, so each stage keeps moments for
its own blocks only); the other stages' blocks on a rank are never read or updated there
(``sync_pipeline_blocks`` brings every rank up to date, e.g. before a save).
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimodal_tpu_torch.parallel.collectives import group_rank, group_size
from multimodal_tpu_torch.parallel.mesh import DATA_AXIS, axis_rank, axis_size, create_mesh
from multimodal_tpu_torch.parallel.placement import Placement

STAGE_AXIS = "stage"
TOWERS = (("visual_transformer", "visual_blocks"), ("text_transformer", "text_blocks"))


def create_pp_mesh(data: int, stages: int) -> DeviceMesh:
    if data * stages != dist.get_world_size():
        raise ValueError(f"a {data} x {stages} mesh needs {data * stages} ranks, the run has "
                         f"{dist.get_world_size()}")
    return create_mesh((data, stages), (DATA_AXIS, STAGE_AXIS))


def stack_block_params(tower: dict, prefix: str = "resblocks.") -> tuple[dict, dict]:
    """A tower's entries ``<prefix><i>.<leaf>`` -> (``{leaf: [L, ...]}``, the other entries)."""
    layers: dict = {}
    rest = {}
    for name, t in tower.items():
        if name.startswith(prefix):
            i, leaf = name[len(prefix):].split(".", 1)
            layers.setdefault(int(i), {})[leaf] = t
        else:
            rest[name] = t
    if not layers:
        raise ValueError(f"no {prefix}* entries in the tower")
    order = sorted(layers)
    return {leaf: torch.stack([layers[i][leaf] for i in order]) for leaf in layers[order[0]]}, rest


def unstack_block_params(stacked: dict, prefix: str = "resblocks.") -> dict:
    """Inverse of ``stack_block_params``'s first result."""
    n = next(iter(stacked.values())).shape[0]
    return {f"{prefix}{i}.{leaf}": t[i] for i in range(n) for leaf, t in stacked.items()}


def to_pipeline_params(params: dict) -> dict:
    """A CLIP state dict -> each tower's blocks stacked under ``visual_blocks.`` /
    ``text_blocks.``; every other entry keeps its name."""
    out = dict(params)
    for tower, stacked_name in TOWERS:
        mine = {k[len(tower) + 1:]: out.pop(k) for k in list(out) if k.startswith(tower + ".")}
        stacked, rest = stack_block_params(mine)
        out.update({f"{tower}.{k}": v for k, v in rest.items()})
        out.update({f"{stacked_name}.{leaf}": t for leaf, t in stacked.items()})
    return out


def from_pipeline_params(params: dict) -> dict:
    """Inverse of ``to_pipeline_params``."""
    out = dict(params)
    for tower, stacked_name in TOWERS:
        stacked = {k[len(stacked_name) + 1:]: out.pop(k) for k in list(out)
                   if k.startswith(stacked_name + ".")}
        out.update({f"{tower}.{k}": v for k, v in unstack_block_params(stacked).items()})
    return out


def _handoff(x: torch.Tensor, group, forward: bool) -> torch.Tensor:
    """Send ``x`` a stage on (``forward``) or back and return what the stage on the other
    side sent (zeros at the pipeline's end)."""
    n, s = group_size(group), group_rank(group)
    received = torch.zeros_like(x)
    dst, src = (s + 1, s - 1) if forward else (s - 1, s + 1)
    ops = []
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst),
                              group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, received, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return received


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block_apply, group, keys, x_mb, *stacked):
        n, s = group_size(group), group_rank(group)
        m = x_mb.shape[0]
        local = dict(zip(keys, stacked))

        def apply_local(x):
            for layer in range(stacked[0].shape[0]):
                x = block_apply({k: v[layer] for k, v in local.items()}, x)
            return x

        inputs, outs = {}, [None] * m
        state = torch.zeros_like(x_mb[0])
        for t in range(m + n - 1):
            if 0 <= t - s < m:  # stage s holds microbatch t - s
                inputs[t] = x_mb[t] if s == 0 else state
                cur = apply_local(inputs[t])
            else:
                cur = torch.zeros_like(state)
            if s == n - 1 and t >= n - 1:
                outs[t - (n - 1)] = cur
            if n > 1:
                state = _handoff(cur, group, forward=True)
        out = torch.stack(outs) if s == n - 1 else torch.zeros_like(x_mb)
        if n > 1:
            dist.broadcast(out, src=dist.get_global_rank(group, n - 1), group=group)
        ctx.block_apply, ctx.group, ctx.keys, ctx.inputs = block_apply, group, keys, inputs
        ctx.save_for_backward(x_mb, *stacked)
        return out

    @staticmethod
    def backward(ctx, ct_out):
        x_mb, *stacked = ctx.saved_tensors
        group = ctx.group
        n, s = group_size(group), group_rank(group)
        m = x_mb.shape[0]
        d_x = torch.zeros_like(x_mb)
        d_stacked = [torch.zeros_like(t) for t in stacked]
        send = torch.zeros_like(x_mb[0])
        for t in reversed(range(m + n - 1)):
            ct_cur = _handoff(send, group, forward=False) if n > 1 else torch.zeros_like(send)
            if s == n - 1 and t >= n - 1:
                ct_cur = ct_cur + ct_out[t - (n - 1)]
            send = torch.zeros_like(send)
            if t not in ctx.inputs:
                continue
            with torch.enable_grad():
                x = ctx.inputs[t].detach().requires_grad_(True)
                leaves = [p.detach().requires_grad_(True) for p in stacked]
                local = dict(zip(ctx.keys, leaves))
                y = x
                for layer in range(leaves[0].shape[0]):
                    y = ctx.block_apply({k: v[layer] for k, v in local.items()}, y)
                grads = torch.autograd.grad(y, [x, *leaves], ct_cur, allow_unused=True)
            for acc, g in zip(d_stacked, grads[1:]):
                if g is not None:
                    acc += g
            if s == 0:
                d_x[t] += grads[0]
            else:
                send = grads[0]
        if n > 1:  # the microbatches were the same on every stage, and so is their gradient
            dist.broadcast(d_x, src=dist.get_global_rank(group, 0), group=group)
        return None, None, None, d_x, *d_stacked


def pipeline_blocks(block_apply: Callable, stacked_local: dict, x_microbatches: torch.Tensor,
                    axis_name) -> torch.Tensor:
    """Run ``x_microbatches`` ``[M, mb, ...]`` through the stage-split blocks with the GPipe
    schedule over ``axis_name``'s group (the ``stage`` axis). ``stacked_local``: this
    stage's ``{leaf: [L / S, ...]}``; ``block_apply(block_params, x) -> x`` applies one
    block. The microbatches are the same on every stage (stage 0's enter); returns
    ``[M, mb, ...]``, the same on every stage; differentiable in the stacked leaves (each
    stage's gradient is its own blocks') and in the microbatches (the same on every stage)."""
    keys = list(stacked_local)
    return _Pipeline.apply(block_apply, axis_name, keys, x_microbatches,
                           *(stacked_local[k] for k in keys))


def _stage_layers(mesh: DeviceMesh, layers: int) -> range:
    n = axis_size(mesh, STAGE_AXIS)
    if layers % n:
        raise ValueError(f"{layers} blocks do not split into {n} stages")
    per = layers // n
    s = axis_rank(mesh, STAGE_AXIS)
    return range(s * per, (s + 1) * per)


def _block_owners(model, mesh: DeviceMesh) -> dict:
    """Each block parameter of either tower -> (``stage``, the stage that owns its block)."""
    n = axis_size(mesh, STAGE_AXIS)
    owners = {}
    for tower, _ in TOWERS:
        blocks = getattr(model, tower).resblocks
        if len(blocks) % n:
            raise ValueError(f"{len(blocks)} blocks do not split into {n} stages")
        for i, blk in enumerate(blocks):
            for leaf, _ in blk.named_parameters():
                owners[f"{tower}.resblocks.{i}.{leaf}"] = (STAGE_AXIS, i // (len(blocks) // n))
    return owners


def pp_parameters(model, mesh: DeviceMesh) -> list:
    """(name, parameter) of what this stage trains: the stems, the heads and its own blocks of
    each tower."""
    owners, s = _block_owners(model, mesh), axis_rank(mesh, STAGE_AXIS)
    return [(n, p) for n, p in model.named_parameters() if owners.get(n, (None, s))[1] == s]


@torch.no_grad()
def sync_pipeline_blocks(model, mesh: DeviceMesh):
    """Every rank's copy of every block, from the stage that owns it."""
    group = mesh.get_group(STAGE_AXIS)
    n = axis_size(mesh, STAGE_AXIS)
    for tower, _ in TOWERS:
        blocks = getattr(model, tower).resblocks
        per = len(blocks) // n
        for i, blk in enumerate(blocks):
            for p in blk.parameters():
                dist.broadcast(p.data, src=dist.get_global_rank(group, i // per), group=group)


@contextlib.contextmanager
def pipelined(model, mesh: DeviceMesh, num_microbatches: int):
    """Within the body, both towers' block loops run as the pipeline over ``mesh``'s
    ``stage`` axis, each stage applying its own blocks; the rest of the model (stems,
    pooling, heads) is untouched."""
    group = mesh.get_group(STAGE_AXIS)
    towers = [getattr(model, tower) for tower, _ in TOWERS]

    def blocks_of(tower):
        blocks = tower.resblocks
        template, own = blocks[0], [blocks[i] for i in _stage_layers(mesh, len(blocks))]
        leaves = [n for n, _ in template.named_parameters()]

        def forward(x, causal: bool = False):
            stacked = {leaf: torch.stack([dict(b.named_parameters())[leaf] for b in own])
                       for leaf in leaves}

            def block_apply(bp, h):
                return torch.func.functional_call(template, bp, (h,), {"causal": causal})

            mb = x.reshape((num_microbatches, x.shape[0] // num_microbatches) + x.shape[1:])
            return pipeline_blocks(block_apply, stacked, mb, group).reshape(x.shape)

        return forward

    for tower in towers:
        tower.forward = blocks_of(tower)
    try:
        yield model
    finally:
        for tower in towers:
            del tower.forward


def make_pp_train_step(model, optimizer, *, mesh: DeviceMesh, num_microbatches: int = 2,
                       label_smoothing: float = 0.0, ema_decay=None):
    """The CLIP train step with both towers' blocks pipelined over ``mesh``'s ``stage`` axis
    (the batch split over ``data``; ``optimizer`` built over ``pp_parameters(model, mesh)``):
    ``train.engine.make_train_step``'s step, run with the block loops ``pipelined``, on a
    placement that keeps every parameter whole and gives each block to its stage (its
    gradient and its share of the whole-gradient norm are that stage's alone). The same loss
    and updates as the data-parallel step, since the schedule only reorders the block
    applications. Two-tower, non-variational CLIP with CLS or mean pooling; a MoE trunk
    raises."""
    from multimodal_tpu_torch.train.engine import make_train_step

    c = model.cfg
    if c.share_trunk or c.vision.attentional_pool:
        raise ValueError("the pipeline step covers the two-tower CLIP family")
    if c.vision.moe_experts:
        raise ValueError("the pipeline step does not cover MoE trunks: a MoE block's "
                         "parameters do not stack with the others' over 'stage'; use expert "
                         "parallelism (parallel.ep) for MoE models")
    if optimizer.names != [n for n, _ in pp_parameters(model, mesh)]:
        raise ValueError("the optimizer must be built over pp_parameters(model, mesh)")
    placement = Placement(model, mesh, {}, owners=_block_owners(model, mesh))
    step = make_train_step(model, optimizer, "clip",
                           {"label_smoothing": label_smoothing, "local_loss": True},
                           mesh=mesh, state_shardings=placement, ema_decay=ema_decay)

    def pp_step(state, batch, generator=None):
        with pipelined(model, mesh, num_microbatches):
            return step(state, batch, generator)

    return pp_step
