"""Where each parameter of a model lives on a mesh, and the collectives that follow from it.

JAX hands ``jax.jit`` a sharding for every leaf and GSPMD writes the collectives. Here a
``Placement`` holds a spec per parameter (one mesh axis name or None per dimension, as a
``PartitionSpec``: ``("data", None)`` splits dim 0 over ``data``) and does by hand what
GSPMD does with it:

* each rank keeps its tile of every split parameter (the parameter's storage is the tile,
  so an optimizer built after the placement holds moments of the tile's size);
* ``gathered()`` puts the whole weights into the model for a forward and backward: every
  split dimension all-gathered at use (``collectives.all_gather``), whose gradient is the
  reduce-scatter back onto the tile, so the kernels receive whole weights;
* ``sync_grads()`` reduces every gradient over the mesh axes its parameter is not split
  over;
* ``leaf_norms`` gives the optimizers the norms of whole leaves (the global-norm clip and the
  exact non-finite skip must see the global gradient, not this rank's tiles);
* ``full`` / ``local`` move a tensor between its whole and its tile (checkpoints hold whole
  tensors, so a run resumes at any world size).

A parameter may also be owned: whole, but trained only by the ranks at one coordinate of one
axis (a pipeline stage's blocks, ``parallel.pp``). Its gradient is not reduced over that axis,
the other ranks leave it alone, and only its owners count it in a whole-leaf norm.

Over a batch axis the ranks saw different rows, and the loss's backward already gives each
rank its share of the global gradient: those reductions sum. Over the other axes (``model``,
``expert``, ``stage`` replicas) the ranks computed the same thing from the same rows: those
average.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimodal_tpu_torch.parallel.collectives import _gather, all_gather, all_reduce_
from multimodal_tpu_torch.parallel.mesh import axis_rank, axis_size, batch_axes


def padded_spec(spec, ndim: int) -> tuple:
    """``spec`` as a tuple of ``ndim`` entries (a shorter spec leaves the trailing dims
    whole)."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


class Placement:
    """The placement of ``model``'s parameters on ``mesh`` by ``specs`` (parameter name ->
    spec; a name it lacks stays whole on every rank) and ``owners`` (parameter name ->
    (axis, coordinate) of the ranks that train it). Building it gives every rank rank 0's
    parameters (a broadcast over the world, as DDP does at its start) and cuts every split
    parameter down to this rank's tile in place."""

    def __init__(self, model: torch.nn.Module, mesh: DeviceMesh, specs: dict,
                 owners: dict | None = None):
        self.mesh, self.model, self.owners = mesh, model, owners or {}
        self.batch_axes = batch_axes(mesh)
        self.specs, self.full_shapes, self._slots = {}, {}, {}
        for module_name, module in model.named_modules():
            for attr, p in module.named_parameters(recurse=False):
                name = f"{module_name}.{attr}" if module_name else attr
                self._slots[name] = (module, attr)
        named = dict(model.named_parameters())
        for name, p in named.items():
            spec = padded_spec(specs.get(name, ()), p.ndim)
            for dim, axis in enumerate(spec):
                if axis is not None and p.shape[dim] % axis_size(mesh, axis):
                    raise ValueError(f"{name} dim {dim} ({p.shape[dim]}) does not split over "
                                     f"{axis} ({axis_size(mesh, axis)})")
            self.specs[name], self.full_shapes[name] = spec, tuple(p.shape)
        with torch.no_grad():
            for p in named.values():
                if dist.get_world_size() > 1:
                    dist.broadcast(p.data, src=0)
            for name, p in named.items():
                if self.is_split(name):
                    p.data = self.local(name, p.data).clone()

    def is_split(self, name: str) -> bool:
        return any(a is not None and axis_size(self.mesh, a) > 1 for a in self.specs[name])

    @property
    def any_split(self) -> bool:
        return any(self.is_split(n) for n in self.specs)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's tile of ``full`` (a tensor of ``name``'s whole shape)."""
        t = full
        for dim, axis in enumerate(self.specs[name]):
            if axis is not None:
                n = t.shape[dim] // axis_size(self.mesh, axis)
                t = t.narrow(dim, axis_rank(self.mesh, axis) * n, n)
        return t

    def full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's tile (``local`` this rank's), no gradient."""
        t = local
        for dim, axis in enumerate(self.specs[name]):
            if axis is not None:
                t = _gather(t, self.mesh.get_group(axis), dim)
        return t

    def _gather_for_use(self, name: str, p: torch.Tensor) -> torch.Tensor:
        t = p
        for dim, axis in enumerate(self.specs[name]):
            if axis is not None and axis_size(self.mesh, axis) > 1:
                t = all_gather(t, self.mesh.get_group(axis), dim,
                               op="sum" if axis in self.batch_axes else "avg")
        return t

    @contextlib.contextmanager
    def gathered(self, grad: bool = True):
        """Run the body with the whole weights in the model, gathered with their gradient
        (``grad=False``: without, for an evaluation), then put the tiles back."""
        swapped = []
        try:
            for name in self.specs:
                if self.is_split(name):
                    module, attr = self._slots[name]
                    p = module._parameters[attr]
                    if grad:
                        whole = self._gather_for_use(name, p)
                    else:
                        whole = self.full(name, p.detach())
                    module._parameters[attr] = whole
                    swapped.append((module, attr, p))
            yield self.model
        finally:
            for module, attr, p in swapped:
                module._parameters[attr] = p

    def trains(self, name: str) -> bool:
        """Whether this rank trains ``name``: every rank, or the owners of an owned one."""
        axis, coord = self.owners.get(name, (None, None))
        return axis is None or axis_rank(self.mesh, axis) == coord

    def _reduce_axes(self, name: str) -> tuple:
        owned = self.owners.get(name, (None,))[0]
        return tuple(a for a in self.mesh.mesh_dim_names
                     if a not in self.specs[name] and a != owned and axis_size(self.mesh, a) > 1)

    @torch.no_grad()
    def sync_grads(self):
        """Every trainable parameter's gradient reduced over the mesh axes its parameter is
        not split over: summed over the batch axes, averaged over the others; one flat
        buffer per set of axes and dtype. A parameter the backward did not reach counts
        as a zero gradient."""
        buckets: dict = {}
        for name, p in self.model.named_parameters():
            if not p.requires_grad or not self.trains(name):
                continue
            axes = self._reduce_axes(name)
            if not axes:
                continue
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            buckets.setdefault((axes, p.grad.dtype), []).append(p.grad)
        for (axes, _), grads in buckets.items():
            flat = torch.cat([g.reshape(-1) for g in grads])
            for axis in axes:
                all_reduce_(flat, self.mesh.get_group(axis),
                            "sum" if axis in self.batch_axes else "avg")
            torch._foreach_copy_(grads, [v.view_as(g) for v, g in
                                         zip(flat.split([g.numel() for g in grads]), grads)])

    def _owns(self, name: str) -> bool:
        """Whether this rank's tile of ``name`` counts in a whole-leaf norm: the one rank of
        each set of identical tiles among those that train it (coordinate 0 on every axis
        the leaf is reduced over)."""
        return self.trains(name) and all(axis_rank(self.mesh, a) == 0
                                         for a in self._reduce_axes(name))

    def leaf_norms(self, names: list[str], tensors: list[torch.Tensor]) -> torch.Tensor:
        """The L2 norms of the whole leaves whose tiles on this rank are ``tensors`` (of the
        parameters ``names``), float32, the same on every rank: the owners' squared tile
        norms summed over the world."""
        sq = torch.stack(torch._foreach_norm([t.to(torch.float32) for t in tensors])).square()
        own = torch.tensor([self._owns(n) for n in names], dtype=torch.float32,
                           device=sq.device)
        sq = sq * own
        dist.all_reduce(sq, group=dist.group.WORLD)
        return sq.sqrt()

    def attach(self, optimizer):
        """Give ``optimizer`` (built over the placed parameters) whole-leaf norms when any
        parameter is split or owned; a placement with neither leaves it as it is."""
        if self.any_split or self.owners:
            names = optimizer.names
            optimizer.leaf_norms = lambda tensors, idx=None: self.leaf_norms(
                names if idx is None else [names[i] for i in idx], tensors)
        return optimizer
