"""The optimizers of the port (``multimodal_tpu/train/optimizer.py``): ``wd_mask``,
``fused_adamw`` as the ``FusedAdamW`` optimizer, the modular optax chains that
``make_optimizer`` builds with ``fused=False`` or ``opt="lamb"`` / ``"lars"`` as the
``ChainOptimizer``, the chains' ``clip_and_skip_by_global_norm`` and ``skip_if_nonfinite``
stages, and ``extract_grad_norm``.

Both optimizers update the parameters and their state in place with multi-tensor
(``torch._foreach_*``) ops and never wait on the host. Their ``state_dict()`` holds the
moments by parameter name beside ``count``, ``grad_norm`` and ``notfinite_count`` (and no
callable: the schedule is code, not state), so a run restored from it continues the LR
schedule and the bias correction where it stopped.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

f32 = torch.float32


def wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """True where weight decay applies: ndim >= 2 and not the logit scale."""
    return {name: p.ndim >= 2 and "logit_scale" not in name for name, p in named_params}


class _NamedState:
    """``state_dict()`` / ``load_state_dict()`` by parameter name: the per-parameter slots
    ``SLOTS`` (dicts of name -> tensor) and the scalars ``count``, ``grad_norm`` and
    ``notfinite_count``. The dict holds the live tensors, as torch's does; loading copies
    into them, so they keep their device and dtype."""

    SLOTS: tuple = ()
    SCALARS = ("count", "grad_norm", "notfinite_count")
    # leaf_norms(tensors, idx) -> the norms of whole leaves: set by a placement whose
    # parameters are split over ranks (parallel.placement.Placement.attach); idx names the
    # parameters the tensors belong to (None: all of them, in order)
    leaf_norms = None

    def _norms(self, tensors: list[torch.Tensor], idx=None) -> torch.Tensor:
        """Per-leaf L2 norms of ``tensors``, of whole leaves under a placement."""
        if self.leaf_norms is None:
            return torch.stack(torch._foreach_norm(tensors))
        return self.leaf_norms(tensors, idx)

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    def _slot(self, slot: str) -> dict[str, torch.Tensor]:
        return {n: self.state[p][slot] for n, p in zip(self.names, self._params())}

    def state_dict(self) -> dict:
        return {**{k: getattr(self, k) for k in self.SCALARS},
                **{slot: self._slot(slot) for slot in self.SLOTS}}

    @torch.no_grad()
    def load_state_dict(self, state_dict: dict):
        want = set(self.SCALARS) | set(self.SLOTS)
        if set(state_dict) != want:
            raise ValueError(f"optimizer state has {sorted(state_dict)}, need {sorted(want)}")
        for slot in self.SLOTS:
            mine, theirs = self._slot(slot), state_dict[slot]
            if set(mine) != set(theirs):
                raise ValueError(f"optimizer state {slot!r} names other parameters: missing "
                                 f"{sorted(set(mine) - set(theirs))[:5]}, extra "
                                 f"{sorted(set(theirs) - set(mine))[:5]}")
            for n, t in mine.items():
                if tuple(theirs[n].shape) != tuple(t.shape):
                    raise ValueError(f"optimizer state {slot}[{n!r}] is "
                                     f"{tuple(theirs[n].shape)}, need {tuple(t.shape)}")
                t.copy_(theirs[n])
        for k in self.SCALARS:
            getattr(self, k).copy_(torch.as_tensor(state_dict[k]))


class FusedAdamW(_NamedState, torch.optim.Optimizer):
    """AdamW + global-norm clip + exact non-finite skip + weight-decay masking, the
    semantics of the reference's ``fused_adamw``:

    * one global norm of all gradients, in float32 (a parameter without ``.grad`` counts as
      a zero gradient, as every leaf of a JAX gradient tree is present);
    * clip scale ``min(1, grad_clip_norm / max(norm, 1e-12))``;
    * a non-finite norm skips the step exactly: the update is zero, the moments and the
      parameters stay as they were, and ``count`` does not advance;
    * the LR comes from ``schedule`` at the count before the increment, the bias
      correction uses the count after it;
    * decoupled weight decay on the leaves ``wd_mask`` selects.

    Unlike the JAX transformation, which returns a new state and new parameters, this
    updates the parameters and the moments in place. The JAX state fields stay readable:
    ``count``, ``mu`` and ``nu`` (dicts by parameter name, in ``state_dtype``),
    ``grad_norm`` (the pre-clip norm of the last step) and ``notfinite_count``; the
    scalars are device tensors, so a step never waits on the host. The global norm is
    taken from the per-leaf norms (``torch._foreach_norm``) rather than a sum of squares:
    the same value to a few float32 ulps."""

    SLOTS = ("mu", "nu")
    # the moments live in pinned host memory between steps (parallel.offload)
    offloaded = False

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]],
                 schedule: Union[Callable, float], *, weight_decay: float = 0.2,
                 beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-6,
                 grad_clip_norm: Optional[float] = None, skip_nonfinite: bool = True,
                 state_dtype: torch.dtype = torch.float32):
        named = list(named_params)
        if not named:
            raise ValueError("FusedAdamW got no parameters")
        if state_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"state_dtype must be float32 or bfloat16, got {state_dtype}")
        self.names = [n for n, _ in named]
        self.decay = wd_mask(named)
        super().__init__([p for _, p in named], dict(weight_decay=weight_decay))
        self.schedule = schedule
        self.weight_decay, self.beta1, self.beta2, self.eps = weight_decay, beta1, beta2, eps
        self.grad_clip_norm, self.skip_nonfinite = grad_clip_norm, skip_nonfinite
        self.state_dtype = state_dtype
        device = named[0][1].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.grad_norm = torch.zeros((), dtype=torch.float32, device=device)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=device)
        for _, p in named:
            self.state[p]["mu"] = torch.zeros_like(p, dtype=state_dtype)
            self.state[p]["nu"] = torch.zeros_like(p, dtype=state_dtype)

    def state_dict(self) -> dict:
        if self.offloaded:  # the last step's copies to the host must have landed
            torch.cuda.synchronize(self.count.device)
        return super().state_dict()

    def load_state_dict(self, state_dict: dict):
        if self.offloaded:
            torch.cuda.synchronize(self.count.device)
        super().load_state_dict(state_dict)

    @property
    def mu(self) -> dict[str, torch.Tensor]:
        return self._slot("mu")

    @property
    def nu(self) -> dict[str, torch.Tensor]:
        return self._slot("nu")

    @torch.no_grad()
    def step(self, closure=None):
        """One update over all leaves with multi-tensor (``torch._foreach_*``) ops: a few
        launches per step instead of ~20 per leaf, and no host sync. The exact skip works
        without branching on the host: on a non-finite step the gradients are zeroed first,
        so every candidate value stays finite, and ``keep`` (1 or 0) selects the new or the
        old moments and parameters with products that are exact for 0 and 1."""
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        params = self._params()
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).to(f32)
                 for p in params]
        norm = self._norms(grads).square().sum().sqrt()
        scale = torch.ones((), dtype=f32, device=norm.device)
        if self.grad_clip_norm is not None:
            scale = torch.clamp(self.grad_clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
        finite = torch.isfinite(norm)
        if self.skip_nonfinite:
            scale = torch.where(finite, scale, torch.zeros_like(scale))
            count = self.count + finite.to(torch.int32)
        else:
            count = self.count + 1
        # LR at the pre-increment count, bias correction at the post-increment count
        lr = self.schedule(self.count) if callable(self.schedule) else self.schedule
        c1 = 1.0 - torch.pow(self.beta1, count.to(f32))
        c2 = 1.0 - torch.pow(self.beta2, count.to(f32))
        step_size = -lr * torch.ones((), dtype=f32, device=norm.device)
        if self.skip_nonfinite:
            keep = finite.to(f32)
            zero = torch.zeros((), dtype=f32, device=norm.device)
            grads = [torch.where(finite, g, zero) for g in grads]
            one = torch.ones_like(c1)
            c1, c2 = torch.where(finite, c1, one), torch.where(finite, c2, one)
            step_size = step_size * keep
        b1, b2 = self.beta1, self.beta2
        states = [self.state[p] for p in params]
        mu_old = [st["mu"] for st in states]
        nu_old = [st["nu"] for st in states]
        if self.offloaded:  # the moments come from the host for the update and go back
            mu_host, nu_host = mu_old, nu_old
            device = norm.device
            mu_old = [m.to(device, non_blocking=True) for m in mu_host]
            nu_old = [n.to(device, non_blocking=True) for n in nu_host]
        if self.state_dtype != f32:
            mu_old32, nu_old32 = [m.to(f32) for m in mu_old], [n.to(f32) for n in nu_old]
        else:
            mu_old32, nu_old32 = mu_old, nu_old

        g = torch._foreach_mul(grads, scale)
        mu_new = torch._foreach_mul(mu_old32, b1)
        torch._foreach_add_(mu_new, torch._foreach_mul(g, 1.0 - b1))
        g_sq = torch._foreach_mul(g, g)
        torch._foreach_mul_(g_sq, 1.0 - b2)
        nu_new = torch._foreach_mul(nu_old32, b2)
        torch._foreach_add_(nu_new, g_sq)
        del g, g_sq
        upd = torch._foreach_div(mu_new, c1)
        den = torch._foreach_div(nu_new, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        decayed = [i for i, n in enumerate(self.names) if self.decay[n]]
        if decayed:
            torch._foreach_add_([upd[i] for i in decayed],
                                torch._foreach_mul([params[i] for i in decayed],
                                                   self.weight_decay))
        torch._foreach_mul_(upd, step_size)  # -lr, or 0 on a skipped step
        torch._foreach_add_(params, upd)
        if self.state_dtype != f32:
            mu_new = [m.to(self.state_dtype) for m in mu_new]
            nu_new = [n.to(self.state_dtype) for n in nu_new]
        if self.skip_nonfinite:
            # old * (1 - keep) + new * keep: exactly one side is kept, both are finite
            for old, new in ((mu_old, mu_new), (nu_old, nu_new)):
                torch._foreach_mul_(old, 1.0 - keep)
                torch._foreach_mul_(new, keep)
                torch._foreach_add_(old, new)
            self.notfinite_count.copy_(torch.where(finite, torch.zeros_like(count),
                                                   self.notfinite_count + 1))
        else:
            torch._foreach_copy_(mu_old, mu_new)
            torch._foreach_copy_(nu_old, nu_new)
        if self.offloaded:
            torch._foreach_copy_(mu_host, mu_old, non_blocking=True)
            torch._foreach_copy_(nu_host, nu_old, non_blocking=True)
        self.count.copy_(count)
        self.grad_norm.copy_(norm)
        return None


def _local_norms(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(tensors))


def clip_and_skip_by_global_norm(grads: list[torch.Tensor], clip_norm: Optional[float],
                                 skip_nonfinite: bool,
                                 norms=_local_norms) -> tuple[list[torch.Tensor], torch.Tensor]:
    """The chains' first stage: one float32 global norm of ``grads`` (the stage's state,
    returned beside the scaled gradients), the clip scale ``min(1, clip_norm / max(norm,
    1e-12))``, and with ``skip_nonfinite`` a zero scale when the norm is not finite (a
    non-finite element stays non-finite, 0 * nan being nan, as in the reference). ``norms``
    gives the per-leaf norms (of whole leaves under a placement)."""
    grads = [g.to(f32) for g in grads]
    norm = norms(grads).square().sum().sqrt()
    scale = torch.ones((), dtype=f32, device=norm.device)
    if clip_norm is not None:
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
    if skip_nonfinite:
        scale = torch.where(torch.isfinite(norm), scale, torch.zeros_like(scale))
    return torch._foreach_mul(grads, scale), norm


@torch.no_grad()
def skip_if_nonfinite(finite: torch.Tensor, old: list[torch.Tensor], new: list[torch.Tensor],
                      notfinite_count: torch.Tensor):
    """The exact skip around a chain: ``old`` takes ``new``'s values on a finite step and
    keeps its own on a non-finite one, in place, and ``notfinite_count`` counts the
    non-finite steps in a row. ``new`` must be finite either way (the chain computes it from
    gradients selected to zero on a non-finite step): the select is two products, exact for
    a keep of 0 or 1, not a branch."""
    keep = finite.to(f32)
    torch._foreach_mul_(old, 1.0 - keep)
    torch._foreach_add_(old, torch._foreach_mul(new, keep))
    notfinite_count.copy_(torch.where(finite, torch.zeros_like(notfinite_count),
                                      notfinite_count + 1))


def _trust_ratio(updates: list[torch.Tensor], params: list[torch.Tensor],
                 coefficient: float = 1.0, norms=_local_norms) -> list[torch.Tensor]:
    """optax ``scale_by_trust_ratio`` (min_norm 0, eps 0): each update times ``coefficient
    * |param| / |update|``, or times 1 where either norm is zero. ``norms`` gives the
    per-leaf norms (of whole leaves under a placement)."""
    p_norm = norms(params)
    u_norm = norms(updates)
    ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                        coefficient * p_norm / u_norm)
    return torch._foreach_mul(updates, list(ratio.unbind(0)))


class ChainOptimizer(_NamedState, torch.optim.Optimizer):
    """The modular optax chains of ``make_optimizer`` as one optimizer, stage for stage
    (optax 0.2.6), after ``clip_and_skip_by_global_norm`` and inside ``skip_if_nonfinite``:

    * ``adamw`` (``fused=False``): scale_by_adam -> masked add_decayed_weights -> LR;
    * ``lamb``: scale_by_adam -> masked add_decayed_weights -> scale_by_trust_ratio -> LR;
    * ``lars``: masked add_decayed_weights -> masked scale_by_trust_ratio (coefficient
      0.001) -> LR -> trace (momentum ``beta1``): the momentum comes after the LR.

    The masks are ``wd_mask``. The LR is the schedule at ``count`` before the step and the
    bias correction uses the count after it; on a skipped step ``count``, the moments and
    the trace stay as they were and the parameters do not move. ``grad_norm`` is the
    pre-clip norm of the last step, non-finite or not."""

    def __init__(self, named_params: Iterable[tuple[str, torch.nn.Parameter]],
                 schedule: Union[Callable, float], *, opt: str = "adamw",
                 weight_decay: float = 0.2, beta1: float = 0.9, beta2: float = 0.98,
                 eps: float = 1e-6, grad_clip_norm: Optional[float] = None,
                 skip_nonfinite: bool = True):
        named = list(named_params)
        if not named:
            raise ValueError("ChainOptimizer got no parameters")
        if opt not in ("adamw", "lamb", "lars"):
            raise ValueError(f"unknown optimizer {opt!r} (adamw | lamb | lars)")
        self.opt = opt
        self.SLOTS = ("trace",) if opt == "lars" else ("mu", "nu")
        self.names = [n for n, _ in named]
        self.decay = wd_mask(named)
        super().__init__([p for _, p in named], dict(weight_decay=weight_decay))
        self.schedule = schedule
        self.weight_decay, self.beta1, self.beta2, self.eps = weight_decay, beta1, beta2, eps
        self.grad_clip_norm, self.skip_nonfinite = grad_clip_norm, skip_nonfinite
        device = named[0][1].device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.grad_norm = torch.zeros((), dtype=f32, device=device)
        self.notfinite_count = torch.zeros((), dtype=torch.int32, device=device)
        for _, p in named:
            for slot in self.SLOTS:
                self.state[p][slot] = torch.zeros_like(p, dtype=f32)

    def _decayed(self, updates, params) -> None:
        """add_decayed_weights on the leaves ``wd_mask`` selects, in place."""
        idx = [i for i, n in enumerate(self.names) if self.decay[n]]
        if idx and self.weight_decay:
            torch._foreach_add_([updates[i] for i in idx],
                                torch._foreach_mul([params[i].to(f32) for i in idx],
                                                   self.weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ChainOptimizer.step takes no closure")
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        g, norm = clip_and_skip_by_global_norm(grads, self.grad_clip_norm, self.skip_nonfinite,
                                               self._norms)
        finite = torch.isfinite(norm)
        if self.skip_nonfinite:  # 0 * nan is nan: select, so every candidate stays finite
            zero = torch.zeros((), dtype=f32, device=norm.device)
            g = [torch.where(finite, x, zero) for x in g]
        lr = self.schedule(self.count) if callable(self.schedule) else self.schedule
        neg_lr = -lr * torch.ones((), dtype=f32, device=norm.device)
        count = self.count + 1
        if self.opt == "lars":
            upd = list(g)
            self._decayed(upd, params)
            idx = [i for i, n in enumerate(self.names) if self.decay[n]]
            if idx:
                scaled = _trust_ratio([upd[i] for i in idx], [params[i].to(f32) for i in idx],
                                      coefficient=0.001,
                                      norms=lambda ts: self._norms(ts, idx))
                for i, u in zip(idx, scaled):
                    upd[i] = u
            torch._foreach_mul_(upd, neg_lr)
            old = [self.state[p]["trace"] for p in params]
            new = torch._foreach_mul(old, self.beta1)
            torch._foreach_add_(new, upd)  # trace = update + momentum * trace
            upd = new
        else:
            mu_old = [self.state[p]["mu"] for p in params]
            nu_old = [self.state[p]["nu"] for p in params]
            mu = torch._foreach_mul(g, 1.0 - self.beta1)
            torch._foreach_add_(mu, torch._foreach_mul(mu_old, self.beta1))
            nu = torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.beta2)
            torch._foreach_add_(nu, torch._foreach_mul(nu_old, self.beta2))
            c1 = 1.0 - torch.pow(self.beta1, count.to(f32))
            c2 = 1.0 - torch.pow(self.beta2, count.to(f32))
            den = torch._foreach_div(nu, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            upd = torch._foreach_div(torch._foreach_div(mu, c1), den)
            del den
            self._decayed(upd, params)
            if self.opt == "lamb":
                upd = _trust_ratio(upd, [p.to(f32) for p in params], norms=self._norms)
            torch._foreach_mul_(upd, neg_lr)
            old, new = mu_old + nu_old, mu + nu
        if self.skip_nonfinite:
            torch._foreach_mul_(upd, finite.to(f32))
            skip_if_nonfinite(finite, old, new, self.notfinite_count)
            self.count.copy_(torch.where(finite, count, self.count))
        else:
            torch._foreach_copy_(old, new)
            self.count.copy_(count)
        torch._foreach_add_(params, [u.to(p.dtype) for u, p in zip(upd, params)])
        self.grad_norm.copy_(norm)
        return None


def make_optimizer(named_params, schedule, weight_decay: float = 0.2, beta1: float = 0.9,
                   beta2: float = 0.98, eps: float = 1e-6,
                   grad_clip_norm: Optional[float] = None, skip_nonfinite: bool = True,
                   max_consecutive_nonfinite: int = 100, fused: bool = True,
                   opt: str = "adamw", state_dtype: torch.dtype = torch.float32):
    """The optimizer over ``named_params`` (e.g. ``model.named_parameters()``): by default
    the fused AdamW; ``fused=False`` the modular AdamW chain and ``opt="lamb"`` /
    ``"lars"`` the trust-ratio chains (``ChainOptimizer``; LARS's momentum is ``beta1``).
    Reduced-precision moments (``state_dtype``) only exist in the fused AdamW; asking for
    them with another optimizer raises ``ValueError``, as in the reference.
    ``max_consecutive_nonfinite`` is accepted and unused, as in the reference."""
    if state_dtype != torch.float32 and (opt != "adamw" or not fused):
        raise ValueError(
            f"--opt-state-dtype {str(state_dtype).replace('torch.', '')} is only honored by "
            f"the fused adamw path (got opt={opt!r}, fused={fused}); drop the flag or use "
            "the default optimizer")
    if opt not in ("adamw", "lamb", "lars"):
        raise ValueError(f"unknown optimizer {opt!r} (adamw | lamb | lars)")
    if opt != "adamw" or not fused:
        return ChainOptimizer(named_params, schedule, opt=opt, weight_decay=weight_decay,
                              beta1=beta1, beta2=beta2, eps=eps, grad_clip_norm=grad_clip_norm,
                              skip_nonfinite=skip_nonfinite)
    return FusedAdamW(named_params, schedule, weight_decay=weight_decay, beta1=beta1,
                      beta2=beta2, eps=eps, grad_clip_norm=grad_clip_norm,
                      skip_nonfinite=skip_nonfinite, state_dtype=state_dtype)


def extract_grad_norm(optimizer) -> Optional[torch.Tensor]:
    """The pre-clip gradient norm of the last step, or None for an optimizer without one."""
    return getattr(optimizer, "grad_norm", None)
