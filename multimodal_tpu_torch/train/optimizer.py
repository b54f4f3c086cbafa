"""Fused AdamW with a global-norm clip, an exact non-finite skip and weight-decay masking
(port of ``multimodal_tpu/train/optimizer.py``: ``wd_mask``, ``fused_adamw`` as the
``FusedAdamW`` optimizer, ``make_optimizer`` and ``extract_grad_norm``).

Not ported yet (``make_optimizer`` raises ``NotImplementedError``): LAMB, LARS and the
modular optax chain (``fused=False``), ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch


def wd_mask(named_params: Iterable[tuple[str, torch.Tensor]]) -> dict[str, bool]:
    """True where weight decay applies: ndim >= 2 and not the logit scale."""
    return {name: p.ndim >= 2 and "logit_scale" not in name for name, p in named_params}


class FusedAdamW(torch.optim.Optimizer):
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
        super().__init__([p for _, p in named], dict(lr=schedule, weight_decay=weight_decay))
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

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.param_groups for p in group["params"]]

    @property
    def mu(self) -> dict[str, torch.Tensor]:
        return {n: self.state[p]["mu"] for n, p in zip(self.names, self._params())}

    @property
    def nu(self) -> dict[str, torch.Tensor]:
        return {n: self.state[p]["nu"] for n, p in zip(self.names, self._params())}

    @torch.no_grad()
    def step(self, closure=None):
        """One update over all leaves with multi-tensor (``torch._foreach_*``) ops: a few
        launches per step instead of ~20 per leaf, and no host sync. The exact skip works
        without branching on the host: on a non-finite step the gradients are zeroed first,
        so every candidate value stays finite, and ``keep`` (1 or 0) selects the new or the
        old moments and parameters with products that are exact for 0 and 1."""
        if closure is not None:
            raise ValueError("FusedAdamW.step takes no closure")
        f32 = torch.float32
        params = self._params()
        grads = [(p.grad if p.grad is not None else torch.zeros_like(p)).to(f32)
                 for p in params]
        norm = torch.stack(torch._foreach_norm(grads)).square().sum().sqrt()
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
        self.count.copy_(count)
        self.grad_norm.copy_(norm)
        return None


def make_optimizer(named_params, schedule, weight_decay: float = 0.2, beta1: float = 0.9,
                   beta2: float = 0.98, eps: float = 1e-6,
                   grad_clip_norm: Optional[float] = None, skip_nonfinite: bool = True,
                   max_consecutive_nonfinite: int = 100, fused: bool = True,
                   opt: str = "adamw", state_dtype: torch.dtype = torch.float32) -> FusedAdamW:
    """The fused AdamW over ``named_params`` (e.g. ``model.named_parameters()``). Only the
    fused AdamW is ported; ``max_consecutive_nonfinite`` is accepted and unused, as in the
    reference."""
    if opt in ("lamb", "lars"):
        raise NotImplementedError(f"opt={opt!r} is not ported yet (ROADMAP Queue 1 item 8)")
    if opt != "adamw":
        raise ValueError(f"unknown optimizer {opt!r} (adamw | lamb | lars)")
    if not fused:
        raise NotImplementedError("fused=False (the modular optax chain) is not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    return FusedAdamW(named_params, schedule, weight_decay=weight_decay, beta1=beta1,
                      beta2=beta2, eps=eps, grad_clip_norm=grad_clip_norm,
                      skip_nonfinite=skip_nonfinite, state_dtype=state_dtype)


def extract_grad_norm(optimizer) -> Optional[torch.Tensor]:
    """The pre-clip gradient norm of the last step, or None for an optimizer without one."""
    return getattr(optimizer, "grad_norm", None)
