"""Mixture-of-Experts MLP (port of ``multimodal_tpu/models/moe.py``: ``load_balance_loss``,
``MoEMLP`` and ``collect_moe_losses``).

E experts live as stacked parameters (``w1`` [E, W, H], ``b1`` [E, H], ``w2`` [E, H, W],
``b2`` [E, W]); a float32 router picks the top k of them per token in k rounds of argmax
(first index on a tie, as ``jnp.argmax``). Routing runs within groups, one group per
sequence: each expert takes at most C = max(1, int(cf * S * k / E)) tokens of a group, the
slot counter runs on across the rounds, and a token past capacity is dropped (its MLP branch
is zero, so it rides the residual). Dispatch and combine are one-hot einsums in the compute
dtype; with k > 1 the combine weights of a token are renormalized over its chosen experts.
The expert products are ``torch.einsum`` (the reference's are einsums outside any Pallas
kernel). Each forward keeps its load-balance term in ``last_aux`` (assigned, so a remat
recompute does not count it twice); ``collect_moe_losses`` sums a model's terms.
"""

from __future__ import annotations

import torch
from torch import nn

from multimodal_tpu_torch.models.layers import Dense, normal_, quick_gelu


def load_balance_loss(router_probs: torch.Tensor, expert_mask: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer aux loss E * sum_e f_e p_e (1 at uniform routing): f_e the share of
    tokens sent to expert e (``expert_mask`` [..., S, E], summed over the k rounds; no
    gradient), p_e the mean router probability; means over the token axis, then over any
    leading group axes."""
    num_experts = router_probs.shape[-1]
    frac_tokens = expert_mask.mean(dim=-2)
    mean_probs = router_probs.mean(dim=-2)
    return num_experts * (frac_tokens * mean_probs).sum(dim=-1).mean()


def top_k_rounds(probs: torch.Tensor, top_k: int) -> list[torch.Tensor]:
    """The chosen expert of each token in each of ``top_k`` rounds ([G, S] int64 each): the
    argmax of the probabilities not chosen in an earlier round."""
    remaining, chosen = probs, []
    for _ in range(top_k):
        idx = remaining.argmax(dim=-1)
        chosen.append(idx)
        remaining = remaining * (1.0 - nn.functional.one_hot(idx, probs.shape[-1]).to(probs.dtype))
    return chosen


class MoEMLP(nn.Module):
    """The MLP of a MoE block: x [G, S, W] -> [G, S, W]. Parameters float32, products in
    ``dtype``; the router (``router.kernel`` [W, E], ``router.bias``) in float32."""

    def __init__(self, width: int, num_experts: int, expansion: float = 4.0, act=None,
                 dtype: torch.dtype = torch.float32, depth: int = 12, top_k: int = 1,
                 capacity_factor: float = 1.25):
        super().__init__()
        self.width, self.num_experts, self.dtype = width, num_experts, dtype
        self.hidden = int(width * expansion)
        self.act = act or quick_gelu
        self.depth, self.top_k, self.capacity_factor = depth, top_k, capacity_factor
        e, w, h = num_experts, width, self.hidden
        self.router = Dense(w, e, w ** -0.5)
        self.w1 = nn.Parameter(torch.empty(e, w, h))
        self.b1 = nn.Parameter(torch.zeros(e, h))
        self.w2 = nn.Parameter(torch.empty(e, h, w))
        self.b2 = nn.Parameter(torch.zeros(e, w))
        self.last_aux: torch.Tensor | None = None

    def init_weights(self, generator: torch.Generator):
        normal_(self.w1, (2 * self.width) ** -0.5, generator)
        normal_(self.w2, (self.width ** -0.5) * ((2 * self.depth) ** -0.5), generator)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def capacity(self, seq: int) -> int:
        """Slots per expert in a group of ``seq`` tokens."""
        return max(1, int(self.capacity_factor * seq * self.top_k / self.num_experts))

    def router_probs(self, x: torch.Tensor) -> torch.Tensor:
        """The router's softmax over the experts, float32 [G, S, E]."""
        return torch.softmax(x.to(torch.float32) @ self.router.kernel + self.router.bias, dim=-1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, s, _ = x.shape
        e, cap = self.num_experts, self.capacity(s)
        probs = self.router_probs(x)
        f32 = torch.float32
        dispatch = torch.zeros(g, s, e, cap, dtype=f32, device=x.device)
        combine = torch.zeros_like(dispatch)
        mask_sum = torch.zeros(g, s, e, dtype=f32, device=x.device)
        assigned = torch.zeros(g, s, e, dtype=f32, device=x.device)  # kept one-hots so far
        for idx in top_k_rounds(probs.detach(), self.top_k):
            onehot = nn.functional.one_hot(idx, e).to(f32)
            gate = (probs * onehot).sum(dim=-1)
            # each token's slot within its expert's capacity, after earlier rounds' kept ones
            pos = ((onehot.cumsum(dim=1) - 1 + assigned.sum(dim=1, keepdim=True)) * onehot).sum(-1)
            keep = (pos < cap).to(f32) * onehot.sum(dim=-1)
            slot = nn.functional.one_hot(pos.long().clamp(max=cap - 1), cap).to(f32)
            disp_k = (onehot * keep[..., None])[..., :, None] * slot[..., None, :]
            dispatch = dispatch + disp_k
            combine = combine + disp_k * gate[..., None, None]
            mask_sum = mask_sum + onehot
            assigned = assigned + onehot * keep[..., None]
        self.last_aux = load_balance_loss(probs, mask_sum)
        if self.top_k > 1:
            combine = combine / torch.clamp(combine.sum(dim=(2, 3), keepdim=True), min=1e-9)
        cd = self.dtype
        xe = torch.einsum("gsec,gsw->gecw", dispatch.to(cd), x.to(cd))
        h = self.act(torch.einsum("gecw,ewh->gech", xe, self.w1.to(cd))
                     + self.b1.to(cd)[None, :, None, :])
        ye = torch.einsum("gech,ehw->gecw", h, self.w2.to(cd)) + self.b2.to(cd)[None, :, None, :]
        return torch.einsum("gsec,gecw->gsw", combine.to(cd), ye)


def collect_moe_losses(model: nn.Module) -> torch.Tensor:
    """The sum of the load-balance terms of ``model``'s MoE layers from their last forward;
    0.0 (float32) when it has none."""
    terms = [m.last_aux for m in model.modules()
             if isinstance(m, MoEMLP) and m.last_aux is not None]
    if not terms:
        device = next(model.parameters()).device
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.stack(terms).sum()
