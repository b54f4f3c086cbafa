"""Loss-dynamics test bench: Riemannian SGD of point pairs on S^1 under the vCLIP loss (port
of ``multimodal_tpu/research/loss_bench.py``).

N unit-vector pairs on the circle, Riemannian SGD on the means (the tangent-space projection of
the gradient, then the exponential map) and plain SGD on the concentrations, ``steps`` steps of
the port's ``vclip_loss``, tracking pair arc lengths, gradient norms and concentrations,
summarized in the summary_statistics.txt format. The steps run as a loop on the device; every
draw (the initial points, then each step's Monte-Carlo samples, image first) comes from one
``torch.Generator``, and the host reads the history once, at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from multimodal_tpu_torch.distributions import PowerSpherical, ProjectedNormal, VonMisesFisher
from multimodal_tpu_torch.losses.vclip_loss import vclip_loss
from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.ops.sphere import l2_normalize

DISTRIBUTIONS = ("power_spherical", "vmf", "projected_normal")


def _make_dists(name, mu_a, conc_a, mu_b, conc_b):
    if name == "power_spherical":
        return PowerSpherical(mu_a, conc_a), PowerSpherical(mu_b, conc_b)
    if name == "vmf":
        return VonMisesFisher(mu_a, conc_a), VonMisesFisher(mu_b, conc_b)
    if name == "projected_normal":
        return (ProjectedNormal(mu_a * conc_a[..., None], torch.ones_like(mu_a)),
                ProjectedNormal(mu_b * conc_b[..., None], torch.ones_like(mu_b)))
    raise ValueError(name)


def riemannian_project(grad: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Project an ambient gradient onto the tangent space at x."""
    return grad - (grad * x).sum(dim=-1, keepdim=True) * x


def exponential_map(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The sphere's exponential map at x of the tangent vector v."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    safe = torch.clamp(norm, min=1e-12)
    return torch.where(norm < 1e-12, x, torch.cos(norm) * x + torch.sin(norm) * (v / safe))


def arc_length(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Great-circle angle between paired unit vectors, in degrees."""
    return torch.rad2deg(torch.arccos(torch.clamp((a * b).sum(dim=-1), -1.0, 1.0)))


@dataclasses.dataclass
class BenchResult:
    distribution: str
    final_total_loss: float
    final_contrastive_loss: float
    final_kl_loss: float
    initial_concentration_a: float
    final_concentration_a: float
    initial_concentration_b: float
    final_concentration_b: float
    initial_arc_deg: float
    final_arc_deg: float
    grad_norm_first: float
    grad_norm_last: float
    history: Optional[dict] = None

    def summary_text(self) -> str:
        """summary_statistics.txt format (distribution_training_comparisons/*/)."""
        return "\n".join([
            f"Distribution: {self.distribution}",
            "",
            "Final losses:",
            f"  total: {self.final_total_loss:.4f}",
            f"  contrastive: {self.final_contrastive_loss:.4f}",
            f"  kl: {self.final_kl_loss:.4f}",
            "",
            "Concentrations (A):"
            f" {self.initial_concentration_a:.3f} -> {self.final_concentration_a:.3f}",
            "Concentrations (B):"
            f" {self.initial_concentration_b:.3f} -> {self.final_concentration_b:.3f}",
            "",
            "Mean pair arc length:"
            f" {self.initial_arc_deg:.2f} deg -> {self.final_arc_deg:.2f} deg",
            "",
            f"Gradient norms: first {self.grad_norm_first:.4f}, last {self.grad_norm_last:.4f}",
        ])


HISTORY_KEYS = ("total", "contrastive", "kl", "grad_norm", "arc", "conc_a", "conc_b")


def initial_state(n_points: int, dim: int, initial_concentration: float,
                  generator: torch.Generator, device) -> tuple:
    """(mu_a, mu_b, raw_conc): unit points, their partners slightly perturbed, and the direct
    concentrations of both sets, all float32 on ``device``; the draws from ``generator``."""
    like = torch.empty((), dtype=torch.float32, device=device)
    mu_a = l2_normalize(draws.standard_normal((n_points, dim), generator, like))
    # B starts as slightly-perturbed A so pairs begin close (the reference's 0.26 deg init)
    mu_b = l2_normalize(mu_a + 0.005 * draws.standard_normal((n_points, dim), generator, like))
    # concentrations are direct SGD parameters, like the reference bench's leaf tensors
    return mu_a, mu_b, torch.full((2, n_points), initial_concentration, device=device)


def bench_step(distribution: str, state: tuple, generator: torch.Generator, *,
               lr: float = 0.05, conc_lr: float = 0.01, kl_weight: float = 0.01,
               mc_samples: int = 8) -> tuple:
    """One step from ``state``: (the next state, the step's ``HISTORY_KEYS`` as 0-d
    tensors). The loss's Monte-Carlo draws come from ``generator``, image samples first."""
    mu_a, mu_b, raw_conc = state
    device = mu_a.device
    logit_scale = torch.tensor(2.6592, device=device)  # ln(1/0.07), CLIP's temperature
    floor = torch.tensor(1e-3, device=device)
    leaves = [t.detach().requires_grad_(True) for t in state]
    conc = torch.maximum(leaves[2], floor)  # jnp.maximum's gradient: halved at a tie
    da, db = _make_dists(distribution, leaves[0], conc[0], leaves[1], conc[1])
    res = vclip_loss(da, db, conc[0], conc[1], logit_scale, generator=generator,
                     kl_weight=kl_weight, num_samples=mc_samples, var_reg_weight=0.0,
                     label_smoothing=0.0)
    ga, gb, gc = torch.autograd.grad(res["total_loss"], leaves)
    with torch.no_grad():
        mu_a = exponential_map(mu_a, -lr * riemannian_project(ga, mu_a))
        mu_b = exponential_map(mu_b, -lr * riemannian_project(gb, mu_b))
        raw_conc = torch.maximum(raw_conc - conc_lr * gc, floor)
        stats = {"total": res["total_loss"], "contrastive": res["clip_loss"],
                 "kl": res["image_kl_loss"] + res["text_kl_loss"],
                 "grad_norm": torch.sqrt(ga.square().sum() + gb.square().sum()
                                         + gc.square().sum()),
                 "arc": arc_length(mu_a, mu_b).mean(), "conc_a": raw_conc[0].mean(),
                 "conc_b": raw_conc[1].mean()}
    return (mu_a, mu_b, raw_conc), {k: v.detach() for k, v in stats.items()}


def run_loss_bench(
    distribution: str = "power_spherical",
    n_points: int = 20,
    dim: int = 2,
    steps: int = 1000,
    lr: float = 0.05,
    conc_lr: float = 0.01,
    initial_concentration: float = 0.1,
    kl_weight: float = 0.01,
    mc_samples: int = 8,
    seed: int = 0,
    keep_history: bool = False,
    *,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> BenchResult:
    """Train paired points with Riemannian SGD on the means and plain SGD on the (direct,
    positivity-clamped) concentrations under ``vclip_loss``, on ``device`` (the GPU unless
    the caller asks for ``"cpu"``); return the summary statistics. The draws come from
    ``generator`` (by default one on ``device`` seeded with ``seed``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_loss_bench(device='cuda'): no CUDA device is available; pass "
                           "device='cpu' to run it on the CPU")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    state = initial_state(n_points, dim, initial_concentration, generator, device)
    init_arc = arc_length(state[0], state[1]).mean()
    hist: dict = {k: [] for k in HISTORY_KEYS}
    for _ in range(steps):
        state, stats = bench_step(distribution, state, generator, lr=lr, conc_lr=conc_lr,
                                  kl_weight=kl_weight, mc_samples=mc_samples)
        for k in HISTORY_KEYS:
            hist[k].append(stats[k])
    hist = {k: torch.stack(v).cpu().numpy() for k, v in hist.items()}

    return BenchResult(
        distribution=distribution,
        final_total_loss=float(hist["total"][-1]),
        final_contrastive_loss=float(hist["contrastive"][-1]),
        final_kl_loss=float(hist["kl"][-1]),
        initial_concentration_a=initial_concentration,
        final_concentration_a=float(hist["conc_a"][-1]),
        initial_concentration_b=initial_concentration,
        final_concentration_b=float(hist["conc_b"][-1]),
        initial_arc_deg=float(init_arc),
        final_arc_deg=float(hist["arc"][-1]),
        grad_norm_first=float(hist["grad_norm"][0]),
        grad_norm_last=float(hist["grad_norm"][-1]),
        history=hist if keep_history else None,
    )


def main(argv=None):
    """CLI: regenerate the summary_statistics.txt artifacts for all three distributions."""
    import argparse
    import os

    p = argparse.ArgumentParser("vclip loss bench")
    p.add_argument("--out-dir", default="loss_bench_results")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--distributions", nargs="*", default=list(DISTRIBUTIONS))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    for dist in args.distributions:
        res = run_loss_bench(dist, steps=args.steps, seed=args.seed, device=args.device)
        d = os.path.join(args.out_dir, dist)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "summary_statistics.txt")
        with open(path, "w") as f:
            f.write(res.summary_text() + "\n")
        print(f"{dist}: arc {res.initial_arc_deg:.2f} -> {res.final_arc_deg:.2f} deg, "
              f"conc {res.initial_concentration_a:.2f} -> {res.final_concentration_a:.2f} "
              f"({path})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
