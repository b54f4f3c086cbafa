"""Ring attention: attention over a sequence split across the ranks of a group (port of
``multimodal_tpu/ops/ring_attention.py``).

Rank i holds the query, key and value block of positions ``[i S, (i + 1) S)``. Its query
block stays; the key/value blocks go round the ring (n - 1 hops), and each visited block is
one call of the flash kernels (``ops.flash_attention``):

* forward: ``flash_attention_fwd`` gives the block's normalized output and its row
  logsumexp; the blocks merge by their logsumexps in float32;
* backward: ``flash_attention_dq`` and ``flash_attention_dkv`` per visited block with the
  *global* logsumexp and ``delta = rowsum(do * out)``, so each block's probabilities are the
  global ones; the dK/dV accumulators travel the ring with their blocks and one more hop brings
  them home.

Causal masking by global position: a block wholly in the future is skipped; the diagonal
block is one causal call with sq = sk, where the flash kernels' top-left mask is the
reference's; earlier blocks are unmasked.

The schedule (``_Ring``: the visits, the merge and the backward accumulation) is written
once and takes its transport as an argument. ``ring_attention`` gives it ``GroupRing``, which
moves blocks between ranks with ``parallel.collectives.ring_shift``; ``ring_attention_blocks``
gives it ``LocalRing``, the n blocks of one sequence on one device rotated as a list, which is
how one card runs the same code.

Numerics: the reference merges unnormalized float32 numerators. Here each block's output
comes out of the flash forward in the input dtype: in float32 the merge is exact to rounding;
in bfloat16 each block's output is rounded to bfloat16 before the float32 merge, one rounding
more than a single flash call over the whole sequence makes.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops.flash_attention import (
    _scale,
    flash_attention_dkv,
    flash_attention_dq,
    flash_attention_fwd,
    flash_delta,
)
from multimodal_tpu_torch.parallel.collectives import group_rank, group_size, ring_shift


def _visit(q_idx: int, kv_idx: int, causal: bool):
    """The flash call's ``causal`` flag for query block ``q_idx`` meeting key block
    ``kv_idx``, or None when every key of the block lies in every query's future."""
    if causal and kv_idx > q_idx:
        return None
    return causal and kv_idx == q_idx


def forward_block(q, k, v, q_idx: int, kv_idx: int, causal: bool, sm_scale: float):
    """(out, lse) of one visited block, or None for a skipped one."""
    flag = _visit(q_idx, kv_idx, causal)
    if flag is None:
        return None
    return flash_attention_fwd(q, k, v, causal=flag, sm_scale=sm_scale)


def merge(acc, block):
    """Fold a block's (out, lse) into the running (float32 out, lse): both rescaled to the
    merged logsumexp."""
    out, lse = block
    out = out.to(torch.float32)
    if acc is None:
        return out, lse
    acc_out, acc_lse = acc
    new = torch.logaddexp(acc_lse, lse)
    w_acc = torch.exp(acc_lse - new).transpose(1, 2)[..., None]  # [B, H, S] -> [B, S, H, 1]
    w_blk = torch.exp(lse - new).transpose(1, 2)[..., None]
    return acc_out * w_acc + out * w_blk, new


def backward_block(q, k, v, do, lse, delta, q_idx: int, kv_idx: int, causal: bool,
                   sm_scale: float):
    """(dq, dk, dv) of one visited block from the global ``lse`` and ``delta``, or None."""
    flag = _visit(q_idx, kv_idx, causal)
    if flag is None:
        return None
    kw = dict(causal=flag, sm_scale=sm_scale)
    return (flash_attention_dq(q, k, v, do, lse, delta, **kw),
            *flash_attention_dkv(q, k, v, do, lse, delta, **kw))


class GroupRing:
    """Transport over a process group: this rank holds one block (its own), and a shift is
    ``ring_shift``, every rank sending to the next."""

    def __init__(self, group):
        self.group, self.n, self.blocks = group, group_size(group), [group_rank(group)]

    @staticmethod
    def split(x):
        return [x]

    @staticmethod
    def join(xs):
        return xs[0]

    def shift(self, held):
        return [ring_shift(held[0], self.group)]


class LocalRing:
    """Transport on one device: the ``n`` blocks of one sequence, and a shift is a rotation
    of the list, block i taking what block i - 1 held, as rank i takes from rank i - 1."""

    def __init__(self, n: int):
        self.n, self.blocks = n, list(range(n))

    def split(self, x):
        return [c.contiguous() for c in x.chunk(self.n, dim=1)]

    @staticmethod
    def join(xs):
        return torch.cat(xs, dim=1)

    @staticmethod
    def shift(held):
        return held[-1:] + held[:-1]


class _Ring(torch.autograd.Function):
    """The ring's schedule: each held query block meets the key/value blocks as the
    transport brings them round (n - 1 shifts); in the backward the dK/dV accumulators
    travel with their blocks and one more shift brings them home. ``ring`` is the transport:
    ``n`` blocks in all, ``blocks`` the indices of those held here, ``split`` / ``join``
    between a tensor and its held blocks, ``shift`` moving what each held block carries one
    place on."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal: bool, sm_scale: float):
        qs, ks, vs = ring.split(q), ring.split(k), ring.split(v)
        n, m = ring.n, len(ring.blocks)
        accs, held = [None] * m, [[kb, vb] for kb, vb in zip(ks, vs)]
        for t in range(n):
            if t:
                held = ring.shift(held)
            for s, i in enumerate(ring.blocks):
                block = forward_block(qs[s], *held[s], i, (i - t) % n, causal, sm_scale)
                if block is not None:
                    accs[s] = merge(accs[s], block)
        outs = [acc[0].to(q.dtype) for acc in accs]
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *(acc[1] for acc in accs))
        ctx.ring, ctx.causal, ctx.sm_scale = ring, causal, sm_scale
        return ring.join(outs)

    @staticmethod
    def backward(ctx, do):
        ring = ctx.ring
        n, m = ring.n, len(ring.blocks)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * m:(i + 1) * m] for i in range(5))
        dt, f32 = qs[0].dtype, torch.float32
        dos = ring.split(do.to(dt))
        deltas = [flash_delta(o, d) for o, d in zip(outs, dos)]
        dqs = [torch.zeros(c.shape, dtype=f32, device=c.device) for c in qs]
        held = [[kb, vb, torch.zeros(kb.shape, dtype=f32, device=kb.device),
                 torch.zeros(vb.shape, dtype=f32, device=vb.device)] for kb, vb in zip(ks, vs)]
        for t in range(n):
            if t:  # K/V and their gradient accumulators travel together
                held = ring.shift(held)
            for s, i in enumerate(ring.blocks):
                grads = backward_block(qs[s], held[s][0], held[s][1], dos[s], lses[s],
                                       deltas[s], i, (i - t) % n, ctx.causal, ctx.sm_scale)
                if grads is not None:
                    dqs[s] += grads[0]
                    held[s][2] += grads[1]
                    held[s][3] += grads[2]
        home = ring.shift([h[2:] for h in held])  # each accumulator home to its block
        return (ring.join(dqs).to(dt), ring.join([h[0] for h in home]).to(dt),
                ring.join([h[1] for h in home]).to(dt), None, None, None)


def ring_attention(q, k, v, axis_name, *, causal: bool = False, sm_scale: float | None = None):
    """Sequence-split attention over ``axis_name``'s group (a process group; None: one rank).
    q, k, v: this rank's blocks ``[B, S_local, H, D]``, rank i holding positions
    ``[i S_local, (i + 1) S_local)``; returns this rank's output block in q's dtype."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return _Ring.apply(q, k, v, GroupRing(axis_name), causal, _scale(q, sm_scale))


def ring_attention_blocks(q, k, v, n: int, *, causal: bool = False,
                          sm_scale: float | None = None):
    """The ring's schedule on one device: q, k, v ``[B, S, H, D]`` cut into ``n`` blocks of
    the sequence, moved round by ``LocalRing`` through the same schedule as
    ``ring_attention``; differentiable."""
    if q.shape[1] % n:
        raise ValueError(f"a sequence of {q.shape[1]} does not split into {n} blocks")
    return _Ring.apply(q, k, v, LocalRing(n), causal, _scale(q, sm_scale))
