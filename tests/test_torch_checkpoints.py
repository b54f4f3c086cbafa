"""The port's checkpoints (``train/checkpoints.py``, torch files) and the optimizers' named
state: a bit-for-bit round trip of the model, the fused AdamW's ``count``, moments and
``notfinite_count``, the chain optimizers' state, the EMA and the step; ``max_to_keep``; a
save cut short is never listed; an asynchronous save holds the state as it was when ``save``
returned, whatever the steps after it do; and a resumed optimizer continues its LR schedule
and bias correction at the saved count. Everything is compared exactly (``torch.equal``).
"""

import io
import os
import threading
import time

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.models import create_model
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step
from multimodal_tpu_torch.train import checkpoints as ckpt_mod
from multimodal_tpu_torch.train.checkpoints import CheckpointManager
from multimodal_tpu_torch.train.run import checkpoint_state, restore_state

torch.set_num_threads(1)

OPTS = {"fused-adamw": {}, "adamw-chain": {"fused": False}, "lamb": {"opt": "lamb"},
        "lars": {"opt": "lars"}}


class _Args:
    seed = 3


def _batch(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    return {"image": torch.from_numpy(rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)),
            "text": torch.from_numpy(rng.integers(1, cfg.text.vocab_size - 1,
                                                  (n, cfg.text.context_length)))}


def _trained(opt_kw, steps=2, ema=True, poison_last=True):
    """A tiny-test model and optimizer after ``steps`` steps (the last one's gradient made
    non-finite, so ``notfinite_count`` is 1), with its EMA."""
    model = create_model("tiny-test", device="cpu", seed=1)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50),
                         weight_decay=0.1, grad_clip_norm=1.0, **opt_kw)
    step = make_train_step(model, opt, ema_decay=0.9 if ema else None)
    state = TrainState.create(model, opt, ema=ema)
    for i in range(steps):
        data = _batch(model.cfg, seed=i)
        if poison_last and i == steps - 1:
            data["image"] = data["image"].float() * float("nan")
        step(state, data)
    return state


def _fresh(opt_kw, ema=True):
    model = create_model("tiny-test", device="cpu", seed=2)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50),
                         weight_decay=0.1, grad_clip_norm=1.0, **opt_kw)
    return TrainState.create(model, opt, ema=ema)


def _assert_same(a: TrainState, b: TrainState):
    assert a.step == b.step
    for (n, p), (m, q) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert n == m and torch.equal(p, q), n
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        if isinstance(sa[k], dict):
            assert set(sa[k]) == set(sb[k])
            for n in sa[k]:
                assert torch.equal(sa[k][n], sb[k][n]), (k, n)
        else:  # the last step's grad norm is nan
            torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, equal_nan=True)
    assert (a.ema is None) == (b.ema is None)
    for n in a.ema or {}:
        assert torch.equal(a.ema[n], b.ema[n]), n


@pytest.mark.parametrize("name", sorted(OPTS))
def test_round_trip_is_bit_for_bit(tmp_path, name):
    state = _trained(OPTS[name])
    assert int(state.optimizer.notfinite_count) == 1 and int(state.optimizer.count) == 1
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state.step, checkpoint_state(state, _Args), metadata={"epoch": 0})
    saved, meta = mgr.restore()
    assert meta == {"epoch": 0} and saved["seed"] == 3 and saved["step"] == 2
    fresh = _fresh(OPTS[name])
    restore_state(fresh, saved, model_ema=True)
    _assert_same(state, fresh)


def test_optimizer_state_holds_no_callable_and_names_every_moment():
    state = _trained({})
    sd = state.optimizer.state_dict()
    assert set(sd) == {"count", "grad_norm", "notfinite_count", "mu", "nu"}
    assert set(sd["mu"]) == {n for n, _ in state.model.named_parameters()}

    def walk(node):
        assert not callable(node) or isinstance(node, torch.Tensor), node
        for v in (node.values() if isinstance(node, dict) else []):
            walk(v)

    walk(sd)
    torch.save(sd, io.BytesIO())  # picklable: the schedule closure is not in it


@pytest.mark.parametrize("name", sorted(OPTS))
def test_resumed_optimizer_continues_the_schedule_at_the_saved_count(name):
    """Three steps, the state through torch.save and into a fresh optimizer, then a fourth
    step on both: the same parameters bit for bit, count 4 (the LR at count 3 and the bias
    correction at 4), as the uninterrupted optimizer."""
    torch.manual_seed(0)
    shapes = {"w.kernel": (6, 4), "b": (4,), "logit_scale": ()}
    grads = [{k: torch.randn(s) for k, s in shapes.items()} for _ in range(4)]
    init = {k: torch.randn(s) for k, s in shapes.items()}

    def build():
        params = {k: torch.nn.Parameter(v.clone()) for k, v in init.items()}
        return params, make_optimizer(params.items(), make_schedule("cosine", 1e-2, 2, 10),
                                      weight_decay=0.1, grad_clip_norm=1.0, **OPTS[name])

    def step(params, opt, g):
        for k, p in params.items():
            p.grad = g[k].clone()
        opt.step()

    pa, oa = build()
    for g in grads[:3]:
        step(pa, oa, g)
    buf = io.BytesIO()
    torch.save({"params": {k: p.detach() for k, p in pa.items()},
                "optimizer": oa.state_dict()}, buf)
    buf.seek(0)
    saved = torch.load(buf, weights_only=True)
    pb, ob = build()
    with torch.no_grad():
        for k, p in pb.items():
            p.copy_(saved["params"][k])
    ob.load_state_dict(saved["optimizer"])
    assert int(ob.count) == 3
    step(pa, oa, grads[3])
    step(pb, ob, grads[3])
    assert int(ob.count) == 4 == int(oa.count)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_load_refuses_another_models_state():
    a = _trained({}, steps=1, poison_last=False)
    other = create_model("tiny", device="cpu")
    opt = make_optimizer(other.named_parameters(), 1e-3)
    with pytest.raises(ValueError):
        opt.load_state_dict(a.optimizer.state_dict())


def test_max_to_keep_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in (1, 2, 3, 5):
        mgr.save(s, {"x": torch.tensor(float(s))}, metadata={"s": s})
    assert mgr.all_steps() == [3, 5] and mgr.latest_step() == 5
    mgr.delete(5)
    saved, meta = mgr.restore()
    assert meta == {"s": 3} and float(saved["x"]) == 3.0
    assert CheckpointManager(str(tmp_path / "none")).restore() == (None, None)


def test_a_save_cut_short_is_never_listed(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.ones(3)}, metadata={"epoch": 0})

    class Crash(Exception):
        pass

    def cut(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise Crash  # the process dies mid-write

    monkeypatch.setattr(ckpt_mod.torch, "save", cut)
    with pytest.raises(Crash):
        mgr.save(2, {"x": torch.zeros(3)}, metadata={"epoch": 1})
    monkeypatch.undo()
    assert os.path.isdir(tmp_path / ".2.tmp") and not os.path.exists(tmp_path / "2")
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.all_steps() == [1] and fresh.latest_step() == 1
    saved, meta = fresh.restore()
    assert torch.equal(saved["x"], torch.ones(3)) and meta == {"epoch": 0}
    fresh.save(2, {"x": torch.zeros(3)})  # a later save of the same step replaces the debris
    assert fresh.all_steps() == [1, 2] and not os.path.exists(tmp_path / ".2.tmp")


def test_async_save_holds_the_state_of_when_save_returned(tmp_path, monkeypatch):
    """The write is slowed so that later steps run while it is in flight: the steps update
    the parameters and moments in place, and the checkpoint must not see them."""
    state = _trained({}, steps=2, poison_last=False)
    before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    mu_before = {n: t.clone() for n, t in state.optimizer.mu.items()}
    real_save, writing = torch.save, threading.Event()

    def slow_save(obj, path):
        writing.set()
        time.sleep(0.5)
        real_save(obj, path)

    monkeypatch.setattr(ckpt_mod.torch, "save", slow_save)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(state.step, checkpoint_state(state, _Args), metadata={"epoch": 0})
    assert writing.wait(5)
    step = make_train_step(state.model, state.optimizer, ema_decay=0.9)
    for i in range(2):
        step(state, _batch(state.model.cfg, seed=10 + i))
    mgr.wait()
    saved, _ = mgr.restore()
    assert saved["step"] == 2 and state.step == 4
    for n, p in state.model.named_parameters():
        assert torch.equal(saved["model"][n], before[n]), n
        assert torch.equal(saved["optimizer"]["mu"][n], mu_before[n]), n
    assert any(not torch.equal(p, before[n]) for n, p in state.model.named_parameters())
    mgr.close()
