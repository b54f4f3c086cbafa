"""The rank programs of the port's distributed CPU tests, and their launcher.

``run_ranks(session, world, inputs, tmp)`` starts ``world`` processes of this file (gloo, the
``env://`` convention of ``torch.distributed.run``: RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT), hands them ``inputs`` (a dict of tensors and plain values, through a torch
file) and returns what each rank returns. A session is one process group: every check of a
test file runs in it, so a file starts few groups. The ranks import torch and the port only,
never JAX; the test files, which do import JAX, compare what they return with the JAX
package.
"""

import contextlib
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)  # tests/test_torch_train_step.py's


@contextlib.contextmanager
def world_of_one():
    """A gloo process group of this process alone, for the length of the block: a mesh
    form run at world size 1."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    return env


def run_ranks(session: str, world: int, inputs: dict, tmp, timeout: float = 240,
              torchrun: bool = False) -> list:
    """Run ``session`` on ``world`` ranks (one process each, or with ``torchrun`` under
    ``python -m torch.distributed.run``); each rank's result, in rank order."""
    path = os.path.join(str(tmp), f"{session}-{world}.inputs.pt")
    torch.save(inputs, path)
    port = free_port()
    script = [os.path.abspath(__file__), session, path, str(tmp)]
    procs = []
    launches = ([(0, [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
                      str(world), "--master-port", str(port)] + script)] if torchrun
                else [(r, [sys.executable] + script) for r in range(world)])
    for rank, cmd in launches:
        log = open(os.path.join(str(tmp), f"{session}-{world}.rank{rank}.log"), "w")
        env = rank_env(rank, world, port)
        if torchrun:  # the launcher sets the ranks' environment itself
            for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
                env.pop(key)
        procs.append((subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for rank, (proc, log) in enumerate(procs):
        if proc.returncode:
            with open(log.name) as f:
                raise AssertionError(f"rank {rank} of {session} exited {proc.returncode}:\n"
                                     + f.read()[-6000:])
    return [torch.load(os.path.join(str(tmp), f"{session}-{world}.rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# ---------------------------------------------------------------- the ranks' side


def _model(name: str, params: dict, siglip: bool = False):
    from multimodal_tpu_torch.models import create_model

    model = create_model(name, device="cpu", siglip=siglip)
    model.load_state_dict(params)
    return model


def _optimizer(named):
    from multimodal_tpu_torch.train import make_optimizer, make_schedule

    return make_optimizer(named, make_schedule("cosine", 1e-3, 2, 50), **OPT)


def _whole(model, placement) -> dict:
    return {n: (placement.full(n, p.detach()) if placement is not None and placement.is_split(n)
                else p.detach()).clone() for n, p in model.named_parameters()}


def _train(inputs: dict, case: dict, mesh, place=None, steps: int = 2) -> dict:
    """``steps`` steps of one case on ``mesh``: the metrics, the whole parameters after them,
    and under a splitting placement each split leaf's (tile, whole, moment tile) sizes."""
    from multimodal_tpu_torch.parallel.mesh import shard_batch
    from multimodal_tpu_torch.train import TrainState, make_train_step

    siglip = case.get("siglip", False)
    model = _model(case["model"], inputs["params"][case["model"] + ("+siglip" if siglip else "")],
                   siglip)
    placement = place(model, mesh) if place is not None else None
    opt = _optimizer(model.named_parameters())
    step = make_train_step(model, opt, loss_type=case.get("loss", "clip"),
                           loss_kwargs=case.get("loss_kwargs"), mesh=mesh,
                           state_shardings=placement)
    state = TrainState.create(model, opt)
    batch = shard_batch(inputs["batch"][case["model"]], mesh)
    metrics = [{k: float(v) for k, v in step(state, batch).items()} for _ in range(steps)]
    out = {"metrics": metrics, "params": _whole(model, placement)}
    if placement is not None:
        out["sizes"] = {n: (p.numel(), placement.full(n, p.detach()).numel(), opt.mu[n].numel())
                        for n, p in model.named_parameters() if placement.is_split(n)}
        out["state"], out["placement"] = state, placement
    return out


DP_CASES = {
    "local_loss": {"loss_kwargs": {"local_loss": True}},
    "global_matrix": {"loss_kwargs": {"local_loss": False}},
    "chunked": {"loss_kwargs": {"contrastive_impl": "chunked", "chunk_size": 4}},
    "ring": {"loss_kwargs": {"contrastive_impl": "ring"}},
    "ring_label_smoothing": {"loss_kwargs": {"contrastive_impl": "ring",
                                             "label_smoothing": 0.1}},
    "siglip_ring": {"loss": "siglip", "siglip": True},
    "align": {"loss": "align"},
    "cloob": {"loss": "cloob"},
}


def session_dp(inputs: dict) -> dict:
    from multimodal_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh()
    out = {}
    for name, case in DP_CASES.items():
        res = _train(inputs, {"model": "tiny-test", **case}, mesh)
        out[name] = {"metrics": res["metrics"],
                     "params": res["params"] if dist.get_rank() == 0 else None}
    return out


def session_sharded(inputs: dict) -> dict:
    from multimodal_tpu_torch.parallel import (
        create_ep_mesh,
        create_hybrid_mesh,
        create_mesh,
        create_tp_mesh,
        shard_model_ep,
        shard_model_fsdp,
        shard_model_fsdp_tp,
        shard_model_tp,
    )
    from multimodal_tpu_torch.train.run import checkpoint_state, restore_state

    w = dist.get_world_size()
    cases = {
        "fsdp": ("tiny-test", create_mesh, shard_model_fsdp),
        "tp": ("tiny-test", lambda: create_tp_mesh(w // 2, 2), shard_model_tp),
        "fsdp_tp": ("tiny-test", lambda: create_tp_mesh(w // 2, 2), shard_model_fsdp_tp),
        "ep": ("tiny-test-moe", lambda: create_ep_mesh(w // 2, 2), shard_model_ep),
        "hybrid_fsdp": ("tiny-test", lambda: create_hybrid_mesh(2), shard_model_fsdp),
    }
    out = {}
    for name, (model_name, make_mesh, place) in cases.items():
        mesh = make_mesh()
        res = _train(inputs, {"model": model_name}, mesh, place)
        out[name] = {"metrics": res["metrics"], "sizes": res["sizes"],
                     "params": res["params"] if dist.get_rank() == 0 else None}
        if name == "fsdp":  # a checkpoint holds whole tensors and restores into the tiles
            args = SimpleNamespace(seed=0)
            saved = checkpoint_state(res["state"], args, res["placement"])
            fresh = _model(model_name, inputs["params"][model_name])
            placement = place(fresh, mesh)
            from multimodal_tpu_torch.train import TrainState

            state = TrainState.create(fresh, _optimizer(fresh.named_parameters()))
            restore_state(state, saved, False, placement)
            same = all(torch.equal(p, q) for p, q in zip(
                fresh.parameters(), res["state"].model.parameters()))
            same = same and all(torch.equal(state.optimizer.mu[n], res["state"].optimizer.mu[n])
                                for n in state.optimizer.names)
            out["checkpoint"] = {"restored_tiles_equal": same, "step": saved["step"],
                                 "model": saved["model"] if dist.get_rank() == 0 else None,
                                 "mu": saved["optimizer"]["mu"] if dist.get_rank() == 0 else None}
    return out


def session_ring_attention(inputs: dict) -> dict:
    from multimodal_tpu_torch.ops.ring_attention import ring_attention

    group = dist.group.WORLD
    r, w = dist.get_rank(), dist.get_world_size()
    out = {}
    for causal in (False, True):
        for key in ("fwd", "grad"):
            q, k, v = (t.chunk(w, dim=1)[r].clone().requires_grad_(True)
                       for t in inputs[key])
            o = ring_attention(q, k, v, group, causal=causal)
            gq, gk, gv = torch.autograd.grad(torch.sin(o).sum(), (q, k, v))
            out[(key, causal)] = {"out": o.detach(), "grads": (gq, gk, gv)}
    return out


def session_pp(inputs: dict) -> dict:
    from multimodal_tpu_torch.parallel.mesh import axis_rank, shard_batch
    from multimodal_tpu_torch.parallel.pp import (
        create_pp_mesh,
        make_pp_train_step,
        pipeline_blocks,
        pp_parameters,
        sync_pipeline_blocks,
    )
    from multimodal_tpu_torch.train import TrainState

    w = dist.get_world_size()
    out = {}
    blocks, x = inputs["blocks"], inputs["x"]
    n_layers = blocks["w"].shape[0]

    def block_apply(bp, h):
        return torch.tanh(h @ bp["w"] + bp["b"])

    for stages, micro in inputs["pp_cases"]:
        mesh = create_pp_mesh(w // stages, stages)
        group, s = mesh.get_group("stage"), axis_rank(mesh, "stage")
        per = n_layers // stages
        leaves = {k: v.clone().requires_grad_(True) for k, v in blocks.items()}
        xx = x.clone().requires_grad_(True)
        local = {k: v[s * per:(s + 1) * per] for k, v in leaves.items()}
        b = x.shape[0]
        y = pipeline_blocks(block_apply, local, xx.reshape((micro, b // micro) + x.shape[1:]),
                            group).reshape(x.shape)
        gw, gb, gx = torch.autograd.grad(torch.square(y).mean(), [leaves["w"], leaves["b"], xx])
        for g in (gw, gb):  # each stage holds its blocks' gradient; every stage the input's
            dist.all_reduce(g, group=group)
        out[(stages, micro)] = {"y": y.detach(), "grads": (gw, gb, gx)}

    mesh = create_pp_mesh(w // 2, 2)
    model = _model("tiny-test", inputs["params"]["tiny-test"])
    opt = _optimizer(pp_parameters(model, mesh))
    step = make_pp_train_step(model, opt, mesh=mesh, num_microbatches=2)
    state = TrainState.create(model, opt)
    batch = shard_batch(inputs["batch"]["tiny-test"], mesh)
    metrics = [{k: float(v) for k, v in step(state, batch).items()} for _ in range(2)]
    sync_pipeline_blocks(model, mesh)
    out["train"] = {"metrics": metrics, "params": _whole(model, None),
                    "optimizer_leaves": len(opt.names)}
    return out


def session_cli(inputs: dict) -> dict:
    """The CLI's ``main`` for every flag set of ``inputs["runs"]`` (under this process group),
    this rank's rows of the first synthetic batch, and the timing of the preemption flag."""
    from multimodal_tpu_torch.data.synthetic import SyntheticBatches
    from multimodal_tpu_torch.parallel.mesh import create_mesh
    from multimodal_tpu_torch.train import run

    out = {"runs": {}}
    for name, argv in inputs["runs"].items():
        assert run.main(argv) == 0
        out["runs"][name] = run.resolve_experiment_name(SimpleNamespace(name=None, model="m",
                                                                        loss="l"))
    rows = run.RankRows(SyntheticBatches(batch_size=8, num_samples=16, image_size=32,
                                         context_length=16, vocab_size=1000), create_mesh())
    out["rows"] = next(iter(rows))["text"]
    # the flag's agreement: the first poll returns at once, whatever the other rank does;
    # the second reads the first's all-reduce
    flag = run.StopFlag(dist.new_group(backend="gloo"))
    if dist.get_rank() == 1:
        time.sleep(1.0)
        run._PREEMPTED.set()
    t0 = time.perf_counter()
    first = flag.poll()
    t1 = time.perf_counter()
    second = flag.poll()
    third = flag.poll()
    out["flag"] = {"first_s": t1 - t0, "polls": (first, second, third)}
    run._PREEMPTED.clear()
    return out


SESSIONS = {"dp": session_dp, "sharded": session_sharded,
            "ring_attention": session_ring_attention, "pp": session_pp, "cli": session_cli}


def main():
    session, inputs_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo")
    inputs = torch.load(inputs_path, weights_only=False)
    result = SESSIONS[session](inputs)
    torch.save(result, os.path.join(out_dir, f"{session}-{dist.get_world_size()}"
                                             f".rank{dist.get_rank()}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()
