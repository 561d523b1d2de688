"""One rank of the port's multi-process tests (tests/test_torch_multiprocess.py).

Run as ``python tests/torch_dist_worker.py <work dir> <rank> <world>``: joins
a gloo process group through ``file://<work dir>/pg`` (no port, so parallel
test workers cannot collide), runs every case of ``<work dir>/inputs.pt`` in
order, each on the dp mesh of the whole world or on the (dp, tp|sp|cp|pp)
mesh its ``mesh`` entry names (("tp", 2): ``make_mesh(tp=2)``), and writes
``<work dir>/<case>_<rank>.pt`` for each.  Imports torch and the port only.
"""

import os
import signal
import sys

import numpy as np
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, REPO)

from visitron_torch import agents as ta  # noqa: E402
from visitron_torch import data as td  # noqa: E402
from visitron_torch import parallel  # noqa: E402
from visitron_torch.models import BertConfig  # noqa: E402
from visitron_torch.testing import SyntheticWorld  # noqa: E402
from visitron_torch.train import PretrainTrainer  # noqa: E402
from visitron_torch.train.preemption import PreemptionGuard  # noqa: E402


def _runtime(world: dict):
    """The runtime of the parent's synthetic world: its graphs, and the
    scene features the parent drew."""
    tw = SyntheticWorld(**world["kw"])
    return ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, world["feats"], vfov=60), device="cpu")


def _flat(params: dict) -> dict:
    return {f"{part}/{k}": v for part, sub in params.items() for k, v in sub.items()}


def case_pretrain(mesh, inp):
    """Two pretraining steps on this rank's rows of the global batches."""
    trainer = PretrainTrainer(BertConfig(**inp["bert"]), mesh=mesh, zero1=inp["zero1"],
                              fsdp=inp["fsdp"], total_steps=100,
                              learning_rate=inp["lr"], device="cpu")
    state = trainer.init_state(params=inp["params"])
    local = sum(t.numel() for t in parallel.mesh._leaves(state["opt_state"])
                if isinstance(t, torch.Tensor))
    at_rest = {k: v.shape for k, v in state["params"].items()}
    step = trainer.step_fn()
    bundles = []
    for batch in inp["batches"]:
        state, bundle = step(state, parallel.shard_batch(mesh, batch))
        bundles.append({k: float(v) for k, v in bundle.items()})
    params, opt = trainer.dp.gather(state["params"], state["opt_state"])
    return {"params": params, "bundles": bundles, "opt_numel": local,
            "param_numel": sum(t.numel() for t in state["params"].values()),
            "shapes": at_rest, "local": dict(state["params"]),
            "mu": opt[1]["mu"] if inp.get("moments") else None}


def _agent_step(mesh, inp, agent, state, batch):
    step = {"teacher": agent.train_step_fn,
            "sample": lambda: agent.sample_train_step_fn("argmax")}[inp.get("feedback",
                                                                         "teacher")]()
    state, loss = step(state, parallel.shard_batch(mesh, batch, inp.get("axes")))
    params, _ = agent.dp.gather(state["params"], state["opt_state"])
    return {"params": _flat(params), "loss": float(loss), "local": _flat(state["params"]),
            "opt_numel": sum(t.numel() for t in parallel.mesh._leaves(state["opt_state"])
                             if isinstance(t, torch.Tensor))}


def case_viewpoint(mesh, inp):
    agent = ta.ViewpointAgent(BertConfig(**inp["bert"]), _runtime(inp["world"]),
                              **inp["agent"], device="cpu", mesh=mesh, zero1=inp["zero1"])
    return _agent_step(mesh, inp, agent, agent.init_state(params=inp["params"]),
                       inp["batch"])


def case_turn_based(mesh, inp):
    from visitron_torch.agents.turn_based import TurnBasedAgent

    agent = TurnBasedAgent(BertConfig(**inp["bert"]), _runtime(inp["world"]),
                           **inp["agent"], device="cpu", mesh=mesh)
    return _agent_step(mesh, inp, agent, agent.init_state(params=inp["params"]),
                       inp["batch"])


def case_classifier(mesh, inp):
    from visitron_torch.agents.classifier import ClassifierAgent

    agent = ClassifierAgent(BertConfig(**inp["bert"]), _runtime(inp["world"]),
                            **inp["agent"], device="cpu", mesh=mesh)
    items = inp["items"]
    n = len(items) // mesh.dp
    batch = agent.prepare_batch(items[mesh.dp_index * n:(mesh.dp_index + 1) * n],
                                event_items=items)
    state = agent.init_state(params=inp["params"])
    state, loss = agent.train_step_fn()(state, batch)
    params, _ = agent.dp.gather(state["params"], state["opt_state"])
    return {"params": _flat(params), "loss": float(loss)}


def case_ring(mesh, inp):
    """The ring attention of this rank's blocks of global (B, H, S, D) q/k/v
    (tokens over cp, rows over dp) and of a (B, S) key bias: its output and
    the gradients of sum(out * g) for its blocks."""
    from visitron_torch.ops.ring_attention import ring_attention

    rows = slice(mesh.dp_index * inp["q"].shape[0] // mesh.dp,
                 (mesh.dp_index + 1) * inp["q"].shape[0] // mesh.dp)
    lo, hi = parallel.token_range(mesh, inp["q"].shape[2])
    q, k, v = (inp[n][rows, :, lo:hi].clone().requires_grad_() for n in ("q", "k", "v"))
    out = ring_attention(q, k, v, inp["bias"][rows, lo:hi].contiguous(), inp["seed"],
                         inp["rate"], mesh=mesh)
    (out * inp["g"][rows, :, lo:hi]).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}


def case_p2p(mesh, inp):
    """The point-to-point helper (``parallel.mesh.p2p``) on this rank's
    tensors, direct and with staging forced: a ring shift (the other rank's
    tensors come back) and a stage send / receive each way; then the public
    ``ring_shift`` and ``send_next`` / ``recv_prev`` / ``send_prev`` /
    ``recv_next``.  A staged send's source is overwritten before the wait:
    the receiver must get the values it had when the send was issued."""
    from visitron_torch.parallel import mesh as pm

    mine = [t[mesh.rank].clone() for t in inp["tensors"]]
    dst, src = pm._neighbours(mesh, 1)
    other = 1 - mesh.rank
    out = {}
    for staged in (False, True):
        parallel.reset_collective_counts()
        sent = [t.clone() for t in mine]
        work = pm.p2p([(t, dst) for t in sent], [(t.shape, t.dtype, src) for t in sent],
                      mesh.device, mesh.axis_group, staged=staged)
        if staged:
            for t in sent:
                t.fill_(-7)
        ring = work.wait()
        if mesh.rank == 0:
            pm.p2p([(mine[0], other)], [], mesh.device, staged=staged).wait()
            stage = pm.p2p([], [(mine[1].shape, mine[1].dtype, other)], mesh.device,
                           staged=staged).wait()[0]
        else:
            stage = pm.p2p([], [(mine[0].shape, mine[0].dtype, other)], mesh.device,
                           staged=staged).wait()[0]
            pm.p2p([(mine[1], other)], [], mesh.device, staged=staged).wait()
        out[staged] = {"ring": ring, "stage": stage, "calls": pm.p2p_host_staged.calls,
                       "nbytes": pm.p2p_host_staged.nbytes}
    parallel.reset_collective_counts()
    public = {"ring": parallel.ring_shift(mine, mesh).finish()}
    if mesh.rank == 0:
        parallel.send_next(mine[0], mesh)
        public["stage"] = parallel.recv_next(mine[1].shape, mine[1].dtype, mesh)
    else:
        public["stage"] = parallel.recv_prev(mine[0].shape, mine[0].dtype, mesh)
        parallel.send_prev(mine[1], mesh)
    return {**out, "public": public}


def case_history(mesh, inp):
    """The text model's forward with history K/V states on this rank's
    blocks of the full parameters (the plain attention on its heads), and
    the gradients of sum(seq * g), gathered into the single-device layout."""
    from visitron_torch.models import VisitronBert, config_for_mesh

    model = VisitronBert(config_for_mesh(BertConfig(**inp["bert"]), mesh), image=False)
    dp = parallel.DataParallel(mesh)
    dp.plan(inp["params"], tp_kinds=parallel.shard_params_rules(model))
    local = {k: v.clone().requires_grad_() for k, v in dp.tp_local(inp["params"]).items()}
    seq, _ = torch.func.functional_call(model, local, (inp["ids"],),
                                        {"history_states": inp["history"]})
    (seq * inp["g"]).sum().backward()
    grads = {k: v.grad for k, v in local.items()}
    split = {k: g for k, g in grads.items() if g is not None}
    grads.update(dp.tp_full(split))
    return {"seq": seq.detach(), "grads": grads}


def case_consensus(mesh, inp):
    """Rank 1 takes a SIGTERM at step 3; the step each rank stops at."""
    stopped = None
    with PreemptionGuard(sync_every=inp["sync_every"]) as guard:
        for it in range(1, 13):
            if mesh.rank == 1 and it == 3:
                signal.raise_signal(signal.SIGTERM)
            if guard.should_stop(it):
                stopped = it
                break
    return {"stopped": stopped, "fired": guard.fired}


def case_pipeline(mesh, inp):
    """The GPipe trainer from this rank's converted JAX state: the
    deterministic bundle and gradients of the first batch (gathered into
    the single-device layout), then an AdamW step on each batch (this
    rank's dp rows); the parameters and the moments after the first step
    gathered."""
    from visitron_torch.parallel.pipeline import PipelinePretrainTrainer

    trainer = PipelinePretrainTrainer(BertConfig(**inp["bert"]), mesh,
                                      num_microbatches=inp["microbatches"],
                                      total_steps=100, learning_rate=inp["lr"],
                                      device="cpu")
    state = {**inp["states"][mesh.rank], "rng": trainer.dropout_rng()}
    first = trainer.to_device(parallel.shard_batch(mesh, inp["batches"][0]))
    bundle, grads = trainer.loss_and_grads(state["params"], first, None)
    out = {"bundle": {k: float(v) for k, v in bundle.items()},
           "grads": trainer.dp.single_device_params(grads),
           "block": {k: tuple(v.shape) for k, v in state["params"]["stages"].items()},
           "bundles": []}
    step = trainer.step_fn()
    for i, batch in enumerate(inp["batches"]):
        state, bundle = step(state, parallel.shard_batch(mesh, batch))
        out["bundles"].append({k: float(v) for k, v in bundle.items()})
        if i == 0:
            out["opt"] = trainer.dp.gather(state["params"], state["opt_state"])[1]
    out["params"] = trainer.checkpoint_params(state)
    return out


def case_cli(mesh, inp):
    """``run.main`` of each argv in turn, with the tiny BERT of the CLI tests."""
    import visitron_torch.train.workspace as tws
    from visitron_torch import run

    def tiny(cfg, tokenizer):
        return BertConfig(vocab_size=len(tokenizer), hidden_size=32, num_hidden_layers=2,
                          num_attention_heads=4, intermediate_size=64,
                          max_position_embeddings=max(cfg.max_seq_length, 512),
                          type_vocab_size=4, img_feature_dim=cfg.img_feature_dim,
                          detector_classes=cfg.detector_classes,
                          hidden_dropout_prob=cfg.drop_out,
                          attention_probs_dropout_prob=cfg.drop_out)

    tws.Workspace._bert_config = staticmethod(tiny)
    for argv in inp["argvs"]:
        parallel.reset_collective_counts()
        run.main(argv, device="cpu")
    return {"counts": parallel.collective_counts()}


def main():
    work, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    parallel.init_process_group("cpu", init_method=f"file://{os.path.join(work, 'pg')}",
                                rank=rank, world_size=world, timeout_s=100)
    makers = {"tp": lambda n: parallel.make_mesh(tp=n),
              "sp": lambda n: parallel.make_sp_mesh(None, n),
              "cp": lambda n: parallel.make_cp_mesh(None, n),
              "pp": lambda n: parallel.make_pp_mesh(None, n)}
    try:
        dp_mesh = parallel.make_mesh()
        for name, inp in inputs:
            axis = inp.get("mesh")
            mesh = dp_mesh if axis is None else makers[axis[0]](axis[1])
            parallel.reset_collective_counts()
            torch.manual_seed(0)
            np.random.seed(0)
            out = globals()[f"case_{inp['case']}"](mesh, inp)
            out.setdefault("counts", parallel.collective_counts())
            torch.save(out, os.path.join(work, f"{name}_{rank}.pt"))
    finally:
        parallel.destroy_process_group()


if __name__ == "__main__":
    main()
