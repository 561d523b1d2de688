"""Multimodal pretraining: ``PretrainTrainer.step_fn`` over host batches,
one step after another, cycling through a pool of distinct batches drawn
from the seed.

Set-up builds the trainer with weights from the seed and drives the one
training object through its first three steps (pool batches 0, 1, 2, the
window's own call), which the reference follows; every step has the same
shapes, so those steps warm everything the window runs.  The window counts
completed (batch x S) tokens.
"""

from __future__ import annotations

import time

import torch

from h100bench import compare, flops, trace as tracing, world as inputs
from h100bench.loops import common
from h100bench.reference import adam as ref_adam, layout, pretrain as ref_pretrain
from h100bench.reference.core import Prec, Streams, set_fp32_math

COMPARED_STEPS = 3
TRACED_STEPS = 8


def pool(cfg: dict, traffic: dict, seed: int, device) -> list:
    c = cfg["bert"]
    return inputs.pretrain_pool(common.derive(seed, "pool"), traffic["pool"], traffic["batch"],
                                traffic["text"], traffic["img"], tuple(traffic["text_len"]),
                                tuple(traffic["regions"]), c["vocab_size"], c["img_feature_dim"],
                                c["detector_classes"], c["action_space"], traffic["mlm_share"],
                                traffic["token_share"], device)


def trainer(cfg: dict, seed: int, device):
    from visitron_torch.models import BertConfig
    from visitron_torch.train.pretrain import PretrainTrainer

    opt = cfg["optimizer"]
    return PretrainTrainer(BertConfig(dtype=common.dtype_of(cfg["dtype"]), **cfg["bert"]),
                           learning_rate=opt["learning_rate"], warmup_steps=opt["warmup_steps"],
                           total_steps=opt["total_steps"], schedule=opt["schedule"],
                           weight_decay=opt["weight_decay"], max_grad_norm=opt["max_grad_norm"],
                           seed=common.derive(seed, "trainer"), device=device)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float):
    cfg, traffic = cell["config"], cell["traffic"]
    b, s = traffic["batch"], traffic["text"] + traffic["img"]
    rec = common.Record("pretrain")
    st = common.Stages(device, t_start)
    batches = pool(cfg, traffic, seed, device)
    st.done("batches")
    tr = trainer(cfg, seed, device)
    state = tr.init_state(params=common.weights(layout.pretrain_shapes(cfg), seed, device))
    step = tr.step_fn()
    st.done("trainer_and_params")
    losses = []
    for i in range(COMPARED_STEPS):
        state, bundle = step(state, batches[i % len(batches)])
        losses.append(bundle["loss"])
        if i == 0:
            mu1 = {k: v.detach().clone() for k, v in
                   common.adam_moment(state["opt_state"]).items()}
    p3 = {k: v.detach().clone() for k, v in state["params"].items()}
    st.done("first_steps")
    rec.setup_stages, rec.setup_s = st.seconds, st.total()

    window_losses, n = [], 0
    t0 = time.perf_counter()
    while True:
        state, bundle = step(state, batches[(COMPARED_STEPS + n) % len(batches)])
        window_losses.append(bundle["loss"])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    common.sync(device)
    rec.window_s = time.perf_counter() - t0
    rec.work = {"steps": n, "tokens": n * b * s}
    rec.attempted = n

    if trace:
        kept = [batches[i % len(batches)] for i in range(TRACED_STEPS)]
        common.sync(device)
        t1 = time.perf_counter()
        for batch in kept:
            state, _ = step(state, batch)
        common.sync(device)
        rec.traced_wall_s = time.perf_counter() - t1

        def replay():
            nonlocal state
            for batch in kept:
                state, _ = step(state, batch)

        rec.trace = tracing.profile(replay, TRACED_STEPS, lambda: common.sync(device))
        rec.traced_flops = TRACED_STEPS * flops.pretrain_flops(b, traffic["text"],
                                                               traffic["img"], cfg["bert"])
        one = flops.bert_launches(b, s, cfg["bert"], train=True, embed_rows=b * traffic["text"],
                                  head_rows=b * s)
        rec.traced_launches = {k: v * TRACED_STEPS for k, v in one.items()}
    rec.memory_peak_bytes = common.memory_peak(device)
    window = torch.stack(window_losses).float().cpu()
    rec.failed = int((~torch.isfinite(window)).sum())
    prog_losses = [float(x) for x in losses]
    del state, step, tr, window_losses, losses, bundle
    common.free()

    t_ref = time.perf_counter()
    first = batches[:COMPARED_STEPS]
    ref = reference_steps(cfg, traffic, first, seed, device)
    p0 = common.weights(layout.pretrain_shapes(cfg), seed, device)
    prog_grad = {k: v / (1 - ref_adam.B1) for k, v in mu1.items()}
    rec.readings = compare.training(prog_losses, ref[0], prog_grad, ref[1],
                                    common.leaves_minus(p3, p0), ref[2])
    rec.readings["nonfinite_window_losses"] = float(rec.failed)
    rec.limits = {**traffic["limits"], "nonfinite_window_losses": 0}
    rec.correct, _ = compare.judge(rec.readings, rec.limits)
    rec.reference_s = time.perf_counter() - t_ref
    return rec


def reference_steps(cfg, traffic, first: list, seed: int, device, prec: Prec | None = None,
                    drop_half: bool = False):
    """(losses, first clipped gradient, change after the steps) of the plain
    reference over the host batches ``first``, from the weights of the seed.
    ``prec``: its precision (default fp32); ``drop_half``: each batch's
    second half left out, a planted fault."""
    set_fp32_math()
    prec = prec or Prec("fp32")
    p0 = common.weights(layout.pretrain_shapes(cfg), seed, device)
    adam = ref_adam.Adam(p0, cfg["optimizer"])
    trainer_seed = common.derive(seed, "trainer")
    streams = Streams(trainer_seed, device)
    P, losses, g1 = p0, [], None
    for batch in first:
        if drop_half:
            batch = {k: v[:len(v) // 2] for k, v in batch.items()}
        loss, grads = ref_pretrain.loss_grads(P, batch, cfg["bert"], trainer_seed, prec,
                                              traffic["reference_block"], streams)
        P, clipped = adam.step(P, grads)
        g1 = clipped if g1 is None else g1
        losses.append(loss)
    return losses, g1, common.leaves_minus(P, p0)
