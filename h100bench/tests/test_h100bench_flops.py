"""The yardstick's arithmetic: the analytic model FLOPs against
FlopCounterMode on the program's plain path at a small size, and one launch
of K1f, K2f and K2b against hand counts."""

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100bench import flops, params
from h100bench.loops import common
from h100bench.reference import layout
from h100bench.tests import tiny


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _live(tree):
    """``tree``'s leaves as fresh leaves that take gradients (as the
    program's ``value_and_grads`` makes them)."""
    if isinstance(tree, dict):
        return {k: _live(v) for k, v in tree.items()}
    return tree.detach().requires_grad_()


def _backward_count(loss_fn) -> int:
    """FLOPs of ``loss_fn()`` and its backward (``backward`` stands in for the
    program's ``autograd.grad``, which the counter cannot follow)."""
    return _count(lambda: loss_fn().backward())


def _ndh(cell):
    cfg, traffic = cell["config"], cell["traffic"]
    cfg["bert"]["use_fused_attention"] = False
    cfg["dtype"] = "float32"
    dev = torch.device("cpu")
    world, table = common.ndh_world(cfg, traffic, 5, dev)
    eps = common.episodes(world, traffic, 5, "train", traffic["instances"])
    insts = common.nav_instances(world, eps)
    runtime, agent = common.ndh_program(cfg, traffic, world, table, 6, dev,
                                        traffic["episode_len"])
    from visitron_torch.agents import NavEpisodeBatcher

    batch = next(NavEpisodeBatcher(insts, runtime, batch_size=traffic["batch"],
                                   path_type="planner_path").train_batches(
        1, episode_len=traffic["episode_len"]))
    weights = params.nested(common.weights(layout.ndh_shapes(cfg), 5, dev))
    return cfg, agent, agent.trim_batch(batch), weights


def test_ndh_train_flops_match_the_counter():
    cfg, agent, batch, weights = _ndh(tiny.cell("ndh_train.mp3d.b128.t10"))
    live = _live(weights)
    got = _backward_count(lambda: agent.episode_loss(live, batch, agent.dropout_rng()))
    b, s = batch["ids"].shape
    want = flops.ndh_flops(b, s, agent.episode_len, cfg["bert"], cfg["agent"], train=True)
    assert got == want


def test_ndh_eval_flops_match_the_counter():
    cfg, agent, batch, weights = _ndh(tiny.cell("ndh_eval.mp3d.b256.t40"))
    with torch.inference_mode():
        got = _count(lambda: agent.device_rollout(weights, batch))
    b, s = batch["ids"].shape
    assert got == flops.ndh_flops(b, s, agent.episode_len, cfg["bert"], cfg["agent"], train=False)


def test_pretrain_flops_match_the_counter():
    from h100bench.loops import pretrain

    cell = tiny.cell("pretrain.s768.b64")
    cfg, traffic = cell["config"], cell["traffic"]
    cfg["bert"]["use_fused_attention"] = False
    cfg["dtype"] = "float32"
    dev = torch.device("cpu")
    tr = pretrain.trainer(cfg, 3, dev)
    batch = tr.to_device(pretrain.pool(cfg, traffic, 3, dev)[0])
    w = common.weights(layout.pretrain_shapes(cfg), 3, dev)
    live = _live(w)
    got = _backward_count(lambda: tr.loss_bundle(live, batch, None)["loss"])
    # The program runs the tied decoder and the region-token head at their
    # widths rounded up to 8; mfu divides the model's FLOPs, at its widths.
    bert = cfg["bert"]
    up8 = {k: -(-bert[k] // 8) * 8 for k in ("vocab_size", "detector_classes")}
    padded = flops.pretrain_flops(traffic["batch"], traffic["text"], traffic["img"],
                                  {**bert, **up8})
    model = flops.pretrain_flops(traffic["batch"], traffic["text"], traffic["img"], bert)
    assert got == padded
    # Each pad column: its forward, dX and dW products over every row.
    rows = traffic["batch"] * (traffic["text"] + traffic["img"])
    pad = sum(up8[k] - bert[k] for k in up8)
    assert pad == 3 + 7 and padded - model == 3 * 2 * rows * bert["hidden_size"] * pad


def test_launch_counts_by_hand():
    # K1f at B 2, H 12, S 128, D 64 with the lse: q, k, v, out bf16 (4 x 2*128*768*2 bytes),
    # the fp32 key bias (2*128*4) and lse (2*12*128*4); QK^T and PV 2 x 2*2*12*128*128*64.
    ops, nbytes = flops.attention_fwd(2, 12, 128, 64, lse=True)
    assert ops == 2 * 2 * 2 * 12 * 128 * 128 * 64
    assert nbytes == 4 * 2 * 128 * 768 * 2 + 2 * 128 * 4 + 2 * 12 * 128 * 4
    # K2f over 1000 rows of 768 with a residual: x, residual, y bf16 + gamma, beta fp32.
    assert flops.layernorm_fwd(1000, 768, True)[1] == 3 * 1000 * 768 * 2 + 2 * 768 * 4
    # K2b without a residual: dy, x, dh bf16 + gamma, dgamma, dbeta fp32.
    assert flops.layernorm_bwd(1000, 768, False)[1] == 3 * 1000 * 768 * 2 + 3 * 768 * 4
    bound = flops.bound_s([flops.attention_fwd(2, 12, 128, 64, lse=True)])
    assert np.isclose(bound, max(ops / 989e12, nbytes / 3.35e12))
