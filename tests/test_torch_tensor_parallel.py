"""The port's tensor parallelism (``--mesh_tp``) on the CPU, against the JAX
package's (dp, tp) meshes on the 8 virtual CPU devices of tests/conftest.py.

In one process:

  * the K1 (packed), K4 and K5 twins on a rank's heads at tp 2 and sp 2
    (6 local heads of 12, rate 0.1, the seed folded by ``Mesh.kernel_seed``
    past int32), as a rank's model calls them, against
    ``fused_attention_mesh_packed`` / ``fused_attention_mesh`` /
    ``flash_attention_mesh`` in interpret mode on ``make_mesh(dp=1, tp=2)``
    and ``make_sp_mesh(dp=1, sp=2)``: each rank's keep mask bit for bit,
    outputs and the gradients of sum(out * g) within 1e-5 in fp32;
  * ``config_for_mesh`` and ``shard_params_rules`` (the four split kernels,
    the head-grouped QKV block of a rank);

and on two gloo ranks of tests/torch_dist_worker.py at tp 2:

  * two fp32 pretraining steps (dropouts 0), plain and with ``fsdp``
    (which at dp 1 shards nothing more), against JAX ``PretrainTrainer``
    on ``make_mesh(dp=1, tp=2)`` (its
    parameters placed by ``shard_params_rules``) at
    test_torch_multiprocess.py's tolerances (bundles rtol 1e-5, updates
    within 3 lr, 1e-2 lr where every gradient exceeds 1e-4); each rank
    holds 1/tp of the four split kernels;
  * the viewpoint teacher-forced step against the JAX step on
    ``make_mesh(dp=1, tp=2)`` (loss rtol 1e-5, parameters within 2 lr,
    1e-2 lr where |g| > 1e-5), the turn-based and classifier steps against
    the port's one-process step;
  * with every dropout on, the replicated tensors of the two ranks are
    bit-equal after a pretraining step (the kernels on and off) and a
    viewpoint step; with the kernels off, the plain attention's dropout
    makes the tp step the one-process step;
  * history K/V under tp: the plain attention on a rank's heads, forward
    and gathered gradients equal to one process's (1e-5; the gradients
    relative to their largest entry);
  * ``run viewpoint --debug --mesh_tp 2``: its checkpoints are in the
    single-device layout, equal the one-process run's (fp32, dropouts 0, 2
    lr), and resume in one process.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_multiprocess import (EP_LEN, LR, NAV, PRE, REPO, SMALL_CLI,  # noqa: F401
                                     _check_update, _nav_agent_kw, _np, _pretrain_batch,
                                     join_ranks, nav, start_ranks)
from visitron_torch import agents as ta
from visitron_torch import run as trun
from visitron_torch.agents.classifier import ClassifierAgent
from visitron_torch.agents.turn_based import TurnBasedAgent
from visitron_torch.convert import convert_agent_params, convert_pretrain_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models import VisitronBert
from visitron_torch.models import config_for_mesh as t_config_for_mesh
from visitron_torch.models.layers import init_module_params
from visitron_torch.models.pretrain import PretrainModel
from visitron_torch.ops import attention as tatt
from visitron_torch.parallel import Mesh, shard_params_rules, tp_slice
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_tpu import agents as ja
from visitron_tpu import models as jm
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.ops import attention as jatt
from visitron_tpu.parallel import make_mesh, make_sp_mesh, shard_params_rules as j_rules
from visitron_tpu.train.pretrain import PretrainTrainer as JTrainer

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the rank-local kernel twins against the JAX mesh wrappers ------------------------------

B, H, D, RATE = 2, 12, 64, 0.1
SEED = 2 ** 31 - 9000  # rank 1's fold (+ 7919) wraps past int32


def _jax_mesh(axis):
    return make_mesh(dp=1, tp=2) if axis == "tp" else make_sp_mesh(dp=1, sp=2)


@pytest.mark.parametrize("axis", ["tp", "sp"])
@pytest.mark.parametrize("kernel", ["K1", "K4", "K5"])
def test_rank_local_kernels_match_the_jax_mesh_wrappers(kernel, axis):
    """Each rank's call of the K1/K4/K5 twin on its 6 heads with its folded
    seed (``Mesh.kernel_seed``): its keep mask, output and input gradients
    are the JAX wrapper's for those heads."""
    s = 256 if kernel == "K5" else 128
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.standard_normal((B, H, s, D)).astype(np.float32) for _ in range(4))
    bias = np.where(rng.random((B, s)) < 0.15, -1e9, 0.0).astype(np.float32)
    bias[:, 0] = 0.0
    mesh = _jax_mesh(axis)
    if kernel == "K1":
        pack = lambda t: t.transpose(0, 2, 1, 3).reshape(B, s, H * D)  # noqa: E731
        jfn = lambda q, k, v: jatt.fused_attention_mesh_packed(  # noqa: E731
            q, k, v, jnp.asarray(bias), H, SEED, RATE, mesh=mesh, interpret=True)
        args = [pack(t) for t in (q, k, v)]
        gj = pack(g)
    else:
        wrap = (jatt.fused_attention_mesh if kernel == "K4" else jatt.flash_attention_mesh)
        jfn = lambda q, k, v: wrap(q, k, v, jnp.asarray(bias), SEED, RATE,  # noqa: E731
                                   mesh=mesh, interpret=True)
        args, gj = [q, k, v], g
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jfn(*jargs))
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a) * gj), argnums=(0, 1, 2))(*jargs)
    hl = H // 2
    for t in range(2):
        tm = Mesh(dp=1, rank=t, device=CPU, axis=axis, size=2)
        if kernel == "K1":
            cols = slice(t * hl * D, (t + 1) * hl * D)
            block = lambda a: torch.from_numpy(np.ascontiguousarray(a[..., cols]))  # noqa: E731
        else:
            heads = slice(t * hl, (t + 1) * hl)
            block = lambda a: torch.from_numpy(np.ascontiguousarray(a[:, heads]))  # noqa: E731
        tq, tk, tv = (block(a).requires_grad_() for a in args)
        tb = torch.from_numpy(bias)
        seed = tm.kernel_seed(SEED)
        if kernel == "K1":
            out = tatt.fused_attention_packed(tq, tk, tv, tb, hl, seed, RATE)
        elif kernel == "K4":
            out = tatt.fused_attention(tq, tk, tv, tb, seed, RATE)
        else:
            out = tatt.flash_attention(tq, tk, tv, tb, seed, RATE)
        (out * block(gj)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), block(want).numpy(), atol=1e-5,
                                   rtol=0, err_msg=f"rank {t} output")
        for name, got, jg in zip("qkv", (tq, tk, tv), jgrads):
            np.testing.assert_allclose(got.grad.numpy(), block(np.asarray(jg)).numpy(),
                                       atol=1e-5, rtol=0, err_msg=f"rank {t} d{name}")
        # The keep mask of each local head: the JAX body's folded seed,
        # seed + dp_index * 1000003 + axis_index * 7919 in int32.
        jseed = jnp.asarray([SEED], jnp.int32) + jnp.int32(t) * jnp.int32(7919)
        tmask = tatt._head_keep_mask(tm.kernel_seed(SEED), B, hl, s, RATE, CPU).numpy()
        for bh in range(B * hl):
            jmask = np.asarray(jatt._keep_mask(jatt._mix_seed(jseed, bh), 0, 0, (s, s),
                                               jatt._threshold(RATE)))
            np.testing.assert_array_equal(tmask[bh // hl, bh % hl], jmask)
        assert 0.85 < tmask.mean() < 0.95


def test_config_for_mesh_and_the_split_rules():
    """test_multichip.py:103-139's cases for the port's meshes: a tp mesh
    keeps the kernels on (a rank runs them on its heads); no mesh, a one-rank and
    a dp-only mesh leave the config as it is.  The split rules name the
    four kernels of every layer and nothing else; a rank's QKV block holds
    q, k and v of its heads, as the JAX wrappers' in_specs hand them out."""
    cfg = TConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                  intermediate_size=32, use_fused_attention=True, use_flash_attention=True)
    tp = Mesh(dp=4, rank=1, device=CPU, axis="tp", size=2)
    out = t_config_for_mesh(cfg, tp)
    assert out.tp_mesh is tp and out.use_fused_attention and out.use_flash_attention
    assert t_config_for_mesh(cfg, None) is cfg
    assert t_config_for_mesh(cfg, Mesh(dp=1, rank=0, device=CPU)) is cfg
    assert t_config_for_mesh(cfg, Mesh(dp=8, rank=3, device=CPU)) is cfg
    plain = t_config_for_mesh(cfg.replace(use_fused_attention=False,
                                          use_flash_attention=False), tp)
    assert plain.tp_mesh is tp and not plain.use_fused_attention
    with pytest.raises(ValueError, match="tp=2 must divide"):
        t_config_for_mesh(cfg.replace(num_attention_heads=3), tp)
    model = PretrainModel(out)
    rules = shard_params_rules(model)
    assert rules == {"bert.encoder.layer_0.attention.qkv.weight": "qkv",
                     "bert.encoder.layer_0.attention.qkv.bias": "qkv",
                     "bert.encoder.layer_0.intermediate.weight": "col",
                     "bert.encoder.layer_0.intermediate.bias": "col",
                     "bert.encoder.layer_0.attention_output.weight": "row",
                     "bert.encoder.layer_0.output.weight": "row"}
    # The JAX rule splits the same four kernels (its (in, out) layout).
    jparams = {"layer": {"qkv": {"kernel": np.zeros((32, 96))},
                         "attention_output": {"kernel": np.zeros((32, 32))},
                         "intermediate": {"kernel": np.zeros((32, 32))},
                         "output": {"kernel": np.zeros((32, 32))}}}
    jr = j_rules(make_mesh(dp=4, tp=2), jparams)["layer"]
    assert [jr[k]["kernel"].spec for k in ("qkv", "intermediate")] == [
        jax.sharding.PartitionSpec(None, "tp")] * 2
    assert [jr[k]["kernel"].spec for k in ("attention_output", "output")] == [
        jax.sharding.PartitionSpec("tp", None)] * 2
    w = torch.arange(96 * 32.0).reshape(96, 32)  # (3 x 2 heads x 16, hidden)
    got = tp_slice(w, "qkv", tp)  # rank 1: head 1 of q, k and v
    assert torch.equal(got, torch.cat([w[16:32], w[48:64], w[80:96]]))
    assert torch.equal(tp_slice(w[:32], "row", tp), w[:32, 16:])
    assert torch.equal(tp_slice(w[:32], "col", tp), w[16:32])


# -- two gloo ranks at tp 2 -------------------------------------------------------------------

@pytest.fixture(scope="module")
def tp(nav, tmp_path_factory):
    cases, ref = [], {}
    batches = [_pretrain_batch(seed) for seed in (2, 3)]
    plain = TTrainer(TConfig(**PRE), device="cpu", total_steps=100, learning_rate=LR)
    # One JAX reference serves both arms: at dp 1 FSDP shards nothing.
    jtr = JTrainer(jm.BertConfig(**PRE), mesh=make_mesh(dp=1, tp=2), total_steps=100,
                   learning_rate=LR)
    pstate = jtr.init_state(batches[0])
    p0 = convert_pretrain_params(_np(pstate["params"]), plain.model)
    for fsdp in (False, True):
        cases.append(("pretrain_fsdp" if fsdp else "pretrain", {
            "case": "pretrain", "bert": PRE, "params": p0, "batches": batches, "lr": LR,
            "zero1": False, "fsdp": fsdp, "mesh": ("tp", 2), "moments": True}))
    drop = {**PRE, "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}
    cases.append(("pretrain_dropout", {"case": "pretrain", "bert": drop,
                                       "params": p0, "batches": batches[:1],
                                       "lr": LR, "zero1": False, "fsdp": False,
                                       "mesh": ("tp", 2)}))
    # The kernels off: the plain attention draws its dropout mask from the
    # replicated mask generator.
    drop_plain = {**drop, "use_fused_attention": False, "use_flash_attention": False}
    cases.append(("pretrain_dropout_plain", {"case": "pretrain", "bert": drop_plain,
                                             "params": p0, "batches": batches[:1],
                                             "lr": LR, "zero1": False, "fsdp": False,
                                             "mesh": ("tp", 2)}))
    nav_bert = {**NAV, "vocab_size": nav["vocab"]}
    tagent = ta.ViewpointAgent(TConfig(**nav_bert), nav["trt"], **_nav_agent_kw(LR),
                               device="cpu")
    jbatch = next(JBatcher(nav["jinst"], nav["jrt"], batch_size=4, seed=3)
                  .train_batches(1, EP_LEN))
    tbatch = tagent.trim_batch(next(ta.NavEpisodeBatcher(nav["tinst"], nav["trt"],
                                                         batch_size=4, seed=3)
                                    .train_batches(1, EP_LEN)))
    jagent = ja.ViewpointAgent(jm.BertConfig(**nav_bert), nav["jrt"], **_nav_agent_kw(LR),
                               max_seq_length=128, mesh=make_mesh(dp=1, tp=2))
    jstate = jagent.init_state()
    vp0 = convert_agent_params(_np(jstate["params"]), tagent)
    cases.append(("viewpoint", {"case": "viewpoint", "bert": nav_bert,
                                "agent": _nav_agent_kw(LR), "world": nav["world"],
                                "params": vp0, "batch": tbatch, "zero1": False,
                                "mesh": ("tp", 2)}))
    vdrop = {**nav_bert, "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}
    cases.append(("viewpoint_dropout", {"case": "viewpoint", "bert": vdrop,
                                        "agent": {**_nav_agent_kw(LR), "dropout": 0.5},
                                        "world": nav["world"], "params": vp0,
                                        "batch": tbatch, "zero1": False,
                                        "mesh": ("tp", 2)}))
    tkw, ckw = (dict(_nav_agent_kw(lr), episode_len=12) for lr in (1e-4, 1e-3))
    tb = TurnBasedAgent(TConfig(**nav_bert), nav["trt"], **tkw, device="cpu")
    batcher = ta.NavEpisodeBatcher(nav["tinst"], nav["trt"], batch_size=4, seed=4)
    tbb = tb.trim_batch(batcher.with_turn_teacher(next(batcher.train_batches(1)), 12))
    tb_state = tb.init_state()
    cases.append(("turn_based", {"case": "turn_based", "bert": nav_bert, "agent": tkw,
                                 "world": nav["world"], "params": tb_state["params"],
                                 "batch": tbb, "mesh": ("tp", 2)}))
    cl = ClassifierAgent(TConfig(**nav_bert), nav["trt"], **ckw, device="cpu")
    items = nav["cinst"][:4]
    cl_state = cl.init_state()
    cases.append(("classifier", {"case": "classifier", "bert": nav_bert, "agent": ckw,
                                 "world": nav["world"], "params": cl_state["params"],
                                 "items": items, "mesh": ("tp", 2)}))
    hist_bert = {**NAV, "vocab_size": 50, "num_hidden_layers": 2}
    hmodel = VisitronBert(TConfig(**hist_bert), image=False)
    hp = init_module_params(hmodel, torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    hin = {"ids": torch.from_numpy(rng.integers(0, 50, (2, 16))),
           "history": [torch.from_numpy(rng.standard_normal((2, 24, 128)).astype(np.float32))
                       for _ in range(2)],
           "g": torch.from_numpy(rng.standard_normal((2, 16, 128)).astype(np.float32))}
    cases.append(("history", {"case": "history", "bert": hist_bert, "params": hp, **hin,
                              "mesh": ("tp", 2)}))
    root = str(tmp_path_factory.mktemp("tp_cli"))
    out = {k: os.path.join(root, k) for k in ("tp", "one")}
    vp = ["viewpoint", "--config",
          os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
          *SMALL_CLI, "--saving_steps", "2", "--feedback_method", "teacher",
          "--num_iterations", "2", "--eval_iters", "2"]
    cases.append(("cli", {"case": "cli", "argvs": [vp + ["--mesh_tp", "2", "--output_dir",
                                                        out["tp"]]]}))
    started = start_ranks(str(tmp_path_factory.mktemp("tp_steps")), cases)

    # The references, while the ranks run.
    rules = j_rules(jtr.mesh, pstate["params"])
    pstate["params"] = jax.tree.map(jax.device_put, pstate["params"], rules)
    pstate["opt_state"] = jax.jit(jtr.optimizer.init)(pstate["params"])
    jbundles = []
    for b in batches:
        pstate, bundle = jtr.step_fn()(pstate, b)
        jbundles.append({k: float(v) for k, v in _np(bundle).items()})
    one = TTrainer(TConfig(**drop_plain), device="cpu", total_steps=100, learning_rate=LR)
    _, bundle = one.step_fn()(one.init_state(params=p0), batches[0])
    ref["pretrain_dropout_plain"] = {k: float(v) for k, v in bundle.items()}
    ref["pretrain"] = ref["pretrain_fsdp"] = {
        "start": p0, "bundles": jbundles,
        "params": convert_pretrain_params(_np(pstate["params"]), plain.model),
        "grads": [plain.loss_and_grads(p0, plain.to_device(b), None)[1] for b in batches]}
    jnew, jloss = jagent.train_step_fn()(
        jstate, {k: np.asarray(v) for k, v in jbatch.items() if not isinstance(v, list)})
    _, _, grads = tagent.value_and_grads(vp0, lambda p: (tagent.episode_loss(p, tbatch), None))
    ref["viewpoint"] = {"loss": float(jloss), "start": vp0, "grads": grads,
                        "params": convert_agent_params(_np(jnew["params"]), tagent)}
    start = tb_state["params"]
    _, _, grads = tb.value_and_grads(start, lambda p: (tb.episode_loss(p, tbb), None))
    new, loss = tb.train_step_fn()(tb_state, tbb)
    ref["turn_based"] = {"loss": float(loss), "start": start, "params": new["params"],
                         "grads": grads}
    start, cb = cl_state["params"], cl.prepare_batch(items)
    labels = {"encoder": {k: "freeze" for k in start["encoder"]},
              "decoder": {k: "train" if "question_linear" in k else "freeze"
                          for k in start["decoder"]}}
    _, _, grads = cl.value_and_grads(start, lambda p: cl.loss_fn(p, cb), labels)
    new, loss = cl.train_step_fn()(cl_state, cb)
    ref["classifier"] = {"loss": float(loss), "start": start, "params": new["params"],
                         "grads": grads}
    live = {k: v.clone().requires_grad_() for k, v in hp.items()}
    seq, _ = torch.func.functional_call(hmodel, live, (hin["ids"],),
                                        {"history_states": hin["history"]})
    (seq * hin["g"]).sum().backward()
    ref["history"] = {"seq": seq.detach(), "grads": {k: v.grad for k, v in live.items()}}
    return ref, join_ranks(started), out, vp


@pytest.mark.parametrize("name", ["pretrain", "pretrain_fsdp"])
def test_tp_pretraining_steps_match_the_jax_tp_trainer(tp, name):
    ref, got, _, _ = tp
    r, ranks = ref[name], got[name]
    for rank in ranks:  # every rank logs the global bundle
        for i, bundle in enumerate(rank["bundles"]):
            for key, v in r["bundles"][i].items():
                np.testing.assert_allclose(bundle[key], v, rtol=1e-5,
                                           err_msg=f"step {i + 1} {key}")
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k])
               for k in ranks[0]["params"])
    _check_update(ranks[0]["params"], r["start"], r["params"], r["grads"], LR)
    # The moments are gathered into the single-device layout too.
    assert all(ranks[0]["mu"][k].shape == v.shape for k, v in r["start"].items())
    counts = ranks[0]["counts"]
    layers = PRE["num_hidden_layers"]
    # Per step: the counts and the gradients over dp, two all-reduces forward
    # and two backward a layer over tp, the clip's over tp.
    assert counts["all_reduce_sum"] == 2 * (2 + 4 * layers + 1)
    assert counts["reduce_scatter"] == 0 and counts["all_to_all"] == 0


def test_each_tp_rank_holds_its_blocks_of_the_four_split_kernels(tp):
    ref, got, _, _ = tp
    start = ref["pretrain"]["start"]
    for rank, out in enumerate(got["pretrain"]):
        split = {k for k in start if any(s in k for s in (
            "attention.qkv.", "intermediate.", "attention_output.weight", ".output.weight"))}
        assert len(split) == 6 * PRE["num_hidden_layers"]
        for k, shape in out["shapes"].items():
            full = start[k].numel()
            assert shape.numel() == (full // 2 if k in split else full), k
        qkv = "bert.encoder.layer_1.attention.qkv.weight"
        h = PRE["hidden_size"]
        # The rank's block: the rows of its heads of q, k and v of the
        # gathered (single-device) layout.
        full = out["params"][qkv].unflatten(0, (3, h))
        assert torch.equal(out["local"][qkv],
                           full[:, rank * h // 2:(rank + 1) * h // 2].flatten(0, 1))
    # FSDP at dp 1 shards nothing more; tp leaves are not dp-sharded.
    assert got["pretrain_fsdp"][0]["shapes"] == got["pretrain"][0]["shapes"]


def test_tp_viewpoint_step_matches_the_jax_tp_step(tp):
    ref, got, _, _ = tp
    r, ranks = ref["viewpoint"], got["viewpoint"]
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], r["loss"], rtol=1e-5)
    want = {f"{part}/{k}": v for part, sub in r["params"].items() for k, v in sub.items()}
    start = {f"{part}/{k}": v for part, sub in r["start"].items() for k, v in sub.items()}
    grads = {f"{part}/{k}": v for part, sub in r["grads"].items() for k, v in sub.items()}
    assert all(torch.equal(ranks[0]["params"][k], ranks[1]["params"][k]) for k in want)
    for name, p in ranks[0]["params"].items():
        delta = np.abs(p.numpy() - want[name].numpy())
        big = np.abs(grads[name].numpy()) > 1e-5
        assert delta.max() <= 2 * LR + 1e-6, name
        assert (delta[big] <= LR * 1e-2 + 1e-6).all(), name
        assert (np.abs(p.numpy() - start[name].numpy())[big] > 0.5 * LR).all(), name


@pytest.mark.parametrize("kind", ["turn_based", "classifier"])
def test_tp_step_equals_the_one_process_step(tp, kind):
    ref, got, _, _ = tp
    r, ranks = ref[kind], got[kind]
    lr = 1e-4 if kind == "turn_based" else 1e-3
    for rank in ranks:
        np.testing.assert_allclose(rank["loss"], r["loss"], rtol=1e-5)
    moved = 0
    for part, sub in r["params"].items():
        for k, want in sub.items():
            p = ranks[0]["params"][f"{part}/{k}"]
            assert torch.equal(p, ranks[1]["params"][f"{part}/{k}"])
            g = r["grads"][part][k]
            if g is None:  # frozen: untouched on every rank
                assert torch.equal(p, r["start"][part][k])
                continue
            delta = np.abs(p.numpy() - want.numpy())
            big = np.abs(g.numpy()) > 1e-5
            assert delta.max() <= 2 * lr + 1e-6, k
            assert (delta[big] <= lr * 1e-2 + 1e-6).all(), k
            moved += int(big.sum())
    assert moved > 0


def test_history_kv_under_tp_takes_the_plain_attention_on_each_ranks_heads(tp):
    """History K/V states: the queries through the q rows, the keys and
    values of history + fresh tokens through the k and v rows of a rank's
    QKV block, the plain attention on its heads (as the JAX gate decides);
    the forward (fp32, 1e-5) and the gathered gradients (within 1e-5 of
    each one's largest entry: sums over all the rows) are the one-process
    model's."""
    ref, got, _, _ = tp
    for rank in got["history"]:
        np.testing.assert_allclose(rank["seq"].numpy(), ref["history"]["seq"].numpy(),
                                   atol=1e-5, rtol=1e-5)
        for k, g in ref["history"]["grads"].items():
            if g is None:  # the pooler: not in the loss
                assert rank["grads"][k] is None, k
                continue
            scale = float(g.abs().max())
            np.testing.assert_allclose(rank["grads"][k].numpy(), g.numpy(),
                                       atol=1e-5 * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", ["pretrain_dropout", "pretrain_dropout_plain",
                                  "viewpoint_dropout"])
def test_replicated_tensors_of_the_tp_ranks_are_bit_equal_with_dropout_on(tp, name):
    """The tp ranks draw the same hidden-dropout masks (and the attention
    kernels' seeds fold their tp index; with the kernels off, the plain
    attention's masks come from the same generator): after a step with
    every dropout on, every replicated leaf is the same on both ranks, bit
    for bit, and the step moved it."""
    _, got, _, _ = tp
    r0, r1 = got[name]
    key = "bundles" if name.startswith("pretrain") else "loss"
    assert r0[key] == r1[key]
    split = ("attention.qkv.", "intermediate.", "attention_output.weight", ".output.weight")
    shared = [k for k in r0["local"] if not any(s in k for s in split)]
    assert len(shared) > 10
    for k in shared:
        assert torch.equal(r0["local"][k], r1["local"][k]), k
    # The split blocks differ (each rank its heads) but gather to one layout.
    assert all(torch.equal(r0["params"][k], r1["params"][k]) for k in r0["params"])


def test_plain_attention_dropout_under_tp_is_the_one_process_draw(tp):
    """With the kernels off, each tp rank draws the plain attention's
    dropout mask over all H heads and keeps its own heads' (as the JAX
    package draws one mask over all heads), so the head groups are not
    dropped alike: with every dropout on, the tp step's losses are the
    one-process step's from the same generators (fp32, rtol 1e-5)."""
    ref, got, _, _ = tp
    for rank in got["pretrain_dropout_plain"]:
        for key, v in ref["pretrain_dropout_plain"].items():
            np.testing.assert_allclose(rank["bundles"][0][key], v, rtol=1e-5, err_msg=key)


def test_tp_checkpoint_is_the_single_device_layout_and_resumes_in_one_process(tp,
                                                                              monkeypatch):
    import visitron_torch.train.workspace as tws

    _, got, out, vp = tp
    ckpt = CheckpointManager(out["tp"])
    assert ckpt.steps() == [2]
    params = ckpt.restore_raw(2)
    assert params["encoder"]["bert.bert.encoder.layer_0.attention.qkv.weight"].shape == (96, 32)
    assert os.path.exists(os.path.join(out["tp"], "preds_val_seen_2.json"))
    assert got["cli"][0]["counts"]["all_reduce_sum"] > 0

    def tiny(cfg, tokenizer):
        return TConfig(vocab_size=len(tokenizer), hidden_size=32, num_hidden_layers=2,
                       num_attention_heads=4, intermediate_size=64,
                       max_position_embeddings=max(cfg.max_seq_length, 512),
                       type_vocab_size=4, img_feature_dim=cfg.img_feature_dim,
                       detector_classes=cfg.detector_classes, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)

    monkeypatch.setattr(tws.Workspace, "_bert_config", staticmethod(tiny))
    # The same run in one process: its checkpoint is the tp run's, within the
    # two Adam steps' tolerance (fp32, dropouts 0).
    trun.main(vp + ["--output_dir", out["one"]], device="cpu")
    one = CheckpointManager(out["one"]).restore_raw(2)
    for part, sub in one.items():
        for k, v in sub.items():
            assert params[part][k].shape == v.shape, k
            assert float((params[part][k] - v).abs().max()) <= 4 * LR + 1e-6, k
    # The tp run resumes in one process (vp ends with its iteration counts).
    trun.main(vp[:-4] + ["--num_iterations", "3", "--eval_iters", "3", "--resume",
                         "--output_dir", out["tp"]], device="cpu")
    assert ckpt.steps() == [2, 3]
    assert ckpt.restore_raw(3, "opt_state")[1]["count"] == 3
