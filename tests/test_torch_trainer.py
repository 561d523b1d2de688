"""The port's fine-tuning trainer, checkpoints, preemption guard and agent
optimizers against the JAX package's, on the CPU.

Both packages' ``Workspace._bert_config`` is patched to the tiny BERT the
JAX package's own trainer tests use (hidden 32, 2 layers, 4 heads,
intermediate 64); the run is the ``--debug`` synthetic world in fp32 with
every dropout at 0 (``drop_out = dropout = 0``), planner_path (10-step
episodes), batch 2.  The JAX trainer runs on a one-device mesh
(``mesh_dp 1``).  Both trainers start from the JAX agent's initial state,
its parameters and optax state carried across by ``convert_agent_params``
and ``convert_opt_state``.

Tolerances: logged losses 1e-4 + 1e-4 |ref|.  Parameters after n Adam steps
follow the rule of tests/test_torch_train.py: an Adam step moves a
parameter by about lr wherever |g| >> eps, so n steps move it by at most
2 n lr in any case, and where the JAX first moment |mu| > 1e-5 (1000 eps)
both packages take the same steps up to lr * 1e-2 each.
"""

import csv
import json
import os
import signal
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import visitron_torch.train.workspace as tws
import visitron_tpu.train.workspace as jws
from visitron_torch.agents import ViewpointAgent as TAgent
from visitron_torch.agents import decoding as tdec
from visitron_torch.config import RunConfig as TConfig
from visitron_torch.convert import (convert_agent_params, convert_opt_state,
                                    convert_pretrain_params)
from visitron_torch.models import BertConfig as TBert
from visitron_torch.models import PretrainModel as TPretrainModel
from visitron_torch.models.oscar_import import (graft_pretrain_checkpoint_into_encoder,
                                                is_pretrain_checkpoint)
from visitron_torch.train import optim as topt
from visitron_torch.train.checkpoint import CheckpointManager as TCkpt
from visitron_torch.train.finetune import ViewpointTrainer as TTrainer
from visitron_torch.train.preemption import PreemptionGuard as TGuard
from visitron_tpu.config import RunConfig as JConfig
from visitron_tpu.models import BertConfig as JBert
from visitron_tpu.train import optim as jopt
from visitron_tpu.train.finetune import ViewpointTrainer as JTrainer

LR = 5e-5
BASE = dict(debug=True, max_seq_length=64, max_img_seq_length=32,
            lstm_img_feature_dim=48, img_feature_dim=56, encoder_hidden_size=16,
            rnn_dim=24, aemb=8, num_iterations=4, logging_steps=1, saving_steps=2,
            per_gpu_train_batch_size=2, per_gpu_eval_batch_size=4,
            path_type="planner_path", use_bfloat16=False, drop_out=0.0, dropout=0.0,
            feedback_method="teacher", mesh_dp=1, learning_rate=LR)
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=64, type_vocab_size=4)


def _tiny(bert_cls):
    def make(cfg, tokenizer):
        return bert_cls(vocab_size=len(tokenizer), img_feature_dim=cfg.img_feature_dim,
                        detector_classes=cfg.detector_classes,
                        hidden_dropout_prob=cfg.drop_out,
                        attention_probs_dropout_prob=cfg.drop_out, **TINY)

    return staticmethod(make)


@pytest.fixture(scope="module", autouse=True)
def tiny_bert():
    """Both packages' workspaces build the tiny BERT."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jws.Workspace, "_bert_config", _tiny(JBert))
        mp.setattr(tws.Workspace, "_bert_config", _tiny(TBert))
        yield


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the steps are tiny, and test workers share the
    machine; restored after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_agent(tmp_path_factory):
    """One JAX agent for every JAX trainer of the module, so that each of
    its jitted steps is traced and compiled once."""
    return _jax_trainer(tmp_path_factory.mktemp("jax_agent")).agent


def _jax_trainer(out, agent=None, **kw):
    cfg = JConfig(**{**BASE, **kw, "output_dir": str(out)})
    trainer = JTrainer(cfg, jws.Workspace.synthetic_workspace(cfg))
    if agent is not None:
        trainer.agent = agent
    return trainer


def _torch_trainer(out, **kw):
    cfg = TConfig(**{**BASE, **kw, "output_dir": str(out)})
    return TTrainer(cfg, tws.Workspace.synthetic_workspace(cfg, device="cpu"), device="cpu")


def _host(state):
    """params and opt_state of a JAX state as numpy trees."""
    return jax.tree.map(np.asarray, {"params": state["params"],
                                     "opt_state": state["opt_state"]})


def _port_state(ttr, host, with_critic=False):
    state = ttr.agent.init_state(with_critic=with_critic)
    state["params"] = convert_agent_params(host["params"], ttr.agent)
    state["opt_state"] = convert_opt_state(host["opt_state"], ttr.agent.optimizer,
                                           state["params"])
    return state


def _losses(out):
    with open(os.path.join(out, "train.csv")) as f:
        return {int(float(r["step"])): float(r["loss"]) for r in csv.DictReader(f)}


def _losses_close(tout, jout, steps):
    tl, jl = _losses(tout), _losses(jout)
    assert sorted(tl) == sorted(jl) == steps
    for it in steps:
        assert abs(tl[it] - jl[it]) <= 1e-4 + 1e-4 * abs(jl[it]), (it, tl[it], jl[it])


def _params_close(tstate, jhost, tagent, n_steps):
    """The Adam-step rule of the module docstring, per parameter."""
    jp = convert_agent_params(jhost["params"], tagent)
    mu = convert_agent_params(jhost["opt_state"][1][0].mu, tagent)
    for part in jp:
        for name, want in jp[part].items():
            got = tstate["params"][part][name]
            delta = np.abs(got.numpy() - want.numpy())
            big = np.abs(mu[part][name].numpy()) > 1e-5
            assert delta.max() <= 2 * n_steps * LR + 1e-6, (part, name)
            assert (delta[big] <= n_steps * LR * 1e-2 + 1e-6).all(), (part, name)


# -- (b) teacher forcing ---------------------------------------------------------------

def test_trainer_matches_the_jax_trainer_over_four_teacher_iterations(tmp_path, jax_agent):
    jtr = _jax_trainer(tmp_path / "jax", jax_agent)
    ttr = _torch_trainer(tmp_path / "torch")
    jstate = jtr.agent.init_state()
    tstate = _port_state(ttr, _host(jstate))
    tfinal = ttr.train(state=tstate)
    jhost = _host(jtr.train(state=jstate))
    _losses_close(ttr.cfg.output_dir, jtr.cfg.output_dir, [1, 2, 3, 4])
    _params_close(tfinal, jhost, ttr.agent, 4)
    assert ttr.ckpt.steps() == [2, 4] and not ttr.preempted
    assert tfinal["opt_state"][1]["count"] == 4


# -- (c) student forcing under a stand-in sampler ----------------------------------------

def test_sampled_trainer_matches_the_jax_trainer_under_a_stand_in_sampler(tmp_path,
                                                                          monkeypatch,
                                                                          jax_agent):
    """feedback_method "sample" for 2 iterations: both packages draw their
    actions from argmax(logit + one fixed noise table), patched in before
    the JAX trainer traces its step."""
    noise = np.random.default_rng(11).gumbel(size=(2, 16)).astype(np.float32)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, axis=-1, **kw: jnp.argmax(logits + noise, axis))
    monkeypatch.setattr(tdec, "categorical", lambda logit, generator=None: torch.argmax(
        logit + torch.from_numpy(noise), dim=-1))
    kw = dict(feedback_method="sample", num_iterations=2)
    jtr = _jax_trainer(tmp_path / "jax", jax_agent, **kw)
    ttr = _torch_trainer(tmp_path / "torch", **kw)
    jstate = jtr.agent.init_state()
    tfinal = ttr.train(state=_port_state(ttr, _host(jstate)))
    jhost = _host(jtr.train(state=jstate))
    _losses_close(ttr.cfg.output_dir, jtr.cfg.output_dir, [1, 2])
    _params_close(tfinal, jhost, ttr.agent, 2)


# -- (d) cross-framework resume ----------------------------------------------------------

def test_port_resumes_a_jax_run(tmp_path, jax_agent):
    """JAX trains 2 iterations; its params and optimizer state, converted,
    become the port's checkpoint-2, from which the port resumes for 2 more.
    That matches the JAX trainer resuming from its own checkpoint."""
    jtr = _jax_trainer(tmp_path / "jax", jax_agent, num_iterations=2)
    jhost2 = _host(jtr.train())
    assert jtr.ckpt.steps() == [2]
    jtr4 = _jax_trainer(tmp_path / "jax", jax_agent, num_iterations=4)
    jhost4 = _host(jtr4.train(resume=True))
    ttr = _torch_trainer(tmp_path / "torch", num_iterations=4)
    start = _port_state(ttr, jhost2)
    ttr.ckpt.save(2, start["params"], start["opt_state"])
    tfinal = ttr.train(resume=True)
    assert ttr.ckpt.steps() == [2, 4]
    _losses_close(ttr.cfg.output_dir, jtr4.cfg.output_dir, [3, 4])
    _params_close(tfinal, jhost4, ttr.agent, 4)
    assert tfinal["opt_state"][1]["count"] == 4


# -- (e) port resume, bit for bit ---------------------------------------------------------

def _equal_trees(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_port_resume_is_bit_exact(tmp_path):
    """4 iterations saving at 2 and 4, then a new trainer resumes to 6: the
    params and the optimizer state equal an uninterrupted 6-iteration run's
    bit for bit (dropouts 0, teacher forcing: nothing draws)."""
    whole = _torch_trainer(tmp_path / "whole", num_iterations=6).train()
    first = _torch_trainer(tmp_path / "split", num_iterations=4)
    first.train()
    assert first.ckpt.steps() == [2, 4]
    second = _torch_trainer(tmp_path / "split", num_iterations=6)
    resumed = second.train(resume=True)
    assert second.ckpt.steps() == [2, 4, 6]
    _equal_trees(resumed["params"], whole["params"])
    _equal_trees(resumed["opt_state"], whole["opt_state"])
    assert _losses(str(tmp_path / "split")) == {
        k: v for k, v in _losses(str(tmp_path / "whole")).items() if k > 4}


def test_profile_steps_writes_a_trace(tmp_path):
    """``profile_steps`` traces steps 2..n+1 with torch.profiler into
    <output_dir>/profile."""
    ttr = _torch_trainer(tmp_path, num_iterations=3, saving_steps=3)
    ttr.train(profile_steps=1)
    trace = json.load(open(tmp_path / "profile" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names
    assert ttr.ckpt.steps() == [3]


# -- (f) the checkpoint manager ------------------------------------------------------------

def _tree(x):
    return {"w": torch.full((4, 4), x), "b": {"c": torch.arange(4.0)}}


def test_checkpoint_lists_only_marked_directories(tmp_path):
    mgr = TCkpt(str(tmp_path))
    mgr.save(10, _tree(1.0), [{}, {"count": 3, "mu": _tree(0.5)}])
    half = tmp_path / "checkpoint-20"
    half.mkdir()
    torch.save(_tree(2.0), half / "params.pt")
    assert mgr.steps() == [10] and mgr.latest() == 10
    (half / "meta.json").write_text(json.dumps({"step": 20}))
    assert mgr.steps() == [10, 20]
    meta = json.loads((tmp_path / "checkpoint-10" / "meta.json").read_text())
    assert meta == {"step": 10}
    restored = mgr.restore(10, {"params": _tree(0.0),
                                "opt_state": [{}, {"count": 0, "mu": _tree(0.0)}]})
    assert torch.equal(restored["params"]["w"], _tree(1.0)["w"])
    assert restored["opt_state"][1]["count"] == 3


def test_async_save_commits_its_marker_after_the_write(tmp_path, monkeypatch):
    """The payload write is held on the background thread: save returns,
    the marker is absent until the write finishes, and a flush commits it."""
    import visitron_torch.train.checkpoint as ckmod

    release, writing = threading.Event(), threading.Event()
    real_save = torch.save

    def slow_save(obj, f):
        writing.set()
        assert release.wait(30)
        real_save(obj, f)

    monkeypatch.setattr(ckmod.torch, "save", slow_save)
    mgr = TCkpt(str(tmp_path), async_save=True)
    params = _tree(1.0)
    mgr.save(1, params, extra={"note": "x"})
    assert writing.wait(30)
    params["w"].add_(5.0)  # the caller's tensors change; the copy does not
    assert not (tmp_path / "checkpoint-1" / "meta.json").exists()
    assert mgr.steps() == []
    release.set()
    mgr.wait_until_finished()
    assert mgr.steps() == [1]
    assert json.loads((tmp_path / "checkpoint-1" / "meta.json").read_text()) == {
        "step": 1, "note": "x"}
    assert torch.equal(mgr.restore_raw(1)["w"], _tree(1.0)["w"])
    mgr.save(2, _tree(2.0), wait=True)  # wait=True: durable on return
    assert mgr.steps() == [1, 2]


def test_restore_refuses_missing_extra_keys_and_other_shapes(tmp_path):
    mgr = TCkpt(str(tmp_path))
    mgr.save(1, _tree(1.0))
    with pytest.raises(KeyError, match="missing"):
        mgr.restore(1, {"params": {**_tree(0.0), "extra": torch.zeros(1)}})
    with pytest.raises(KeyError, match="lacks"):
        mgr.restore(1, {"params": {"w": torch.zeros(4, 4), "b": {}}})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, {"params": {"w": torch.zeros(4, 5), "b": {"c": torch.zeros(4)}}})
    got = mgr.restore(1, {"params": {"w": torch.zeros(4, 4, dtype=torch.bfloat16),
                                     "b": {"c": torch.zeros(4)}}})
    assert got["params"]["w"].dtype == torch.bfloat16


def test_rl_checkpoint_restores_raw_for_val(tmp_path):
    """An RL run's checkpoints carry the critic and its moments; val and the
    submission read them raw and roll out with the encoder and decoder."""
    ttr = _torch_trainer(tmp_path, feedback_method="rl", num_iterations=2,
                         saving_steps=2)
    state = ttr.train()
    assert "critic" in state["params"] and "critic" in ttr.ckpt.restore_raw(2)
    with pytest.raises(KeyError):  # a template without the critic refuses
        ttr.ckpt.restore(2, {"params": ttr.agent.init_params()})
    out = ttr.val(steps=[2], splits=("val_seen",))
    assert np.isfinite(out[(2, "val_seen")]["loss"])
    assert os.path.exists(os.path.join(ttr.cfg.output_dir, "preds_val_seen_2.json"))


# -- (g) preemption ----------------------------------------------------------------------

def test_guard_latches_chains_and_restores():
    seen = []

    def prev(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGTERM, prev)
    try:
        with TGuard() as guard:
            assert not guard.fired and not guard.should_stop(1)
            signal.raise_signal(signal.SIGTERM)
            assert guard.fired and guard.should_stop(2) and guard.stop
            assert seen == [signal.SIGTERM]
        assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        signal.signal(signal.SIGTERM, old)


def test_guard_inert_off_main_thread():
    out = {}

    def body():
        with TGuard() as g:
            out["fired"] = g.fired

    t = threading.Thread(target=body)
    t.start()
    t.join()
    assert out == {"fired": False}


def test_sigterm_mid_loop_saves_and_stops(tmp_path, monkeypatch):
    """SIGTERM during the second step: the trainer finishes it, writes
    checkpoint-2 off the saving grid, stops with ``preempted`` set; a resume
    completes the run."""
    calls = {"n": 0}
    orig = TAgent.train_step_fn

    def firing(self):
        step = orig(self)

        def wrapped(state, batch):
            out = step(state, batch)
            calls["n"] += 1
            if calls["n"] == 2:
                signal.raise_signal(signal.SIGTERM)
            return out

        return wrapped

    monkeypatch.setattr(TAgent, "train_step_fn", firing)
    ttr = _torch_trainer(tmp_path, saving_steps=10)
    ttr.train()
    assert ttr.ckpt.steps() == [2] and ttr.preempted
    assert ttr.ckpt.restore_raw(2, "opt_state")[1]["count"] == 2
    again = _torch_trainer(tmp_path, saving_steps=10)
    again.train(resume=True)
    assert again.ckpt.steps() == [2, 4] and not again.preempted and calls["n"] == 4


# -- (h) the agent optimizers --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["rms", "sgd", "adamax", "adam"])
def test_agent_optimizers_match_optax(kind):
    """Three updates on a random tree (gradients past the clip once), from
    the port's chain and from optax's, within 1e-6; the states too."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                          params) for scale in (0.3, 30.0, 0.01)]
    jo, to = jopt.agent_optimizer(1e-2, kind), topt.agent_optimizer(1e-2, kind)
    jp, js = params, jo.init(params)
    tp = jax.tree.map(torch.tensor, params)
    ts = to.init(tp)
    for g in grads:
        ju, js = jo.update(g, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = to.update(jax.tree.map(torch.tensor, g), ts, tp)
        tp = topt.apply_updates(tp, tu)
    for a, b in zip(jax.tree.leaves(jp), topt.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6)
    jstates = [s for s in jax.tree.leaves(js, is_leaf=lambda x: hasattr(x, "_fields"))
               if s._fields]
    tstates = [s for s in ts if s]
    assert [sorted(s._fields) for s in jstates] == [sorted(s) for s in tstates]
    for jstate, tstate in zip(jstates, tstates):
        for key in jstate._fields:
            if key == "count":
                assert int(getattr(jstate, key)) == tstate[key] == 3
                continue
            for a, b in zip(jax.tree.leaves(getattr(jstate, key)),
                            topt.tree_leaves(tstate[key])):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=1e-6,
                                           err_msg=f"{kind} {key}")


def test_convert_opt_state_places_every_leaf_or_raises():
    """The pretraining chain (AdamW, a schedule, bf16 moments) converts by
    field name; a chain of another shape raises."""
    params = {"params": {"dense": {"kernel": np.ones((3, 2), np.float32),
                                   "bias": np.zeros(2, np.float32)}}}
    tp = {"dense.weight": torch.ones(2, 3), "dense.bias": torch.zeros(2)}
    g = jax.tree.map(lambda x: np.full_like(x, 0.1), params)
    for bf16, wd in ((False, 0.0), (True, 0.01)):
        jo = jopt.adamw_with_warmup(1e-3, 2, 10, weight_decay=wd, bf16_moments=bf16)
        to = topt.adamw_with_warmup(1e-3, 2, 10, weight_decay=wd, bf16_moments=bf16)
        _, js = jo.update(g, jo.init(params), params)
        state = convert_opt_state(jax.tree.map(np.asarray, js), to, tp)
        assert state[1]["count"] == 1 and state[-1] == {"count": 1}
        assert state[1]["mu"]["dense.weight"].dtype == (torch.bfloat16 if bf16
                                                        else torch.float32)
        np.testing.assert_allclose(state[1]["mu"]["dense.weight"].float().numpy(),
                                   np.full((2, 3), 0.01), rtol=1e-2)
    adam = jax.tree.map(np.asarray, jopt.agent_optimizer(1e-3).init(params))
    with pytest.raises(KeyError, match="ScaleByAdamState"):
        convert_opt_state(adam, topt.agent_optimizer(1e-3, "rms"), tp)
    with pytest.raises(ValueError, match="chain"):
        convert_opt_state(adam, topt.adamw_with_warmup(1e-3, 2, 10), tp)


# -- (i) the pretraining graft ---------------------------------------------------------------

def test_graft_matches_the_jax_graft(tmp_path, jax_agent):
    """A JAX pretraining params tree, saved through the JAX checkpoint
    manager and grafted into a JAX encoder, then converted, equals the same
    tree converted, saved as a port checkpoint and grafted by the port."""
    from visitron_tpu.models import PretrainModel as JPretrainModel
    from visitron_tpu.models.oscar_import import \
        graft_pretrain_checkpoint_into_encoder as jgraft
    from visitron_tpu.train.checkpoint import CheckpointManager as JCkpt

    jtr = _jax_trainer(tmp_path / "jfine", jax_agent)
    ttr = _torch_trainer(tmp_path / "tfine")
    pcfg = dict(vocab_size=jtr.ws.bert_config.vocab_size, img_feature_dim=56,
                detector_classes=5, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, **TINY)
    jmodel = JPretrainModel(JBert(**pcfg))
    s, m = 16, 8
    jparams = jax.jit(lambda r: jmodel.init(
        r, jnp.ones((1, s), jnp.int32), token_type_ids=jnp.zeros((1, s), jnp.int32),
        attention_mask=jnp.ones((1, s + m), jnp.int32),
        img_feats=jnp.zeros((1, m, 56)), img_location_embeddings=jnp.zeros((1, m, 128))))(
        jax.random.PRNGKey(3))
    jparams = jax.tree.map(np.asarray, jparams)
    JCkpt(str(tmp_path / "jpre")).save(7, jparams)
    jinit = jax.tree.map(np.asarray, jtr.agent.init_state()["params"])
    jenc, jdec = jinit["encoder"], jinit["decoder"]
    jgrafted = jgraft(jenc, str(tmp_path / "jpre"))
    want = convert_agent_params({"encoder": jgrafted, "decoder": jdec},
                                ttr.agent)["encoder"]

    tmodel = TPretrainModel(TBert(**pcfg))
    tparams = convert_pretrain_params(jparams, tmodel)
    TCkpt(str(tmp_path / "tpre")).save(7, tparams, [{}])
    assert is_pretrain_checkpoint(str(tmp_path / "tpre"))
    assert is_pretrain_checkpoint(str(tmp_path / "tpre" / "checkpoint-7"))
    assert not is_pretrain_checkpoint(str(tmp_path / "jpre" / "checkpoint-7"))
    tenc = convert_agent_params({"encoder": jenc, "decoder": jdec}, ttr.agent)["encoder"]
    for path in (tmp_path / "tpre", tmp_path / "tpre" / "checkpoint-7"):
        tgrafted = graft_pretrain_checkpoint_into_encoder(tenc, str(path))
        assert set(tgrafted) == set(want)
        for name, v in want.items():
            assert torch.equal(tgrafted[name], v), name
    moved = [n for n in tenc if not torch.equal(tenc[n], tgrafted[n])]
    assert moved and all(n.startswith("bert.bert.") for n in moved)
    assert torch.equal(tgrafted["lstm.fwd.wi"], tenc["lstm.fwd.wi"])
    wide = {k: torch.zeros(*v.shape[:-1], 2 * v.shape[-1]) for k, v in tparams.items()}
    TCkpt(str(tmp_path / "wide")).save(1, wide)
    with pytest.raises(ValueError, match="shape"):
        graft_pretrain_checkpoint_into_encoder(tenc, str(tmp_path / "wide"))
    TCkpt(str(tmp_path / "none")).save(1, {"head.weight": torch.zeros(2)})
    with pytest.raises(ValueError, match="shares no BERT"):
        graft_pretrain_checkpoint_into_encoder(tenc, str(tmp_path / "none"))


def test_trainer_refuses_unported_options(tmp_path):
    """Pipeline parallelism (ROADMAP item 10c) raises by name, a dp or tp
    mesh of more ranks than the process group has is refused, ZeRO-1 in one
    process shards nothing; a model path that is not a port pretraining
    checkpoint goes to the Oscar / HuggingFace import (an empty
    ``pytorch_model.bin`` fails to load); a missing model path trains from
    scratch, as in the JAX package."""
    with pytest.raises(ValueError, match="--mesh_pp applies to the pretrain task"):
        _torch_trainer(tmp_path, mesh_pp=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        _torch_trainer(tmp_path, mesh_tp=2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        _torch_trainer(tmp_path, mesh_dp=2)
    assert _torch_trainer(tmp_path, zero1=True).agent.dp is None
    oscar = tmp_path / "oscar"
    oscar.mkdir()
    (oscar / "pytorch_model.bin").write_bytes(b"")
    ttr = _torch_trainer(tmp_path, model_name_or_path=str(oscar))
    with pytest.raises((EOFError, RuntimeError)):  # torch.load of an empty file
        ttr._pretrained_params(ttr.agent.init_params())
    ttr = _torch_trainer(tmp_path, model_name_or_path=str(tmp_path / "absent"))
    params = ttr.agent.init_params()
    assert ttr._pretrained_params(params) is params
