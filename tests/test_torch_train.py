"""The port's teacher-forced train step against the JAX package's
(``ViewpointAgent.train_step_fn``), on the CPU in fp32 with every dropout at
0: the training schedule and teacher arrays of ``train_batches``, the loss,
every gradient and the parameters after one Adam step, with the JAX
parameters carried across by visitron_torch.convert.  Also the masked LSTM's
gradients, the dropout helpers' statistics, ``eval_loss_fn`` and a short
overfit run.  Tiny config: 2 layers, hidden 128, 2 heads of 64, S 128,
batch 4, 3-step episodes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch.convert import convert_agent_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models import layers as tlayers
from visitron_torch.models import lstm as tlstm
from visitron_torch.models.bert import BertSelfAttention
from visitron_torch.ops import attention as tatt
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.models import BertConfig as JConfig
from visitron_tpu.models import lstm as jlstm
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

SEQ = 128
EP_LEN = 3
BATCH = 4
LR = 5e-5
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, max_position_embeddings=SEQ, type_vocab_size=4,
             hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
AGENT = dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
             aemb=8, dropout=0.0, learning_rate=LR)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny train steps gain nothing from intra-op threads, and with
    several test workers per machine the threads only contend; restored
    after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")), counts={"train": 10})
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")), counts={"train": 10})
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    jinst = jd.build_nav_instances(jroot, ["train"], jtok, max_seq_length=SEQ)
    tinst = td.build_nav_instances(troot, ["train"], ttok, max_seq_length=SEQ)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, tw.scene_features(), vfov=60), device="cpu")
    jagent = ja.ViewpointAgent(JConfig(vocab_size=len(jtok), **SMALL), jrt, **AGENT,
                               max_seq_length=SEQ)
    tagent = ta.ViewpointAgent(TConfig(vocab_size=len(ttok), **SMALL), trt, **AGENT,
                               device="cpu")
    jstate = jagent.init_state()
    jparams = jax.tree_util.tree_map(np.asarray, jstate["params"])
    tparams = convert_agent_params(jparams, tagent)
    jbatch = next(JBatcher(jinst, jrt, batch_size=BATCH).train_batches(1, EP_LEN))
    tbatch = next(ta.NavEpisodeBatcher(tinst, trt, batch_size=BATCH)
                  .train_batches(1, EP_LEN))
    return {"jinst": jinst, "tinst": tinst, "jrt": jrt, "trt": trt, "jagent": jagent,
            "tagent": tagent, "jstate": jstate, "jparams": jparams,
            "tparams": tparams, "jbatch": jbatch, "tbatch": tbatch}


def _arrays(batch):
    return {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, list)}


def test_train_schedule_and_teacher_arrays_match_jax(pair):
    jb = JBatcher(pair["jinst"], pair["jrt"], batch_size=BATCH, seed=5)
    tb = ta.NavEpisodeBatcher(pair["tinst"], pair["trt"], batch_size=BATCH, seed=5)
    jb.skip_batches(2)
    tb.skip_batches(2)
    # 10 instances in batches of 4: epochs wrap and re-window.
    for jbatch, tbatch in zip(jb.train_batches(6, episode_len=EP_LEN),
                              tb.train_batches(6, episode_len=EP_LEN)):
        assert jbatch.keys() == tbatch.keys()
        assert jbatch["inst_idx"] == tbatch["inst_idx"]
        assert jbatch["scans"] == tbatch["scans"]
        for k, v in _arrays(jbatch).items():
            np.testing.assert_array_equal(tbatch[k], v, err_msg=k)
    assert tbatch["active"].dtype == bool and tbatch["teacher"].shape == (BATCH, EP_LEN)


def test_train_step_matches_jax(pair):
    """Loss (1e-5 relative), every gradient (1e-4) and the parameters after
    the first Adam step.  That step moves each parameter by lr * g / (|g| +
    eps), i.e. +-lr wherever |g| >> eps, so a gradient that agrees to 1e-4
    gives the same update up to lr * 1e-2 where |g| > 1e-5 (1000 eps); where
    |g| is near eps (or zero on one side at the fp32 noise level) the update
    is bounded by 2 lr."""
    jagent, tagent = pair["jagent"], pair["tagent"]
    jb = _arrays(jagent.trim_batch(pair["jbatch"]))
    loss_fn = jax.jit(lambda p: jagent._episode_loss(
        pair["jrt"], p, jb, jax.random.PRNGKey(0), deterministic=False))
    jloss, jgrads = jax.value_and_grad(loss_fn)(pair["jstate"]["params"])
    jgrads = convert_agent_params(jax.tree_util.tree_map(np.asarray, jgrads), tagent)
    tbatch = tagent.trim_batch(pair["tbatch"])
    assert tbatch["ids"].shape == jb["ids"].shape
    state = tagent.init_state()
    state["params"] = pair["tparams"]
    state["opt_state"] = tagent.optimizer.init(state["params"])
    tloss, tgrads = tagent.loss_and_grads(state["params"], tbatch, state["rng"])
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for part in ("encoder", "decoder"):
        assert set(tgrads[part]) == set(jgrads[part])
        for name, g in tgrads[part].items():
            assert g.dtype == torch.float32, name
            np.testing.assert_allclose(g.numpy(), jgrads[part][name].numpy(),
                                       atol=1e-4, rtol=0, err_msg=name)

    jnew, jl = jagent.train_step_fn()(pair["jstate"], _arrays(pair["jbatch"]))
    tnew, tl = tagent.train_step_fn()(state, pair["tbatch"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    jnew = convert_agent_params(jax.tree_util.tree_map(np.asarray, jnew["params"]), tagent)
    for part in ("encoder", "decoder"):
        for name, p in tnew["params"][part].items():
            delta = np.abs(p.numpy() - jnew[part][name].numpy())
            big = np.abs(jgrads[part][name].numpy()) > 1e-5
            assert delta.max() <= 2 * LR + 1e-6, name
            assert (delta[big] <= LR * 1e-2 + 1e-6).all(), name
            moved = np.abs(p.numpy() - pair["tparams"][part][name].numpy())
            assert (moved[big] > 0.5 * LR).all(), name


def test_masked_lstm_grads_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, 12)).astype(np.float32)
    lengths = np.array([20, 7, 1], np.int32)
    dys = rng.standard_normal((3, 20, 5)).astype(np.float32)
    p = {n: (0.3 * rng.standard_normal(s)).astype(np.float32) for n, s in
         (("wi", (20, 12)), ("wh", (20, 5)), ("bi", (20,)), ("bh", (20,)))}

    def jloss(p, x):
        ys, (h, c) = jlstm.masked_lstm_scan(p, x, jnp.asarray(lengths))
        return jnp.sum(ys * dys) + jnp.sum(h) + 2.0 * jnp.sum(c)

    want = jax.grad(jloss, argnums=(0, 1))(jax.tree_util.tree_map(jnp.asarray, p),
                                           jnp.asarray(x))
    tp = {n: torch.from_numpy(v).requires_grad_() for n, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    ys, (h, c) = tlstm.masked_lstm_scan(tp, tx, torch.from_numpy(lengths).long())
    loss = torch.sum(ys * torch.from_numpy(dys)) + h.sum() + 2.0 * c.sum()
    got = torch.autograd.grad(loss, [tp[n] for n in sorted(tp)] + [tx])
    for g, w in zip(got, [want[0][n] for n in sorted(p)] + [want[1]]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_fraction_and_scale(rate):
    x = torch.full((400, 500), 2.0)
    g = torch.Generator().manual_seed(0)
    y = tlayers.dropout(x, rate, g, deterministic=False)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 2.0 / (1 - rate)))
    assert torch.equal(tlayers.dropout(x, rate, g, deterministic=True), x)
    # The same generator state gives the same mask; a later draw another.
    g2 = torch.Generator().manual_seed(0)
    assert torch.equal(tlayers.dropout(x, rate, g2, deterministic=False), y)
    assert not torch.equal(tlayers.dropout(x, rate, g2, deterministic=False), y)


def test_attention_dropout_draws_a_seed_per_call_and_uses_the_hash_mask():
    """BertSelfAttention in a training pass draws an int32 seed from the
    CPU seed generator and runs K1 (its twin here) with the hash mask at
    attention_probs_dropout_prob; that mask is the JAX package's for the
    same seed (tests/test_torch_ops.py).  S 128: the smallest length the
    fused kernels take (shorter ones run the plain attention, as in JAX)."""
    cfg = TConfig(vocab_size=10, hidden_size=128, num_attention_heads=2,
                  attention_probs_dropout_prob=0.1)
    layer = BertSelfAttention(cfg)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.2, generator=torch.Generator().manual_seed(1))
    hidden = torch.randn(2, 128, 128, generator=torch.Generator().manual_seed(2))
    kb = torch.zeros(2, 128)

    def rng():
        return tlayers.DropoutRng(torch.Generator().manual_seed(3),
                                  torch.Generator().manual_seed(4))

    with torch.no_grad():
        r = rng()
        got1, got2 = layer(hidden, kb, rng=r), layer(hidden, kb, rng=r)
        seeds = rng()
        s1, s2 = seeds.seed(), seeds.seed()
        assert 0 <= s1 < 2 ** 31 - 1 and s1 != s2
        q, k, v = layer.qkv(hidden).split(128, dim=-1)
        want1 = tatt.fused_attention_packed(q, k, v, kb, 2, s1, 0.1)
        assert torch.equal(got1, want1)
        assert torch.equal(got2, tatt.fused_attention_packed(q, k, v, kb, 2, s2, 0.1))
        assert not torch.equal(got1, tatt.fused_attention_packed(q, k, v, kb, 2))
        assert torch.equal(layer(hidden, kb), tatt.fused_attention_packed(q, k, v, kb, 2))


def test_eval_loss_matches_jax_and_train_mode_dropout_changes_loss(pair):
    jagent, tagent = pair["jagent"], pair["tagent"]
    jl = jagent.eval_loss_fn(use_dropout=False)(
        pair["jstate"]["params"], _arrays(pair["jbatch"]), jax.random.PRNGKey(0))
    tl = tagent.eval_loss_fn(use_dropout=False)(pair["tparams"], pair["tbatch"])
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # The same weights in an agent with the default dropouts: the training
    # loss differs from the deterministic one, and eval without dropout does
    # not depend on the agent's rates.
    cfg = TConfig(vocab_size=tagent.cfg.vocab_size,
                  **{**SMALL, "hidden_dropout_prob": 0.1,
                     "attention_probs_dropout_prob": 0.1})
    drop = ta.ViewpointAgent(cfg, pair["trt"], **{**AGENT, "dropout": 0.5}, device="cpu")
    rng = drop.init_state()["rng"]
    batch = drop.trim_batch(pair["tbatch"])
    with torch.no_grad():
        noisy = drop.episode_loss(pair["tparams"], batch, rng)
    assert float(noisy) != pytest.approx(float(tl), rel=1e-4)
    np.testing.assert_allclose(
        float(drop.eval_loss_fn()(pair["tparams"], pair["tbatch"])), float(tl), rtol=1e-6)
    with pytest.raises(ValueError):
        drop.eval_loss_fn(use_dropout=True)(pair["tparams"], pair["tbatch"])


def test_twenty_steps_on_one_batch_lower_the_loss(pair):
    cfg = TConfig(vocab_size=pair["tagent"].cfg.vocab_size,
                  **{**SMALL, "hidden_dropout_prob": 0.1,
                     "attention_probs_dropout_prob": 0.1})
    agent = ta.ViewpointAgent(cfg, pair["trt"], **{**AGENT, "dropout": 0.5,
                                                   "learning_rate": 1e-3}, device="cpu")
    state = agent.init_state()
    before = {(part, n): t.clone() for part, d in state["params"].items()
              for n, t in d.items()}
    step, ev = agent.train_step_fn(), agent.eval_loss_fn()
    first = float(ev(state["params"], pair["tbatch"]))
    losses = []
    for _ in range(20):
        state, loss = step(state, pair["tbatch"])
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert float(ev(state["params"], pair["tbatch"])) < 0.7 * first
    assert state["opt_state"][1]["count"] == 20
    # Every parameter moved except the BERT pooler, which the loss does not
    # reach (its gradient is zero, as in JAX).
    still = {key for key, t in before.items()
             if torch.equal(t, state["params"][key[0]][key[1]])}
    assert still == {("encoder", "bert.bert.pooler.dense.weight"),
                     ("encoder", "bert.bert.pooler.dense.bias")}
