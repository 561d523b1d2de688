"""The port's NDH fine-tuning at bench.py's long workload and with the two
options its knobs set (BENCH_EPISODE_LEN=40 with BENCH_PATH_TYPE=trusted_path,
BENCH_REMAT, BENCH_BF16_ADAM), against the JAX package on the CPU:

  * ``NavEpisodeBatcher.train_batches(episode_len=40)`` on trusted_path (and
    player_path) equals the JAX batcher's, key by key;
  * one teacher-forced step at T 40 (fp32, every dropout 0): the loss within
    1e-5 relative, every gradient within 1e-4 and the Adam update as
    tests/test_torch_train.py holds the short step;
  * ``BertConfig(remat=True)``: with the dropouts on, the port's loss equals
    the step without remat bit for bit (same seeds) and the gradients agree
    within 1e-6; with the dropouts at 0 it agrees with the JAX agent built
    with ``remat=True`` as above;
  * ``bf16_adam_moments``: two steps of the port and of the JAX agent agree
    within lr * 1e-2 (tests/test_torch_optim.py's bf16 tolerance) wherever
    the gradients are well above the fp32 noise, and the port's moments are
    bf16 tensors.

Tiny config: 2 layers, hidden 128, 2 heads of 64, S 128, batch 4."""

import jax
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch.convert import convert_agent_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train.optim import tree_leaves
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.models import BertConfig as JConfig
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

SEQ = 128
EP_LEN = 40
BATCH = 4
LR = 5e-5
SMALL = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, max_position_embeddings=SEQ, type_vocab_size=4)
NO_DROP = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
AGENT = dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
             aemb=8, learning_rate=LR)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")), counts={"train": 10})
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")), counts={"train": 10})
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jtok, ttok = jd.WordPieceTokenizer(vocab), td.WordPieceTokenizer(vocab)
    return {"jinst": jd.build_nav_instances(jroot, ["train"], jtok, max_seq_length=SEQ),
            "tinst": td.build_nav_instances(troot, ["train"], ttok, max_seq_length=SEQ),
            "jrt": ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
                jw.graphs, jw.scene_features(), vfov=60)),
            "trt": ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
                tw.graphs, tw.scene_features(), vfov=60), device="cpu"),
            "vocab": len(jtok)}


def _arrays(batch):
    return {k: np.asarray(v) for k, v in batch.items() if not isinstance(v, list)}


def _batches(world, n, seed=88):
    """n trusted-path T 40 batches from both batchers (the same schedule)."""
    jb = JBatcher(world["jinst"], world["jrt"], batch_size=BATCH, seed=seed)
    tb = ta.NavEpisodeBatcher(world["tinst"], world["trt"], batch_size=BATCH, seed=seed)
    return (list(jb.train_batches(n, episode_len=EP_LEN)),
            list(tb.train_batches(n, episode_len=EP_LEN)))


def _agents(world, bert=NO_DROP, dropout=0.0, **kw):
    """The JAX agent, the port's, and the JAX parameters carried across;
    ``dropout`` the decoder's."""
    jagent = ja.ViewpointAgent(JConfig(vocab_size=world["vocab"], **SMALL, **bert),
                               world["jrt"], **AGENT, max_seq_length=SEQ,
                               dropout=dropout, **kw)
    tagent = ta.ViewpointAgent(TConfig(vocab_size=world["vocab"], **SMALL, **bert),
                               world["trt"], **AGENT, device="cpu", dropout=dropout,
                               **kw)
    jstate = jagent.init_state()
    tparams = convert_agent_params(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                                   tagent)
    return jagent, tagent, jstate, tparams


def _jax_grads(jagent, tagent, params, jbatch):
    """(loss, grads in the port's layout) of the JAX teacher-forced loss."""
    jb = _arrays(jagent.trim_batch(jbatch))
    loss_fn = jax.jit(lambda p: jagent._episode_loss(
        jagent.runtime, p, jb, jax.random.PRNGKey(0), deterministic=False))
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), convert_agent_params(jax.tree_util.tree_map(np.asarray, grads),
                                             tagent)


def _state(tagent, params):
    state = tagent.init_state()
    state["params"] = {part: {k: v.clone() for k, v in d.items()}
                       for part, d in params.items()}
    state["opt_state"] = tagent.optimizer.init(state["params"])
    return state


def _check_grads(tgrads, jgrads):
    for part in ("encoder", "decoder"):
        assert set(tgrads[part]) == set(jgrads[part])
        for name, g in tgrads[part].items():
            np.testing.assert_allclose(g.numpy(), jgrads[part][name].numpy(), atol=1e-4,
                                       rtol=0, err_msg=name)


def _check_update(new, start, want, big_masks, steps: int):
    """The port's parameters after ``steps`` Adam steps against the JAX
    package's: within lr * 1e-2 wherever every step's gradient is above 1e-5
    (1000 eps: each step moves such a parameter by about lr in both), within
    2 lr a step elsewhere; and moved by more than lr / 2 after one step."""
    for part in ("encoder", "decoder"):
        for name, p in new[part].items():
            delta = np.abs(p.numpy() - want[part][name].numpy())
            big = np.logical_and.reduce([m[part][name] for m in big_masks])
            assert delta.max() <= 2 * steps * LR + 1e-6, name
            assert (delta[big] <= LR * 1e-2 + 1e-6).all(), name
            if steps == 1:
                moved = np.abs(p.numpy() - start[part][name].numpy())
                assert (moved[big] > 0.5 * LR).all(), name


def _big(grads):
    return {part: {k: np.abs(v.numpy()) > 1e-5 for k, v in d.items()}
            for part, d in grads.items()}


@pytest.mark.parametrize("path_type", ["trusted_path", "player_path"])
def test_t40_batches_match_jax(world, path_type):
    jb = JBatcher(world["jinst"], world["jrt"], batch_size=BATCH, path_type=path_type,
                  seed=5)
    tb = ta.NavEpisodeBatcher(world["tinst"], world["trt"], batch_size=BATCH,
                              path_type=path_type, seed=5)
    # 10 instances in batches of 4: the epochs wrap.
    for jbatch, tbatch in zip(jb.train_batches(5, episode_len=EP_LEN),
                              tb.train_batches(5, episode_len=EP_LEN)):
        assert jbatch.keys() == tbatch.keys()
        assert jbatch["inst_idx"] == tbatch["inst_idx"]
        assert jbatch["scans"] == tbatch["scans"]
        for k, v in _arrays(jbatch).items():
            np.testing.assert_array_equal(tbatch[k], v, err_msg=k)
    assert tbatch["teacher"].shape == (BATCH, EP_LEN)
    # Some episode ends before step 40: the tail is inactive.
    assert not tbatch["active"][:, -1].all()


@pytest.mark.parametrize("remat", [False, True])
def test_t40_train_step_matches_jax(world, remat):
    """One fp32 step at T 40 (dropouts 0), with and without remat on both
    sides."""
    jagent, tagent, jstate, tparams = _agents(world, {**NO_DROP, "remat": remat})
    (jbatch,), (tbatch,) = _batches(world, 1)
    jloss, jgrads = _jax_grads(jagent, tagent, jstate["params"], jbatch)
    state = _state(tagent, tparams)
    tloss, tgrads = tagent.loss_and_grads(state["params"], tagent.trim_batch(tbatch),
                                          state["rng"])
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5)
    _check_grads(tgrads, jgrads)
    jnew, jl = jagent.train_step_fn()(jstate, _arrays(jbatch))
    tnew, tl = tagent.train_step_fn()(state, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = convert_agent_params(jax.tree_util.tree_map(np.asarray, jnew["params"]), tagent)
    _check_update(tnew["params"], tparams, want, [_big(jgrads)], steps=1)


def test_t40_remat_equals_the_plain_step_with_dropouts_on(world):
    """The agent's dropouts (BERT 0.1, decoder 0.5) from the same seeds: the
    remat step's loss is the plain step's bit for bit, its gradients within
    1e-6."""
    bert = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    _, plain, _, params = _agents(world, bert, dropout=0.5)
    remat = ta.ViewpointAgent(TConfig(vocab_size=world["vocab"], **SMALL, **bert,
                                      remat=True), world["trt"], **AGENT, device="cpu")
    (_,), (tbatch,) = _batches(world, 1)
    out = []
    for agent in (plain, remat):
        state = _state(agent, params)
        out.append(agent.loss_and_grads(state["params"], agent.trim_batch(tbatch),
                                        state["rng"]))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(b, a, atol=1e-6, rtol=0)
    # The dropouts were on: without them the loss differs.
    state = _state(plain, params)
    l_det, _ = plain.loss_and_grads(state["params"], plain.trim_batch(tbatch), None)
    assert not torch.equal(l_det, l0)


def test_bf16_adam_moments_two_steps_match_jax(world):
    jagent, tagent, jstate, tparams = _agents(world, bf16_adam_moments=True)
    jbatches, tbatches = _batches(world, 2, seed=3)
    state = _state(tagent, tparams)
    step, jstep = tagent.train_step_fn(), jagent.train_step_fn()
    bigs = []
    for jbatch, tbatch in zip(jbatches, tbatches):
        jparams = jax.tree_util.tree_map(np.asarray, jstate["params"])
        bigs.append(_big(_jax_grads(jagent, tagent, jparams, jbatch)[1]))
        jstate, jl = jstep(jstate, _arrays(jbatch))
        state, tl = step(state, tbatch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    want = convert_agent_params(jax.tree_util.tree_map(np.asarray, jstate["params"]),
                                tagent)
    _check_update(state["params"], tparams, want, bigs, steps=2)
    adam = state["opt_state"][1]
    assert adam["count"] == 2
    for name in ("mu", "nu"):
        assert {t.dtype for t in tree_leaves(adam[name])} == {torch.bfloat16}
