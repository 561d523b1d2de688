"""The port's pretraining slice against the JAX package's, on the CPU: the
pretraining example walk, ``PretrainDataset``'s batches (byte for byte, with
masked-token prediction on), ``PretrainModel`` and ``pretrain_loss`` (fp32,
deterministic, the JAX parameters carried across by
``convert_pretrain_params``: logits 1e-4, every loss and accuracy 1e-5
relative, every gradient 1e-4), two ``PretrainTrainer`` steps against the
JAX trainer on a one-device mesh, and a short training run whose loss falls.

Tiny config: 2 layers, hidden 128 (2 heads of 64), image features of 24
dims.  Joint lengths: 128 text + 128 image tokens with
``fused_packed_max_seq`` 128, where the port takes the fused gate and runs
its (B, H, S, D) attention (K4's twin here); 64 + 40, which the gate
refuses, so the plain attention runs; and, with ``use_flash_attention``,
512 + 384 = S 896 (the shortest length the fused gate refuses) and 128 +
128 with the fused kernels off, where the port runs the flash attention
(K5's twin).  The JAX package runs its plain attention on the CPU in all.
The long-context slice adds ``PretrainDataset`` batches at S 1024 (512 text
+ 14 x 36 = 504 regions, bucketed to 512) and per-layer rematerialisation
(``remat``): on and off agree to 1e-6 with the training dropouts, and
against the JAX package's ``remat=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from visitron_torch import data as td
from visitron_torch import geometry as tgeo
from visitron_torch.convert import convert_pretrain_params
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models import bert as tbert
from visitron_torch.models.layers import DropoutRng
from visitron_torch.ops import attention as tatt
from visitron_torch.pipelines import generate_pretrain_examples as t_generate
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_tpu import data as jd
from visitron_tpu import models as jm
from visitron_tpu.data.features import RegionFeatureStore as JStore
from visitron_tpu.data.pretrain_dataset import PretrainDataset as JDataset
from visitron_tpu.parallel import make_mesh
from visitron_tpu.pipelines.pretrain_datagen import generate_pretrain_examples as j_generate
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS
from visitron_tpu.train.pretrain import PretrainTrainer as JTrainer

IMG_DIM = 24
SMALL = dict(vocab_size=101, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, type_vocab_size=4, img_feature_dim=IMG_DIM,
             detector_classes=11, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0)
LR = 5e-5


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny models gain nothing from intra-op threads, and with several
    test workers per machine the threads only contend; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed, b, s_text, s_img, vocab, classes):
    """A host batch like tools/bench_pretrain.py's, with padding, labels on
    text only and some region-token labels."""
    rng = np.random.default_rng(seed)
    s = s_text + s_img
    mask = np.ones((b, s), np.int32)
    mask[1, s_text - 20:s_text] = 0
    mask[1, s - 10:] = 0
    labels = np.where(rng.random((b, s)) < 0.3, rng.integers(0, vocab, (b, s)), -1)
    labels[:, s_text:] = -1
    tokens = np.where(rng.random((b, s)) < 0.2, rng.integers(0, classes, (b, s)), -1)
    tokens[:, s_text:] = -1
    return {
        "input_ids": rng.integers(0, vocab, (b, s_text)).astype(np.int32),
        "token_type_ids": rng.integers(0, 4, (b, s_text)).astype(np.int32),
        "attention_mask": mask,
        "labels": labels.astype(np.int32),
        "token_labels": tokens.astype(np.int32),
        "img_feats": rng.standard_normal((b, s_img, IMG_DIM)).astype(np.float32),
        "img_location_embeddings": rng.standard_normal((b, s_img, 128)).astype(np.float32),
        "next_action": np.array([rng.integers(0, 36), -1][:b] + [3] * (b - 2), np.int32),
    }


def _jax_forward(jmodel, jparams, batch):
    return jmodel.apply(jparams, jnp.asarray(batch["input_ids"]),
                        token_type_ids=jnp.asarray(batch["token_type_ids"]),
                        attention_mask=jnp.asarray(batch["attention_mask"]),
                        img_feats=jnp.asarray(batch["img_feats"]),
                        img_location_embeddings=jnp.asarray(batch["img_location_embeddings"]))


def _jax_bundle(jmodel, jcfg, jparams, batch):
    out = _jax_forward(jmodel, jparams, batch)
    return jm.pretrain_loss(out, jnp.asarray(batch["labels"]),
                            jnp.asarray(batch["next_action"]),
                            jnp.asarray(batch["token_labels"]), cfg=jcfg)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


CASES = {"fused": dict(s_text=128, s_img=128, cfg={"fused_packed_max_seq": 128},
                       route="fused_attention"),
         "plain": dict(s_text=64, s_img=40, cfg={}, route="multi_head_attention"),
         "flash": dict(s_text=512, s_img=384, cfg={"use_flash_attention": True},
                       route="flash_attention"),
         "flash_unfused": dict(s_text=128, s_img=128,
                               cfg={"use_fused_attention": False,
                                    "use_flash_attention": True},
                               route="flash_attention")}
ROUTES = ("fused_attention_packed", "fused_attention", "flash_attention",
          "multi_head_attention")


def _spy_routes(monkeypatch) -> list:
    """The names of the attention cores BertSelfAttention calls, in order."""
    calls = []
    for name in ROUTES:
        fn = getattr(tbert, name)
        monkeypatch.setattr(tbert, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_pretrain_model_and_loss_match_jax(case, monkeypatch):
    c = CASES[case]
    s = c["s_text"] + c["s_img"]
    kw = {**SMALL, "max_position_embeddings": c["s_text"], **c["cfg"]}
    jcfg, tcfg = jm.BertConfig(**kw), TConfig(**kw)
    batch = _batch(1, 2, c["s_text"], c["s_img"], kw["vocab_size"], kw["detector_classes"])
    jmodel = jm.PretrainModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"][:1]),
                          token_type_ids=jnp.asarray(batch["token_type_ids"][:1]),
                          attention_mask=jnp.asarray(batch["attention_mask"][:1]),
                          img_feats=jnp.asarray(batch["img_feats"][:1]),
                          img_location_embeddings=jnp.asarray(
                              batch["img_location_embeddings"][:1]))
    trainer = TTrainer(tcfg, device="cpu")
    params = convert_pretrain_params(_np_tree(jparams), trainer.model)
    assert tatt.attention_supports_fused(s, s, 64) == (case in ("fused", "flash_unfused"))

    jout = _jax_forward(jmodel, jparams, batch)
    tb = trainer.to_device(batch)
    calls = _spy_routes(monkeypatch)
    with torch.no_grad():
        tout = functional_call(trainer.model, params, (tb["input_ids"],),
                               {k: tb[k] for k in ("token_type_ids", "attention_mask",
                                                   "img_feats", "img_location_embeddings")})
    assert calls == [c["route"]] * kw["num_hidden_layers"]
    for key in ("mlm_logits", "action_logits", "token_logits", "sequence_output"):
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), atol=1e-4,
                                   rtol=0, err_msg=key)

    def jloss(p):
        bundle = _jax_bundle(jmodel, jcfg, p, batch)
        return bundle["loss"], bundle

    (_, jbundle), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    tbundle, tgrads = trainer.loss_and_grads(params, tb, None)
    assert set(tbundle) == set(jbundle)
    for key, v in jbundle.items():
        np.testing.assert_allclose(float(tbundle[key]), float(v), rtol=1e-5, err_msg=key)
    jgrads = convert_pretrain_params(_np_tree(jgrads), trainer.model)
    assert set(tgrads) == set(jgrads)
    for name, g in tgrads.items():
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)


def test_two_trainer_steps_match_the_jax_trainer():
    """AdamW 5e-5 with warmup 0: optax reads the schedule before the step,
    so step 1 moves nothing in either package and step 2 moves by ~lr.  The
    bundles of both steps agree to 1e-5 relative; the update after two steps
    agrees to 1e-2 lr where both gradients exceed 1e-4 (and moves there),
    and to 3 lr everywhere (Adam's second step moves a parameter by at most
    ~1.1 lr)."""
    _check_two_steps({**SMALL, "max_position_embeddings": 128,
                      "fused_packed_max_seq": 128})


def test_two_trainer_steps_with_flash_match_the_jax_trainer(monkeypatch):
    """The same with ``use_flash_attention`` set and the fused kernels off:
    every self-attention of the port's steps runs the flash attention."""
    calls = _spy_routes(monkeypatch)
    _check_two_steps({**SMALL, "max_position_embeddings": 128,
                      "use_fused_attention": False, "use_flash_attention": True})
    assert set(calls) == {"flash_attention"}


def _check_two_steps(kw):
    jcfg, tcfg = jm.BertConfig(**kw), TConfig(**kw)
    batches = [_batch(seed, 2, 128, 128, kw["vocab_size"], kw["detector_classes"])
               for seed in (2, 3)]
    jtrainer = JTrainer(jcfg, mesh=make_mesh(dp=1), total_steps=100, learning_rate=LR)
    jstate = jtrainer.init_state(batches[0])
    p0 = _np_tree(jstate["params"])
    jstep = jtrainer.step_fn()
    jbundles = []
    for b in batches:
        jstate, bundle = jstep(jstate, b)
        jbundles.append(_np_tree(bundle))
    trainer = TTrainer(tcfg, device="cpu", total_steps=100, learning_rate=LR)
    state = trainer.init_state()
    state["params"] = convert_pretrain_params(p0, trainer.model)
    state["opt_state"] = trainer.optimizer.init(state["params"])
    start = {k: v.clone() for k, v in state["params"].items()}
    grads = [trainer.loss_and_grads(start, trainer.to_device(b), None)[1] for b in batches]
    step = trainer.step_fn()
    for i, b in enumerate(batches):
        state, bundle = step(state, b)
        for key, v in jbundles[i].items():
            np.testing.assert_allclose(float(bundle[key]), float(v), rtol=1e-5,
                                       err_msg=f"step {i + 1} {key}")
        if i == 0:
            assert all(torch.equal(state["params"][k], start[k]) for k in start)
    jnew = convert_pretrain_params(_np_tree(jstate["params"]), trainer.model)
    n_big = n_moved = 0
    for name, p in state["params"].items():
        upd = (p - start[name]).numpy()
        jupd = (jnew[name] - start[name]).numpy()
        big = np.minimum(grads[0][name].abs().numpy(), grads[1][name].abs().numpy()) > 1e-4
        diff = np.abs(upd - jupd)
        assert diff.max() <= 3 * LR, name
        assert (diff[big] <= 1e-2 * LR).all(), name
        n_big += int(big.sum())
        n_moved += int((upd[big] != 0).sum())
    # A move far below a parameter's ulp rounds away; nearly all others show.
    assert n_moved > 0.95 * n_big > 0


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The same synthetic world from each package, its task data, region
    store and candidate tables, and a shared WordPiece vocabulary."""
    kw = dict(seed=5, num_scans=2, viewpoints_per_scan=16, scene_feat_dim=8,
              region_feat_dim=IMG_DIM, regions_per_view=2)
    out = {}
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=256)
    hfov = tgeo.camera_hfov(640, 480, np.radians(60))
    for name, world_cls, pkg in (("jax", JWorld, jd), ("torch", TWorld, td)):
        world = world_cls(**kw)
        root = world.write_task_data(str(tmp_path_factory.mktemp(name)),
                                     counts={"train": 6})
        feats, tokens = world.region_features()
        store = (JStore if name == "jax" else td.RegionFeatureStore)(feats, tokens)
        tables = pkg.build_candidate_tables(world.graphs, hfov)
        out[name] = {"world": world, "root": root, "store": store, "tables": tables,
                     "tok": pkg.WordPieceTokenizer(vocab)}
    return out


def _records(worlds, name):
    w = worlds[name]
    generate = j_generate if name == "jax" else t_generate
    return generate(w["root"], ["train"], "NDH", w["world"].graphs, w["tables"])


def _dataset(worlds, name, records, **kw):
    w = worlds[name]
    cls = JDataset if name == "jax" else td.PretrainDataset
    return cls(records, w["tok"], region_store=w["store"],
               detector_classes=["__background__"] + _TARGETS,
               masked_token_prediction=True, max_seq_length=128, regions_per_view=2,
               region_feat_dim=IMG_DIM, seed=3, **kw)


def test_pretrain_examples_and_batches_match_jax(worlds, tmp_path):
    jrec, trec = _records(worlds, "jax"), _records(worlds, "torch")
    assert jrec == trec and len(trec) > 8
    jds, tds = _dataset(worlds, "jax", jrec), _dataset(worlds, "torch", trec)
    assert len(tds) == len(jds)
    n = 0
    for _ in range(2):  # two epochs: the shuffle and the masking streams
        for jb, tb in zip(jds.epoch_batches(4), tds.epoch_batches(4)):
            assert jb.keys() == tb.keys()
            for key in jb:
                assert tb[key].dtype == jb[key].dtype, key
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
            n += 1
    assert n >= 4
    # 2 regions x 36 views = 72, bucketed to 128 image tokens; labels cover
    # the joint sequence, token labels only the region tokens' positions.
    assert tb["img_feats"].shape == (4, 128, IMG_DIM)
    assert tb["labels"].shape == (4, 128 + 128)
    assert (tb["token_labels"] >= 0).any()
    # Multi-host epochs: each host's strided share of the same shuffle.
    for host in range(2):
        jb = next(jds.epoch_batches(2, host_id=host, num_hosts=2))
        tb = next(tds.epoch_batches(2, host_id=host, num_hosts=2))
        for key in jb:
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    # The preprocessed-example cache: written on the first build, read on the
    # second (the same batches as the JAX dataset's), ignored when the
    # fingerprint differs.
    cache = str(tmp_path / "cache.pkl")
    for _ in range(2):
        cached = _dataset(worlds, "torch", trec, cache_path=cache)
        jds = _dataset(worlds, "jax", jrec)
        for jb, tb in zip(jds.epoch_batches(4), cached.epoch_batches(4)):
            for key in jb:
                np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    assert cached.examples[0].token_ids.dtype == tds.examples[0].token_ids.dtype
    short = _dataset(worlds, "torch", trec[:2], cache_path=cache)
    assert len(short) == 2


def test_train_epoch_lowers_the_loss_on_a_repeated_batch(worlds):
    records = _records(worlds, "torch")
    ds = _dataset(worlds, "torch", records)
    tok = worlds["torch"]["tok"]
    cfg = TConfig(**{**SMALL, "vocab_size": len(tok), "max_position_embeddings": 128,
                     "detector_classes": 1 + len(_TARGETS),
                     "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1})
    trainer = TTrainer(cfg, device="cpu", learning_rate=1e-3, total_steps=1000)
    state = trainer.init_state()
    fixed = ds.batch(np.arange(4))
    ev = trainer.eval_fn()
    first = float(ev(state["params"], fixed)["loss"])
    history = []
    for _ in range(3):
        state, hist = trainer.train_epoch(state, ds, batch_size=4, log_every=1)
        history += hist
    assert len(history) >= 6 and all(np.isfinite(h["loss"]) for h in history)
    assert {"mask_loss", "next_loss", "token_loss", "words_accuracy"} <= set(history[0])
    assert float(ev(state["params"], fixed)["loss"]) < 0.8 * first
    report = trainer.evaluate(state["params"], ds, batch_size=4)
    assert np.isfinite(report["loss"])


def test_trainer_refuses_unported_options():
    """A mesh that is not a ``parallel.Mesh`` (e.g. the JAX package's) is
    refused; on rank 0 of a (dp 1, tp 2) mesh the trainer's model holds its
    halves of the four split kernels and its state starts from its blocks
    of the single-device parameters; pipeline parallelism without a
    process group names the ranks it needs; ZeRO-1 and FSDP without a mesh shard nothing (the
    JAX trainer's one-device mesh shards nothing either)."""
    from visitron_torch.config import RunConfig
    from visitron_torch.parallel import Mesh
    from visitron_torch.train.pretrain import pretrain_mesh

    cfg = TConfig(**{**SMALL, "max_position_embeddings": 64})

    class TPMesh:
        shape, size, device = {"dp": 1, "tp": 2}, 2, torch.device("cpu")

    with pytest.raises(TypeError, match="needs a parallel.Mesh"):
        TTrainer(cfg, device="cpu", mesh=TPMesh())
    tp = TTrainer(cfg, device="cpu",
                  mesh=Mesh(dp=1, rank=0, device=torch.device("cpu"), axis="tp", size=2))
    full = tp.init_params()
    state = tp.init_state(params=full)
    name = "bert.encoder.layer_0.attention.qkv.weight"
    h = cfg.hidden_size
    assert state["params"][name].shape == (3 * h // 2, h)
    assert torch.equal(state["params"][name], full[name].unflatten(0, (3, h))[:, :h // 2]
                       .flatten(0, 1))
    with pytest.raises(ValueError, match="--mesh_pp 2 needs 2 ranks"):
        pretrain_mesh(RunConfig(mesh_pp=2))
    for kw in ({"zero1": True}, {"fsdp": True}):
        assert TTrainer(cfg, device="cpu", **kw).dp is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TTrainer(cfg)


# -- the long-context slice: S 1024 batches and rematerialisation ------------------

def test_long_context_batches_match_jax_at_s1024(tmp_path_factory):
    """``PretrainDataset(regions_per_view=14, max_img_seq_length=512)`` over a
    world with 14 regions per view: 36 x 14 = 504 regions, bucketed by 64 to
    512, after 512 text tokens: S 1024 with the last 8 region slots masked.
    The two packages' batches are equal byte for byte."""
    kw = dict(seed=6, num_scans=1, viewpoints_per_scan=10, scene_feat_dim=8,
              region_feat_dim=IMG_DIM, regions_per_view=14)
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=256)
    hfov = tgeo.camera_hfov(640, 480, np.radians(60))
    batches = {}
    for name, world_cls, pkg, store_cls, generate, ds_cls in (
            ("jax", JWorld, jd, JStore, j_generate, JDataset),
            ("torch", TWorld, td, td.RegionFeatureStore, t_generate, td.PretrainDataset)):
        world = world_cls(**kw)
        root = world.write_task_data(str(tmp_path_factory.mktemp(name)), counts={"train": 3})
        records = generate(root, ["train"], "NDH", world.graphs,
                           pkg.build_candidate_tables(world.graphs, hfov))
        ds = ds_cls(records, pkg.WordPieceTokenizer(vocab),
                    region_store=store_cls(*world.region_features()),
                    detector_classes=["__background__"] + _TARGETS,
                    masked_token_prediction=True, max_seq_length=512,
                    max_img_seq_length=512, regions_per_view=14,
                    region_feat_dim=IMG_DIM, seed=4)
        batches[name] = list(ds.epoch_batches(2))
    assert len(batches["torch"]) == len(batches["jax"]) >= 2
    for jb, tb in zip(batches["jax"], batches["torch"]):
        assert jb.keys() == tb.keys()
        for key in jb:
            assert tb[key].dtype == jb[key].dtype, key
            np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)
    assert tb["labels"].shape == (2, 1024) and tb["img_feats"].shape == (2, 512, IMG_DIM)
    assert (tb["attention_mask"][:, 512:1016] == 1).all()
    assert (tb["attention_mask"][:, 1016:] == 0).all()
    assert tatt.attention_supports_flash(1024, 1024, 64)
    assert not tatt.attention_supports_fused(1024, 1024, 64)


def _remat_run(cfg_kw, batch, remat: bool, seed: int = 21):
    """(bundle, grads) of the port's trainer at ``remat`` from one parameter
    seed and one ``DropoutRng`` seed."""
    trainer = TTrainer(TConfig(**{**cfg_kw, "remat": remat}), device="cpu")
    params = trainer.init_params(seed)
    rng = DropoutRng(masks=torch.Generator().manual_seed(seed + 1),
                     seeds=torch.Generator().manual_seed(seed + 1))
    return trainer.loss_and_grads(params, trainer.to_device(batch), rng)


@pytest.mark.parametrize("flash", [False, True])
def test_remat_on_and_off_agree_with_the_dropouts(flash, monkeypatch):
    """Dropouts at 0.1 and one DropoutRng seed: the recompute replays the
    layer's kernel seeds and hidden-dropout masks, so the loss and every
    gradient agree (1e-6).  With flash at S 256 (fused off) the attention is
    K5's twin; without, S 104 takes the plain attention, whose mask comes
    from the mask generator too."""
    s_text, s_img = (128, 128) if flash else (64, 40)
    kw = {**SMALL, "max_position_embeddings": s_text, "hidden_dropout_prob": 0.1,
          "attention_probs_dropout_prob": 0.1, "use_fused_attention": not flash,
          "use_flash_attention": flash}
    batch = _batch(7, 2, s_text, s_img, kw["vocab_size"], kw["detector_classes"])
    calls = _spy_routes(monkeypatch)
    plain_bundle, plain_grads = _remat_run(kw, batch, remat=False)
    n = len(calls)
    remat_bundle, remat_grads = _remat_run(kw, batch, remat=True)
    # The remat run's forward calls each layer's attention once, and its
    # backward once more (the recompute).
    assert calls[:n] == calls[n:n + n] and len(calls) == 3 * n
    assert set(calls) == {"flash_attention" if flash else "multi_head_attention"}
    for key, v in plain_bundle.items():
        np.testing.assert_allclose(float(remat_bundle[key]), float(v), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    assert set(remat_grads) == set(plain_grads)
    for name, g in plain_grads.items():
        np.testing.assert_allclose(remat_grads[name].numpy(), g.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    # Another DropoutRng seed draws other masks: the loss moves.
    other, _ = _remat_run(kw, batch, remat=True, seed=22)
    assert float(other["loss"]) != float(remat_bundle["loss"])


def test_remat_matches_jax_remat():
    """``remat=True`` in both packages at dropouts 0, through flash at S 256
    (fused off): loss bundle 1e-5 relative, every gradient 1e-4."""
    kw = {**SMALL, "max_position_embeddings": 128, "use_fused_attention": False,
          "use_flash_attention": True, "remat": True}
    jcfg, tcfg = jm.BertConfig(**kw), TConfig(**kw)
    batch = _batch(8, 2, 128, 128, kw["vocab_size"], kw["detector_classes"])
    jmodel = jm.PretrainModel(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3), *(jnp.asarray(batch[k][:1]) for k in (
        "input_ids",)), token_type_ids=jnp.asarray(batch["token_type_ids"][:1]),
        attention_mask=jnp.asarray(batch["attention_mask"][:1]),
        img_feats=jnp.asarray(batch["img_feats"][:1]),
        img_location_embeddings=jnp.asarray(batch["img_location_embeddings"][:1]))

    def jloss(p):
        bundle = _jax_bundle(jmodel, jcfg, p, batch)
        return bundle["loss"], bundle

    (_, jbundle), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    trainer = TTrainer(tcfg, device="cpu")
    params = convert_pretrain_params(_np_tree(jparams), trainer.model)
    tbundle, tgrads = trainer.loss_and_grads(params, trainer.to_device(batch), None)
    for key, v in jbundle.items():
        np.testing.assert_allclose(float(tbundle[key]), float(v), rtol=1e-5, err_msg=key)
    jgrads = convert_pretrain_params(_np_tree(jgrads), trainer.model)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name].numpy(), atol=1e-4, rtol=0,
                                   err_msg=name)
