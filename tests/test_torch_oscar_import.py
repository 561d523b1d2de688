"""The port's Oscar / HuggingFace weight import, its LMDB region store and
``run datagen`` against the JAX package, on the CPU in fp32.

Import: an HF ``BertModel`` (hidden 32, 2 layers, 4 heads) converted by
both packages gives the HF outputs (2e-5, as tests/test_oscar_import.py
holds the JAX package) and equal tensors; the rows a resize grows are
numpy draws equal bit for bit; a head permutation in the QKV fusion moves
the outputs by far more than the tolerance; ``load_oscar_weights`` keeps the
template's heads where the checkpoint has none and takes the checkpoint's
where it has them; ``run viewpoint --model_name_or_path <HF dir>`` starts
from the file's weights.  LMDB: ``to_lmdb`` / ``from_lmdb`` round-trip under
tests/fake_lmdb.py and read the JAX package's store (and it the port's).
datagen: ``run datagen --debug`` writes the JSON of the JAX package's
``write_pretrain_data``."""

import json
import os

import jax
import numpy as np
import pytest
import torch

import fake_lmdb
import visitron_torch.train.workspace as tws
from visitron_torch import run as trun
from visitron_torch.convert import _flax_to_named, flax_to_state_dict
from visitron_torch.data import RegionFeatureStore as TStore
from visitron_torch.models import BertConfig as TBert
from visitron_torch.models import PretrainModel as TPretrain
from visitron_torch.models import VisitronBert as TVisitronBert
from visitron_torch.models.layers import init_module_params
from visitron_torch.models.oscar_import import (convert_bert_state_dict,
                                                convert_pretrain_state_dict,
                                                graft_bert_into_encoder,
                                                is_pretrain_checkpoint,
                                                load_oscar_weights, resize_rows)
from visitron_torch.train.checkpoint import CheckpointManager
from visitron_tpu.config import RunConfig as JConfig
from visitron_tpu.data import RegionFeatureStore as JStore
from visitron_tpu.models import BertConfig as JBert
from visitron_tpu.models import PretrainModel as JPretrain
from visitron_tpu.models.oscar_import import convert_bert_to_flax
from visitron_tpu.models.oscar_import import load_oscar_weights as jload_oscar
from visitron_tpu.pipelines.pretrain_datagen import write_pretrain_data as jwrite
from visitron_tpu.testing import SyntheticWorld as JWorld

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
HF = dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
          intermediate_size=64, max_position_embeddings=48, type_vocab_size=2)
TINY = dict(HF, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import BertConfig as HFConfig, BertModel

    torch.manual_seed(0)
    return BertModel(HFConfig(**HF, hidden_act="gelu", hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)).eval()


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 120, (2, 16))
    segs = rng.integers(0, 2, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 10:] = 0
    return ids, segs, mask


def _port_bert(state: dict, cfg: TBert) -> TVisitronBert:
    model = TVisitronBert(cfg, image=False)
    model.load_state_dict(state)
    return model.eval()


def _run(model, ids, segs, mask):
    with torch.no_grad():
        return model(torch.from_numpy(ids), token_type_ids=torch.from_numpy(segs),
                     attention_mask=torch.from_numpy(mask))


# -- the import ----------------------------------------------------------------------------

def test_bert_import_gives_the_hf_outputs_and_the_jax_tensors(hf_model):
    """convert_bert_state_dict: the port's BERT reproduces HF's sequence and
    pooled outputs at the unmasked positions (2e-5), and every tensor equals
    the JAX converter's (kernels transposed)."""
    state = dict(hf_model.state_dict())
    cfg = TBert(**TINY)
    ours = convert_bert_state_dict(state, cfg)
    ids, segs, mask = _inputs()
    seq, pooled = _run(_port_bert(ours, cfg), ids, segs, mask)
    with torch.no_grad():
        hf = hf_model(input_ids=torch.from_numpy(ids), token_type_ids=torch.from_numpy(segs),
                      attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(seq[0].numpy(), hf.last_hidden_state[0].numpy(), atol=2e-5)
    np.testing.assert_allclose(seq[1, :10].numpy(), hf.last_hidden_state[1, :10].numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(pooled.numpy(), hf.pooler_output.numpy(), atol=2e-5)
    jtree = convert_bert_to_flax({k: v.numpy() for k, v in state.items()}, JBert(**TINY))
    want = flax_to_state_dict(jtree, TVisitronBert(cfg, image=False))
    assert set(ours) == set(want)
    for name, t in ours.items():
        assert torch.equal(t, want[name]), name


def test_grown_rows_equal_the_jax_package_bit_for_bit(hf_model):
    """Vocabulary 120 -> 123 (+3 special tokens), token types 2 -> 4,
    positions 48 -> 64: the appended rows are numpy normal(0, 0.02) draws
    in the JAX package's order, so every tensor is equal; the kept rows are
    the checkpoint's."""
    state = dict(hf_model.state_dict())
    grown = dict(TINY, vocab_size=123, type_vocab_size=4, max_position_embeddings=64)
    ours = convert_bert_state_dict(state, TBert(**grown), seed=3)
    jtree = convert_bert_to_flax({k: v.numpy() for k, v in state.items()}, JBert(**grown),
                                 seed=3)
    want = flax_to_state_dict(jtree, TVisitronBert(TBert(**grown), image=False))
    for name in ("word_embeddings.weight", "embeddings.position_embeddings.weight",
                 "embeddings.token_type_embeddings.weight"):
        assert torch.equal(ours[name], want[name]), name
    assert ours["word_embeddings.weight"].shape == (123, 32)
    assert torch.equal(ours["word_embeddings.weight"][:120],
                       state["embeddings.word_embeddings.weight"])
    rng = np.random.default_rng(0)
    a = torch.ones(4, 3)
    assert torch.equal(resize_rows(a, 2, rng), a[:2]) and resize_rows(a, 4, rng) is a


def test_a_head_permutation_in_the_qkv_fusion_is_caught(hf_model):
    """The fused projection's rows are [q; k; v], each in HF's head order.
    Swapping two heads of the query alone (a wrong fusion) moves the
    outputs by far more than the 2e-5 the import is held to."""
    state = dict(hf_model.state_dict())
    for name in ("query", "key"):  # sharper attention than the 0.02 init gives
        state[f"encoder.layer.0.attention.self.{name}.weight"] = (
            20.0 * state[f"encoder.layer.0.attention.self.{name}.weight"])
    cfg = TBert(**TINY)
    ours = convert_bert_state_dict(state, cfg)
    d = 32 // 4
    qkv = ours["encoder.layer_0.attention.qkv.weight"]
    for i, name in enumerate(("query", "key", "value")):
        assert torch.equal(qkv[i * 32:(i + 1) * 32],
                           state[f"encoder.layer.0.attention.self.{name}.weight"])
    bad = dict(ours)
    perm = torch.cat([qkv[d:2 * d], qkv[:d], qkv[2 * d:]])  # query heads 0 <-> 1
    bad["encoder.layer_0.attention.qkv.weight"] = perm
    ids, segs, mask = _inputs()
    good, _ = _run(_port_bert(ours, cfg), ids, segs, mask)
    wrong, _ = _run(_port_bert(bad, cfg), ids, segs, mask)
    assert float((good - wrong).abs().max()) > 100 * 2e-5


def _pretrain_state(hf_model, heads: bool) -> dict:
    """A PreTrainOscar-layout checkpoint: ``bert.``-prefixed BERT tensors,
    with or without the heads (seeded)."""
    state = {f"bert.{k}": v for k, v in hf_model.state_dict().items()}
    if heads:
        g = torch.Generator().manual_seed(5)
        for name, shape in (("mlmhead.predictions.transform.dense.weight", (32, 32)),
                            ("mlmhead.predictions.transform.dense.bias", (32,)),
                            ("mlmhead.predictions.transform.LayerNorm.weight", (32,)),
                            ("mlmhead.predictions.transform.LayerNorm.bias", (32,)),
                            ("mlmhead.predictions.bias", (120,)),
                            ("next_action.linear.weight", (36, 32)),
                            ("next_action.linear.bias", (36,)),
                            ("token_head.0.weight", (1601, 32)),
                            ("token_head.0.bias", (1601,))):
            state[name] = torch.randn(shape, generator=g)
    return state


@pytest.mark.parametrize("heads", [False, True], ids=["bert_only", "with_heads"])
def test_load_oscar_weights_backfills_like_jax(tmp_path, hf_model, heads):
    """A DDP-saved (``module.``) pytorch_model.bin into a PretrainModel
    with grown tables: every tensor the checkpoint gives equals the JAX
    package's import; the rest keeps the template's values."""
    grown = dict(TINY, vocab_size=123, type_vocab_size=4, max_position_embeddings=64)
    state = {f"module.{k}": v for k, v in _pretrain_state(hf_model, heads).items()}
    torch.save(state, tmp_path / "pytorch_model.bin")
    model = TPretrain(TBert(**grown))
    template = init_module_params(model, torch.Generator().manual_seed(0))
    got = load_oscar_weights(str(tmp_path), TBert(**grown), template)
    jmodel = JPretrain(JBert(**grown))
    jtemplate = jax.jit(lambda r: jmodel.init(r, np.ones((1, 8), np.int32)))(
        jax.random.PRNGKey(0))
    jgot = jload_oscar(str(tmp_path), JBert(**grown), jtemplate)
    conv = convert_pretrain_state_dict({k[len("module."):]: v for k, v in state.items()},
                                       TBert(**grown))
    # The flax template has no image projections (never called with regions).
    want = _flax_to_named(jax.tree_util.tree_map(np.asarray, jgot), {
        n: t for n, t in template.items()
        if not n.startswith(("bert.img_embedding.", "bert.location_embeds."))}, "template")
    assert set(got) == set(template)
    for name, t in got.items():
        if name in conv:
            assert torch.equal(t, want[name]), name
        else:
            assert torch.equal(t, template[name]), name
    assert ("next_action.weight" in conv) == heads
    assert ("mlm_bias" in conv) == heads
    if heads:
        assert torch.equal(got["mlm_bias"][120:], torch.zeros(3))  # grown with zeros
    with torch.no_grad():
        model.load_state_dict(got)
        out = model(torch.ones((1, 8), dtype=torch.long))
    assert torch.isfinite(out["mlm_logits"]).all()


def test_finetune_from_an_hf_directory_starts_from_its_weights(tmp_path, hf_model, caplog):
    """run viewpoint --model_name_or_path <dir with pytorch_model.bin>: the
    encoder's BERT is the file's (tables grown to the workspace's sizes)
    before the first step and one Adam step of lr 5e-5 away after it; the
    LSTM keeps its init."""
    torch.save({f"bert.{k}": v for k, v in hf_model.state_dict().items()},
               tmp_path / "pytorch_model.bin")
    assert not is_pretrain_checkpoint(str(tmp_path))
    seen = {}

    def tiny(cfg, tokenizer):
        bert = TBert(vocab_size=len(tokenizer), max_position_embeddings=64, type_vocab_size=4,
                     **{k: v for k, v in TINY.items()
                        if k not in ("vocab_size", "max_position_embeddings",
                                     "type_vocab_size")})
        seen["cfg"] = bert
        return bert

    mp = pytest.MonkeyPatch()
    mp.setattr(tws.Workspace, "_bert_config", staticmethod(tiny))
    try:
        out = str(tmp_path / "vp")
        caplog.set_level("INFO", logger="visitron_torch")
        trun.main(["viewpoint", "--config",
                   os.path.join(REPO, "run_configs/viewpoint_train/ndh_oscar_setting.json"),
                   "--debug", "--no_use_bfloat16", "--max_seq_length", "64",
                   "--lstm_img_feature_dim", "32", "--rnn_dim", "24",
                   "--encoder_hidden_size", "16", "--num_iterations", "1",
                   "--logging_steps", "1", "--eval_iters", "1", "--per_gpu_eval_batch_size",
                   "4", "--model_name_or_path", str(tmp_path), "--output_dir", out],
                  device="cpu")
    finally:
        mp.undo()
    assert "loaded Oscar/BERT weights" in caplog.text
    want = convert_bert_state_dict(dict(hf_model.state_dict()), seen["cfg"])
    enc = CheckpointManager(out).restore_raw(1)["encoder"]
    assert enc["bert.bert.word_embeddings.weight"].shape[0] == seen["cfg"].vocab_size
    for name, t in want.items():
        delta = float((enc["bert.bert." + name] - t).abs().max())
        assert delta <= 2 * 5e-5 + 1e-7, name
    params = {"encoder": {"bert.bert.pooler.dense.bias": torch.zeros(32),
                          "lstm.fwd.wi": torch.ones(4)}}
    grafted = graft_bert_into_encoder(params["encoder"], str(tmp_path), seen["cfg"])
    assert torch.equal(grafted["bert.bert.pooler.dense.bias"],
                       hf_model.state_dict()["pooler.dense.bias"])
    assert torch.equal(grafted["lstm.fwd.wi"], torch.ones(4))


# -- the LMDB region store ----------------------------------------------------------------------

@pytest.fixture()
def lmdb_shim(monkeypatch):
    """tests/fake_lmdb.py as the ``lmdb`` module, removed afterwards."""
    import sys

    monkeypatch.setitem(sys.modules, "lmdb", fake_lmdb)
    yield


def test_lmdb_round_trip_and_the_jax_packages_store(tmp_path, lmdb_shim):
    feats, tokens = JWorld(seed=2, num_scans=1, viewpoints_per_scan=4,
                           region_feat_dim=12).region_features()
    store = TStore(feats, tokens, image_w=320, image_h=240, vfov=45)

    def same(a, b):
        assert a.keys == b.keys and a.region_tokens == b.region_tokens
        assert (a.image_w, a.image_h, a.vfov) == (b.image_w, b.image_h, b.vfov)
        for k in a.keys:
            np.testing.assert_array_equal(a.features[k], b.features[k])

    store.to_lmdb(str(tmp_path / "t"), map_size=1 << 24)
    same(TStore.from_lmdb(str(tmp_path / "t")), store)
    same(JStore.from_lmdb(str(tmp_path / "t")), store)
    JStore(feats, tokens, image_w=320, image_h=240, vfov=45).to_lmdb(
        str(tmp_path / "j"), map_size=1 << 24)
    same(TStore.from_lmdb(str(tmp_path / "j")), store)


# -- run datagen ----------------------------------------------------------------------------------

def test_run_datagen_writes_what_the_jax_package_writes(tmp_path):
    """run datagen --debug --add_r2r_data: the NDH and R2R pretraining JSON
    files of the port equal those of the JAX package's write_pretrain_data
    over the same synthetic world's task data."""
    import visitron_tpu.train.workspace as jws

    out = str(tmp_path / "port")
    trun.main(["datagen", "--debug", "--add_r2r_data", "--lstm_img_feature_dim", "8",
               "--output_dir", out], device="cpu")
    cfg = JConfig(debug=True, add_r2r_data=True, lstm_img_feature_dim=8, mesh_dp=1)
    ws = jws.Workspace.synthetic_workspace(cfg)
    root = ws.synthetic.write_task_data(str(tmp_path / "jax"))
    tables = {s: ws.runtime.tables[s] for s in ws.graphs}
    got_dir = os.path.join(out, "synthetic_task_data", "pretrain_data")
    names = set()
    for ds in ("NDH", "R2R"):
        want_dir = jwrite(root, ["train", "val_seen", "val_unseen"], ds, ws.graphs, tables)
        for split in ("train", "val_seen", "val_unseen"):
            name = f"{ds}_{split}.json"
            got = json.load(open(os.path.join(got_dir, name)))
            assert got == json.load(open(os.path.join(want_dir, name))), name
            assert got, name
            names.add(name)
    assert set(os.listdir(got_dir)) == names
