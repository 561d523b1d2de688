"""The port's data parallelism (visitron_torch/parallel) in one process, on the
CPU: the shard rules of ZeRO-1 and FSDP against the JAX package's
``zero1_opt_rules`` / ``fsdp_param_rules`` for every BERT leaf (dp 2 and 4),
the multi-host batch streams of ``NavEpisodeBatcher(host_id, num_hosts)``
against the JAX batcher's (key by key, with the global length trim and a
resume), the attention kernels' keep masks with each rank's folded seed
against ``fused_attention_mesh_packed`` on a (dp 2, tp 1) mesh in interpret
mode (bit for bit, outputs to 1e-6), the flat-bucket collectives and the world of one: in a gloo group of
one process every strategy (dp, ZeRO-1, FSDP) gives the single-device step's
result bit for bit, dropouts on.  Multi-rank runs are in
tests/test_torch_multiprocess.py.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch import parallel
from visitron_torch import run as trun
from visitron_torch.config import RunConfig as TRunConfig
from visitron_torch.config import refuse_pretrain_axes
from visitron_torch.convert import _RENAMES, _segment
from visitron_torch.models import BertConfig as TConfig
from visitron_torch.models.layers import DropoutRng
from visitron_torch.ops import attention as tatt
from visitron_torch.parallel.mesh import Mesh
from visitron_torch.testing import SyntheticWorld as TWorld
from visitron_torch.train import PretrainTrainer as TTrainer
from visitron_tpu import agents as ja
from visitron_tpu import data as jd
from visitron_tpu import models as jm
from visitron_tpu.agents.batcher import NavEpisodeBatcher as JBatcher
from visitron_tpu.ops import attention as jatt
from visitron_tpu.parallel import fsdp_param_rules as j_fsdp_rules
from visitron_tpu.parallel import make_mesh as j_make_mesh
from visitron_tpu.parallel import zero1_opt_rules as j_zero1_rules
from visitron_tpu.testing import SyntheticWorld as JWorld
from visitron_tpu.testing.synthetic import _TARGETS, _WORDS

SMALL = dict(vocab_size=101, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=256, type_vocab_size=4, img_feature_dim=24,
             detector_classes=11, max_position_embeddings=128, fused_packed_max_seq=128)
WORLD = dict(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pretrain_batch(seed, b=4, s_text=128, s_img=128):
    rng = np.random.default_rng(seed)
    s = s_text + s_img
    mask = np.ones((b, s), np.int32)
    mask[-1, s - 10:] = 0
    labels = np.where(rng.random((b, s)) < 0.3, rng.integers(0, 101, (b, s)), -1)
    labels[:, s_text:] = -1
    tokens = np.where(rng.random((b, s)) < 0.2, rng.integers(0, 11, (b, s)), -1)
    return {
        "input_ids": rng.integers(0, 101, (b, s_text)).astype(np.int32),
        "token_type_ids": rng.integers(0, 4, (b, s_text)).astype(np.int32),
        "attention_mask": mask, "labels": labels.astype(np.int32),
        "token_labels": tokens.astype(np.int32),
        "img_feats": rng.standard_normal((b, s_img, 24)).astype(np.float32),
        "img_location_embeddings": rng.standard_normal((b, s_img, 128)).astype(np.float32),
        "next_action": np.array([5, -1, 3, 3][:b], np.int32)}


# -- shard rules ------------------------------------------------------------------------------

def _jax_axes_by_port_name(tree, spec_tree) -> dict:
    """{port parameter name: the JAX rule's axis in the port's layout} (a
    flax kernel is stored transposed in the port)."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    specs = jax.tree_util.tree_leaves(spec_tree, is_leaf=lambda x: hasattr(x, "spec"))
    for (path, leaf), sharding in zip(flat, specs):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[0] == "params":
            keys = keys[1:]
        name = ".".join([_segment(k) for k in keys[:-1]] + [_RENAMES[keys[-1]]])
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
        axis = next((i for i, a in enumerate(spec) if a == "dp"), None)
        if axis is not None and keys[-1] == "kernel":
            axis = leaf.ndim - 1 - axis
        out[name] = axis
    return out


@pytest.mark.parametrize("dp", [2, 4])
def test_shard_rules_match_jax_for_every_bert_leaf(dp):
    jcfg = jm.BertConfig(**SMALL)
    batch = _pretrain_batch(0, b=1)
    jparams = jm.PretrainModel(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(batch["input_ids"]),
        token_type_ids=jnp.asarray(batch["token_type_ids"]),
        attention_mask=jnp.asarray(batch["attention_mask"]),
        img_feats=jnp.asarray(batch["img_feats"]),
        img_location_embeddings=jnp.asarray(batch["img_location_embeddings"]))
    jmesh = j_make_mesh(dp=dp)
    want_p = _jax_axes_by_port_name(jparams, j_fsdp_rules(jmesh, jparams))
    want_o = _jax_axes_by_port_name(jparams, j_zero1_rules(jmesh, jparams))
    trainer = TTrainer(TConfig(**SMALL), device="cpu")
    params = trainer.init_params()
    mesh = Mesh(dp=dp, rank=0, device=CPU)
    got = parallel.fsdp_param_rules(mesh, params, parallel.jax_axis_orders(trainer.model))
    assert set(got) == set(want_p) and len(got) > 30
    assert got == want_p
    opt_axes = parallel.zero1_opt_rules(got, trainer.optimizer.init(params))
    adam = next(s for s in opt_axes if isinstance(s, dict) and "mu" in s)
    assert adam["mu"] == want_o and adam["nu"] == want_o and adam["count"] is None
    # Some leaves shard on their second JAX axis, some stay replicated.
    assert any(a is None for a in got.values()) or dp == 2
    assert got["bert.encoder.layer_0.attention.qkv.weight"] == 1  # JAX (in, out) axis 0


def test_fold_seed_and_mesh_checks():
    assert Mesh(dp=2, rank=0, device=CPU).fold_seed(7) == 7
    assert Mesh(dp=2, rank=1, device=CPU).fold_seed(7) == 7 + 1000003
    assert parallel.maybe_mesh(0) is None and parallel.maybe_mesh(1) is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        parallel.maybe_mesh(2)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        parallel.maybe_mesh(0, tp=2)
    # Rank r of a (dp, X) grid sits at (r // X, r % X).  A tp row's ranks
    # hold the same activations: their generators fold the dp index alone;
    # the kernels' seed also folds the tp index (the JAX wrappers' 7919).
    tp = Mesh(dp=2, rank=3, device=CPU, axis="tp", size=2)
    assert (tp.dp_index, tp.axis_index, tp.world, tp.tp) == (1, 1, 4, 2)
    assert tp.fold_seed(7) == 7 + 1000003
    assert tp.kernel_seed(7) == 7 + 1000003 + 7919
    # An sp row's ranks hold different tokens: their generators differ.
    sp = Mesh(dp=2, rank=3, device=CPU, axis="sp", size=2)
    assert sp.fold_seed(7) == 7 + 1000003 + 7919 and sp.tokens_sharded
    assert sp.kernel_seed(7) == 7 + 1000003 + 7919
    # The ring hashes absolute coordinates: a cp rank's seed is unfolded.
    assert Mesh(dp=2, rank=3, device=CPU, axis="cp", size=2).kernel_seed(7) == 7
    # A rank's kernel seeds are the single-device draws plus its fold.
    draws = [DropoutRng(torch.Generator(), torch.Generator().manual_seed(3),
                        seed_offset=Mesh(dp=2, rank=r, device=CPU).fold_seed(0))
             for r in range(2)]
    for _ in range(3):
        assert draws[1].seed() == draws[0].seed() + 1000003
    trainer = TTrainer(TConfig(**SMALL), device="cpu", mesh=Mesh(dp=2, rank=1, device=CPU))
    assert trainer.init_state()["rng"].seed_offset == 1000003
    # A pp row's stages hold other layers of the same rows: they fold the
    # stage into both seeds, so each stage draws its own masks.
    pp = Mesh(dp=2, rank=3, device=CPU, axis="pp", size=2)
    assert (pp.dp_index, pp.axis_index, pp.world, pp.tp) == (1, 1, 4, 1)
    assert pp.fold_seed(7) == 7 + 1000003 + 7919 and not pp.tokens_sharded
    assert pp.kernel_seed(7) == 7 + 1000003 + 7919
    # Sequence, context and pipeline parallelism are the pretrain task's:
    # a fine-tuning trainer refuses them; pp composes with dp alone.
    for axis in ("mesh_pp", "mesh_sp", "mesh_cp"):
        with pytest.raises(ValueError, match=f"--{axis} applies to the pretrain task"):
            refuse_pretrain_axes(TRunConfig(**{axis: 2}))
    for flags in ({"mesh_dp": 4}, {"zero1": True}, {"fsdp": True}, {"mesh_tp": 2}):
        refuse_pretrain_axes(TRunConfig(**flags))
    for flags, msg in (({"zero1": True}, "--zero1 applies to the standard pretrain"),
                       ({"fsdp": True}, "--fsdp applies to the standard pretrain"),
                       ({"mesh_tp": 2}, "--mesh_pp composes with dp only")):
        with pytest.raises(ValueError, match=msg):
            TRunConfig(mesh_pp=2, **flags)


def test_process_groups_default_to_nccl_on_the_card(monkeypatch):
    """Without a card, a process group on the default device (the card,
    NCCL) raises, and so does ``run`` under torchrun's environment: nothing
    falls back to gloo or to one process."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import torch.distributed as dist

    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.init_process_group()
    for key, value in (("RANK", "0"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(key, value)
    assert parallel.launched_by_torchrun()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trun.main(["viewpoint", "--debug"])
    assert not dist.is_initialized()


def test_fsdp_on_viewpoint_warns_from_a_config_file(tmp_path, monkeypatch, capsys):
    seen = {}
    monkeypatch.setattr(trun, "run_viewpoint", lambda cfg, **kw: seen.setdefault("cfg", cfg))
    path = str(tmp_path / "cfg.json")
    with open(path, "w") as f:
        json.dump({"fsdp": True, "zero1": True}, f)
    trun.main(["viewpoint", "--config", path], device="cpu")
    assert "config-file fsdp=true is ignored" in capsys.readouterr().err
    assert seen["cfg"].fsdp is False and seen["cfg"].zero1 is True
    with pytest.raises(SystemExit, match="--fsdp applies to the pretrain task"):
        trun.main(["viewpoint", "--config", path, "--fsdp"], device="cpu")
    with pytest.raises(SystemExit, match="--zero1 applies"):
        trun.main(["turn_based", "--config", path, "--zero1"], device="cpu")


# -- batch streams -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nav(tmp_path_factory):
    jw, tw = JWorld(**WORLD), TWorld(**WORLD)
    counts = {"train": 11}
    jroot = jw.write_task_data(str(tmp_path_factory.mktemp("jax")), counts=counts)
    troot = tw.write_task_data(str(tmp_path_factory.mktemp("torch")), counts=counts)
    vocab = jd.build_wordpiece_vocab([" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512)
    jinst = jd.build_nav_instances(jroot, ["train"], jd.WordPieceTokenizer(vocab),
                                   max_seq_length=128)
    tinst = td.build_nav_instances(troot, ["train"], td.WordPieceTokenizer(vocab),
                                   max_seq_length=128)
    jrt = ja.NavRuntime.build(jw.graphs, jd.SceneFeatureTable.pack(
        jw.graphs, jw.scene_features(), vfov=60))
    trt = ta.NavRuntime.build(tw.graphs, td.SceneFeatureTable.pack(
        tw.graphs, tw.scene_features(), vfov=60), device="cpu")
    return jinst, tinst, jrt, trt


@pytest.mark.parametrize("num_hosts", [2, 3])
def test_multi_host_batch_streams_match_jax(nav, num_hosts):
    jinst, tinst, jrt, trt = nav
    trimmed = 0
    for host in range(num_hosts):
        kw = dict(batch_size=2, seed=5, host_id=host, num_hosts=num_hosts,
                  length_sort_window=2, length_bucket=16)
        jb, tb = JBatcher(jinst, jrt, **kw), ta.NavEpisodeBatcher(tinst, trt, **kw)
        batches = list(zip(jb.train_batches(6, episode_len=4),
                           tb.train_batches(6, episode_len=4)))
        # A resumed stream: the shadows advance in lock-step.
        jr, tr = JBatcher(jinst, jrt, **kw), ta.NavEpisodeBatcher(tinst, trt, **kw)
        jr.skip_batches(3)
        tr.skip_batches(3)
        batches += list(zip(jr.train_batches(6, episode_len=4),
                            tr.train_batches(6, episode_len=4)))
        for jbatch, tbatch in batches:
            assert jbatch.keys() == tbatch.keys()
            for key, v in jbatch.items():
                if isinstance(v, list):
                    assert tbatch[key] == v, key
                else:
                    np.testing.assert_array_equal(tbatch[key], np.asarray(v), err_msg=key)
            trimmed += tbatch["ids"].shape[1] < 128
        assert len(tb.instances) == len(tinst[host::num_hosts])
    assert trimmed > 0  # the global length trim took effect


# -- the attention keep masks under a dp mesh -----------------------------------------------

def test_attention_keep_masks_under_a_dp_mesh_match_jax():
    b, s, h, d, rate = 4, 128, 2, 64, 0.1
    seed = 2 ** 31 - 5  # rank 1's fold wraps past int32
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((b, s, h * d)).astype(np.float32) for _ in range(3))
    bias = np.where(rng.random((b, s)) < 0.1, -1e9, 0.0).astype(np.float32)
    want = np.asarray(jatt.fused_attention_mesh_packed(
        *map(jnp.asarray, (q, k, v, bias)), h, dropout_seed=seed, dropout_rate=rate,
        mesh=j_make_mesh(dp=2), interpret=True))
    half = b // 2
    for rank in range(2):
        mesh = Mesh(dp=2, rank=rank, device=CPU)
        rows = slice(rank * half, (rank + 1) * half)
        got = tatt.fused_attention_packed(
            *(torch.from_numpy(x[rows]) for x in (q, k, v, bias)), h, mesh.fold_seed(seed),
            rate)
        np.testing.assert_allclose(got.numpy(), want[rows], atol=1e-6, rtol=0)
        jseed = jnp.asarray([seed], jnp.int32) + jnp.int32(rank) * jnp.int32(1000003)
        tmask = tatt._head_keep_mask(mesh.fold_seed(seed), half, h, s, rate, CPU).numpy()
        for bh in range(half * h):
            jmask = np.asarray(jatt._keep_mask(jatt._mix_seed(jseed, bh), 0, 0, (s, s),
                                               jatt._threshold(rate)))
            np.testing.assert_array_equal(tmask[bh // h, bh % h], jmask)
        assert 0.85 < tmask.mean() < 0.95


# -- collectives and the world of one -----------------------------------------------------

@pytest.fixture()
def world_of_one(tmp_path):
    parallel.init_process_group("cpu", init_method=f"file://{tmp_path / 'pg'}", rank=0,
                                world_size=1, timeout_s=60)
    try:
        yield parallel.make_mesh()
    finally:
        parallel.destroy_process_group()


def test_flat_bucket_collectives_in_a_world_of_one(world_of_one, monkeypatch):
    mesh = world_of_one
    assert mesh.backend == "gloo" and mesh.dp == 1 and parallel.host_shard_info(mesh) == (0, 1)
    monkeypatch.setattr(parallel.mesh, "BUCKET_BYTES", 64)
    parallel.reset_collective_counts()
    ts = [torch.arange(6.0).reshape(2, 3), None, torch.ones(20), torch.arange(4)]
    out = parallel.all_reduce_sum(ts, mesh)
    assert out[1] is None and all(torch.equal(a, b) for a, b in zip(out[::2], ts[::2]))
    # float32: [6 el] and [20 el] exceed 64 bytes together; int64 on its own.
    assert parallel.collective_counts()["all_reduce_sum"] == 3
    x = torch.arange(24.0).reshape(2, 3, 4)
    (rs,) = parallel.reduce_scatter([x], [1], mesh)
    assert torch.equal(rs, x)
    (ag,) = parallel.all_gather([x[:, :, 1:3]], [2], mesh)
    assert torch.equal(ag, x[:, :, 1:3])
    got = parallel.replicate_state(mesh, {"a": [x, 3], "b": torch.ones(2)})
    assert torch.equal(got["a"][0], x) and got["a"][1] == 3
    assert parallel.all_gather_object({"k": 1}, mesh) == [{"k": 1}]
    counts = parallel.collective_counts()
    assert counts["reduce_scatter"] == counts["all_gather"] == 1
    # 24 and 2 float32 values exceed 64 bytes together: two broadcasts.
    assert counts["broadcast"] == 2 and counts["all_gather_object"] == 1


@pytest.mark.parametrize("strategy", ["dp", "zero1", "fsdp"])
def test_world_of_one_pretrain_step_is_the_single_device_step(world_of_one, strategy):
    cfg = TConfig(**SMALL, hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    batches = [_pretrain_batch(seed) for seed in (1, 2)]
    runs = []
    for mesh in (None, world_of_one):
        trainer = TTrainer(cfg, device="cpu", mesh=mesh, zero1=strategy == "zero1",
                           fsdp=strategy == "fsdp", total_steps=10, warmup_steps=0,
                           learning_rate=1e-3)
        state = trainer.init_state()
        step = trainer.step_fn()
        bundles = []
        for batch in batches:
            state, bundle = step(state, batch)
            bundles.append(bundle)
        runs.append((state, bundles))
    (s0, b0), (s1, b1) = runs
    for x, y in zip(b0, b1):
        assert all(torch.equal(x[k], y[k]) for k in x)
    assert all(torch.equal(s0["params"][k], s1["params"][k]) for k in s0["params"])
    leaves = parallel.mesh._leaves
    assert all(torch.equal(a, c) if isinstance(a, torch.Tensor) else a == c
               for a, c in zip(leaves(s0["opt_state"]), leaves(s1["opt_state"])))
    assert parallel.collective_counts()["all_reduce_sum"] >= 4  # counts + gradients


@pytest.mark.parametrize("kind", ["teacher", "sample", "rl"])
def test_world_of_one_viewpoint_step_is_the_single_device_step(world_of_one, nav, kind):
    _, tinst, _, trt = nav
    cfg = TConfig(vocab_size=600, hidden_size=64, num_hidden_layers=1, num_attention_heads=1,
                  intermediate_size=128, max_position_embeddings=128, type_vocab_size=4)
    agent_kw = dict(feature_dim=64, episode_len=4, rnn_dim=16, encoder_hidden_size=16,
                    aemb=8, dropout=0.2, learning_rate=1e-3, device="cpu")
    batcher = ta.NavEpisodeBatcher(tinst, trt, batch_size=4)
    batch = next(batcher.train_batches(1, episode_len=4))
    if kind != "teacher":
        batch = batcher.with_sample_teacher(batch)
    runs = []
    for mesh in (None, world_of_one):
        agent = ta.ViewpointAgent(cfg, trt, **agent_kw, mesh=mesh, zero1=True)
        state = agent.init_state(with_critic=kind == "rl")
        step = {"teacher": agent.train_step_fn, "sample": agent.sample_train_step_fn,
                "rl": agent.rl_train_step_fn}[kind]()
        runs.append(step(state, batch))
    (s0, out0), (s1, out1) = runs
    loss0, loss1 = (o[0] if kind == "rl" else o for o in (out0, out1))
    assert torch.equal(loss0, loss1)
    if kind == "rl":
        assert all(torch.equal(out0[1][k], out1[1][k]) for k in out0[1])
    for part in s0["params"]:
        assert all(torch.equal(s0["params"][part][k], s1["params"][part][k])
                   for k in s0["params"][part])


def test_checkpoint_layout_round_trip_under_sharding():
    """gather(shard(x)) is x for every strategy's state of a dp 2 rank pair,
    built without a process group from both ranks' shards."""
    trainer = TTrainer(TConfig(**SMALL), device="cpu")
    params = trainer.init_params()
    full_opt = trainer.optimizer.init(params)
    axes = parallel.fsdp_param_rules(Mesh(dp=2, rank=0, device=CPU), params,
                                     parallel.jax_axis_orders(trainer.model))
    shards = [parallel.reshard_state(Mesh(dp=2, rank=r, device=CPU), params, axes)
              for r in range(2)]
    for name, a in axes.items():
        if a is None:
            assert torch.equal(shards[0][name], params[name])
        else:
            assert torch.equal(torch.cat([s[name] for s in shards], dim=a), params[name])
            assert shards[0][name].is_contiguous()
    opt_axes = parallel.zero1_opt_rules(axes, full_opt)
    assert sum(a is not None for a in parallel.mesh._leaves(opt_axes)) == 2 * sum(
        a is not None for a in axes.values())
    assert os.path.basename(parallel.mesh.__file__) == "mesh.py"
