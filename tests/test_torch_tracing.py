"""The program's phase spans (visitron_torch/utils/tracing.py) and the batch
copy's byte counter, on the CPU: a pretraining step records the copy,
forward, backward and optimizer spans once each, in order, as host records
that are not user annotations (which a CUDA session would mirror onto the
device timeline); the navigation training steps record the batcher,
encoder, decoder, backward and optimizer spans, and the evaluation's
rollout only the encoder's; the counter grows by the bytes the copies carry;
and a step under the profiler gives what it gives without."""

import tempfile

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from visitron_torch import agents as ta
from visitron_torch import data as td
from visitron_torch.models import BertConfig
from visitron_torch.testing import SyntheticWorld
from visitron_torch.testing.synthetic import _TARGETS, _WORDS
from visitron_torch.train.pretrain import PretrainTrainer, batch_to_device
from visitron_torch.utils import tracing

IMG_DIM = 24
PRETRAIN = dict(vocab_size=101, hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=256, type_vocab_size=4, img_feature_dim=IMG_DIM,
                detector_classes=11)
SEQ = 128
EP_LEN = 3
NAV = dict(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
           intermediate_size=256, max_position_embeddings=SEQ, type_vocab_size=4)
AGENT = dict(feature_dim=64, episode_len=EP_LEN, rnn_dim=24, encoder_hidden_size=16,
             aemb=8, dropout=0.1)


@pytest.fixture(autouse=True)
def one_thread():
    """The tiny steps gain nothing from intra-op threads, and with several
    test workers per machine the threads only contend; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_batch(seed, b=2, s_text=64, s_img=32):
    rng = np.random.default_rng(seed)
    s = s_text + s_img
    labels = np.where(rng.random((b, s)) < 0.3, rng.integers(0, 101, (b, s)), -1)
    labels[:, s_text:] = -1
    tokens = np.where(rng.random((b, s)) < 0.2, rng.integers(0, 11, (b, s)), -1)
    tokens[:, s_text:] = -1
    return {
        "input_ids": rng.integers(0, 101, (b, s_text)).astype(np.int32),
        "token_type_ids": rng.integers(0, 4, (b, s_text)).astype(np.int32),
        "attention_mask": np.ones((b, s), np.int32),
        "labels": labels.astype(np.int32),
        "token_labels": tokens.astype(np.int32),
        "img_feats": rng.standard_normal((b, s_img, IMG_DIM)).astype(np.float32),
        "img_location_embeddings": rng.standard_normal((b, s_img, 128)).astype(np.float32),
        "next_action": rng.integers(0, 36, (b,)).astype(np.int32),
    }


def _spans(fn):
    """(fn()'s result, its spans as kineto records in start order)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    events = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("vt.")]
    return out, sorted(events, key=lambda e: e.start_ns())


def _trainer():
    return PretrainTrainer(BertConfig(**PRETRAIN), device="cpu", total_steps=100,
                           learning_rate=1e-3, seed=3)


def test_pretrain_step_records_its_phases_once_each_in_order():
    trainer = _trainer()
    state, step = trainer.init_state(), trainer.step_fn()
    _, spans = _spans(lambda: step(state, _host_batch(1)))
    assert [e.name() for e in spans] == [tracing.BATCH_TO_DEVICE, tracing.FORWARD,
                                         tracing.BACKWARD, tracing.OPTIMIZER]
    for e in spans:
        assert e.device_type() == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation(), e.name()
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns() <= b.start_ns()


def test_batch_to_device_counts_the_host_arrays_bytes():
    """The bytes on the wire: the host arrays as converted for the copy,
    integers as int64, floats as fp32."""
    before = batch_to_device.bytes, batch_to_device.calls
    batches = [_host_batch(2), _host_batch(3, b=3)]
    for i, batch in enumerate(batches, 1):
        out = batch_to_device(batch, "cpu")
        assert batch_to_device.calls == before[1] + i
        assert (batch_to_device.bytes - before[0]
                == sum(sum(a.size * (4 if a.dtype.kind == "f" else 8) for a in b.values())
                       for b in batches[:i]))
    assert out["img_feats"].dtype == torch.float32 and out["labels"].dtype == torch.int64


def test_pretrain_step_is_the_same_under_the_profiler():
    outs = []
    for profiled in (False, True):
        trainer = _trainer()
        state, step = trainer.init_state(), trainer.step_fn()
        run = lambda: step(step(state, _host_batch(4))[0], _host_batch(5))  # noqa: E731
        outs.append(_spans(run)[0] if profiled else run())
    (plain_state, plain_bundle), (traced_state, traced_bundle) = outs
    assert plain_bundle.keys() == traced_bundle.keys()
    for k in plain_bundle:
        assert torch.equal(plain_bundle[k], traced_bundle[k]), k
    for k in plain_state["params"]:
        assert torch.equal(plain_state["params"][k], traced_state["params"][k]), k


@pytest.fixture(scope="module")
def nav():
    world = SyntheticWorld(seed=7, num_scans=2, viewpoints_per_scan=24, scene_feat_dim=64)
    tok = td.WordPieceTokenizer(td.build_wordpiece_vocab(
        [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=512))
    with tempfile.TemporaryDirectory() as d:
        instances = td.build_nav_instances(world.write_task_data(d, counts={"train": 10}),
                                           ["train"], tok, max_seq_length=SEQ)
    rt = ta.NavRuntime.build(world.graphs, td.SceneFeatureTable.pack(
        world.graphs, world.scene_features(), vfov=60), device="cpu")
    agent = ta.ViewpointAgent(BertConfig(vocab_size=len(tok), **NAV), rt, **AGENT,
                              device="cpu")
    return {"instances": instances, "rt": rt, "agent": agent}


STEP = (tracing.ENCODER, tracing.DECODER, tracing.BACKWARD, tracing.OPTIMIZER)


@pytest.mark.parametrize("kind,expected", [
    ("teacher", STEP), ("sample", STEP), ("rl", STEP),
    ("rollout", (tracing.ENCODER,))])
def test_nav_steps_record_their_phases(nav, kind, expected):
    agent = nav["agent"]
    batcher = ta.NavEpisodeBatcher(nav["instances"], nav["rt"], batch_size=4)
    batch, spans = _spans(lambda: next(batcher.train_batches(1, EP_LEN)))
    assert [e.name() for e in spans] == [tracing.BATCHER]
    state = agent.init_state(with_critic=kind == "rl")
    if kind == "teacher":
        run = lambda: agent.train_step_fn()(state, batch)  # noqa: E731
    elif kind == "rollout":
        run = lambda: agent.device_rollout(state["params"], agent.trim_batch(batch))  # noqa: E731
    else:
        batch = batcher.with_sample_teacher(batch)
        fn = agent.sample_train_step_fn() if kind == "sample" else agent.rl_train_step_fn()
        run = lambda: fn(state, batch)  # noqa: E731
    _, spans = _spans(run)
    assert tuple(e.name() for e in spans) == expected
    assert not any(e.is_user_annotation() for e in spans)


def test_train_batches_record_one_batcher_span_each(nav):
    """Each span closes before its batch is yielded; evaluation's batches
    record none."""
    batcher = ta.NavEpisodeBatcher(nav["instances"], nav["rt"], batch_size=4)
    batches, spans = _spans(lambda: list(batcher.train_batches(3, EP_LEN)))
    assert [e.name() for e in spans] == [tracing.BATCHER] * len(batches) == [tracing.BATCHER] * 3
    for a, b in zip(spans, spans[1:]):
        assert a.end_ns() <= b.start_ns()
    batches, spans = _spans(lambda: list(batcher.eval_batches(EP_LEN)))
    assert len(batches) >= 2 and not spans
