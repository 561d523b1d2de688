"""Question-asking classifier agent (visitron_tpu/agents/classifier.py;
reference tasks/viewpoint_select/classifier/agent.py:76-717).

Navigation is teacher-forced toward the player goal with the dialog encoder
frozen and in eval mode; the decoder (``AttnDecoderLSTMwithClassifier``)
emits a per-step question-asking logit trained with pos-weighted BCE.  The
dialog context is re-encoded from the timestep's snapshot whenever the
episode reaches a question-asking timestep (:429-462), and the decoder state
is re-seeded from the new encoding there; targets are "will a question be
asked at t+1", ignored once ended or past the episode's recorded gameplay
(:356-373); the loss is the per-step masked mean, summed over T and divided
by T.

The encoder is frozen, so every dialog snapshot a batch can use
(``prepare_batch``: (E, B, S) arrays) is encoded up front in ONE (E*B)-row
encoder call under ``torch.no_grad()`` (on the card: 12 K1f and 25 K2f
launches, no backward kernel), and the T decoder steps pick their snapshot
by ``step2event``, a host array.  The encoder's parameters get zero
gradients, as under ``jax.lax.stop_gradient``.  With
``only_finetune_classifier`` (classifier/agent.py:141-147) the optimizer is
``multi_transform({"train": clip 40 + Adam, "freeze": set_to_zero()})``
over labels that mark the ``question_linear`` parameters "train": the clip's
norm and the Adam moments cover those parameters alone, and every other
parameter stays as it is: it takes no gradient, no zero update and no
rewrite, so a step touches the question head's parameters alone.

Under a dp ``mesh`` each rank prepares its rows, with the encode events of
the global batch (``prepare_batch(items, event_items=...)``: the steps at
which some item of any rank asks), divides each step's loss by the global
count of its kept items, and sums the gradients and the loss over the ranks;
the optimizer state stays replicated (no ``--zero1`` for this task, as in
the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.agents.viewpoint import DialogAgent, gather_step_inputs
from visitron_torch.data.classifier_dataset import ClassifierInstance
from visitron_torch.evaluation.classifier_metrics import binary_classification_metrics
from visitron_torch.models import AttnDecoderLSTMwithClassifier, BertConfig
from visitron_torch.models.layers import DropoutRng
from visitron_torch.train.optim import agent_optimizer, multi_transform, set_to_zero


def bce_with_logits(logits, targets, pos_weight: float):
    """Elementwise pos-weighted binary cross entropy on logits
    (torch BCEWithLogitsLoss(pos_weight=...) parity)."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def question_head_labels(params: dict) -> dict:
    """"train" for the question head's parameters (a name holding
    ``question_linear``), "freeze" for every other, in ``params``' nesting."""
    return {k: question_head_labels(v) if isinstance(v, dict)
            else ("train" if "question_linear" in k else "freeze")
            for k, v in params.items()}


@dataclass
class ClassifierAgent(DialogAgent):
    cfg: BertConfig
    runtime: NavRuntime
    feature_dim: int
    episode_len: int = 40
    angle_feat_size: int = 4
    aemb: int = 64
    rnn_dim: int = 512
    encoder_hidden_size: int = 512
    dropout: float = 0.5
    learning_rate: float = 5e-5
    pos_weight: float = 5.0
    only_finetune_classifier: bool = True
    bf16_adam_moments: bool = False
    seed: int = 88
    device: object = None  # None: the mesh's device, else the card
    mesh: object = None  # a (dp, tp) parallel.Mesh: data / tensor-parallel training

    def __post_init__(self):
        self._resolve_device()
        self._make_encoder(hidden_size=self.encoder_hidden_size,
                           decoder_hidden_size=self.rnn_dim, dropout_ratio=self.dropout)
        self.decoder = AttnDecoderLSTMwithClassifier(
            angle_feat_size=self.angle_feat_size, embedding_size=self.aemb,
            hidden_size=self.rnn_dim,
            feature_size=self.feature_dim + self.angle_feat_size,
            ctx_size=self.encoder_hidden_size,
            dropout_ratio=self.dropout).to(self.device).eval()
        base = agent_optimizer(self.learning_rate, "adam", 40.0,
                               bf16_moments=self.bf16_adam_moments,
                               norm=self._clip_norm())
        self.optimizer = (multi_transform({"train": base, "freeze": set_to_zero()},
                                          question_head_labels)
                          if self.only_finetune_classifier else base)

    def init_state(self, params: dict | None = None) -> dict:
        """Training state: ``params`` (fresh, or the given full ones),
        ``opt_state`` and the decoder's dropout generators ``rng``."""
        return self._train_state(self.init_params() if params is None else params,
                                 rng=self.dropout_rng())

    def load_nav_decoder(self, params: dict, nav_decoder_params: dict) -> dict:
        """``params`` with the decoder initialised from a fine-tuned nav
        checkpoint's decoder wherever a name exists on both sides; the
        question head keeps its fresh init (missing-layer backfill parity,
        classifier/agent.py:699-711)."""
        dec = dict(params["decoder"])
        for name, v in nav_decoder_params.items():
            if name in dec:
                if tuple(v.shape) != tuple(dec[name].shape):
                    raise ValueError(f"decoder {name}: checkpoint shape {tuple(v.shape)} "
                                     f"!= model shape {tuple(dec[name].shape)}")
                dec[name] = v.to(device=dec[name].device, dtype=dec[name].dtype)
        return {**params, "decoder": dec}

    # -- batch preparation (host) ---------------------------------------------------
    def prepare_batch(self, items: list[ClassifierInstance],
                      event_items: list[ClassifierInstance] | None = None) -> dict:
        """Host arrays of a batch: the teacher-forced nav episode toward the
        player goal, the QA targets and ignores, and the dialog snapshots
        (E, B, S) of every encode event (step 0 and each step at which some
        item of ``event_items`` asked, default ``items``: a rank's rows take
        the events of the global batch; E is their number, with no
        padding), with ``step2event`` (T,) mapping steps to events."""
        rt = self.runtime
        b = len(items)
        t_len = self.episode_len
        starts = np.zeros(b, np.int32)
        views = np.zeros(b, np.int32)
        goals = np.zeros(b, np.int32)
        for i, it in enumerate(items):
            # Elevation always starts at 0 (reference newEpisodes parity).
            starts[i], views[i] = rt.start_state(
                it.scan, it.player_path[0], it.start_pano["heading"], 0.0)
            goals[i] = rt.row(it.scan, it.player_path[-1])
        nav = rt.teacher_rollout_arrays([it.scan for it in items], starts, views, goals,
                                        t_len)

        # QA targets / ignores per step (classifier/agent.py:356-373).
        qa_target = np.zeros((b, t_len), np.float32)
        qa_ignore = np.ones((b, t_len), bool)
        ended = ~nav["active"]
        for i, it in enumerate(items):
            for t in range(t_len):
                if ended[i, t] or (t + 1) > it.max_timestep:
                    continue
                qa_ignore[i, t] = False
                qa_target[i, t] = 1.0 if (t + 1) in it.request_locations else 0.0

        # Encode events: step 0 plus every step t at which some item asked
        # (the whole batch re-encoded; classifier/agent.py:424-462).
        events = [0] + [t for t in range(1, t_len)
                        if any(t in it.request_locations for it in (event_items or items))]
        s = items[0].token_ids.shape[1]
        e = len(events)
        lang_ids = np.zeros((e, b, s), np.int32)
        lang_segs = np.zeros((e, b, s), np.int32)
        lang_lens = np.ones((e, b), np.int32)
        step2event = np.zeros(t_len, np.int32)
        for ei, t in enumerate(events):
            for i, it in enumerate(items):
                row = it.language_at(t)
                lang_ids[ei, i] = it.token_ids[row]
                lang_segs[ei, i] = it.segment_ids[row]
                lang_lens[ei, i] = it.lengths[row]
        cur = 0
        for t in range(t_len):
            if cur + 1 < len(events) and events[cur + 1] <= t:
                cur += 1
            step2event[t] = cur
        # Length-bucket the snapshots to 128-multiples: pads are masked, so
        # the result is the same with less encoder work.
        s_trim = min(s, -(-int(lang_lens.max()) // 128) * 128)
        return {
            "cur_row": nav["cur_row"], "view": nav["view"],
            "teacher": nav["teacher"], "active": nav["active"],
            "qa_target": qa_target, "qa_ignore": qa_ignore,
            "lang_ids": lang_ids[:, :, :s_trim], "lang_segs": lang_segs[:, :, :s_trim],
            "lang_lens": lang_lens, "step2event": step2event,
            "inst_idx": [it.inst_idx for it in items],
        }

    # -- the loss ----------------------------------------------------------------------
    def episode_outputs(self, params, batch: dict, rng: DropoutRng | None = None,
                        encoder=None):
        """(B, T) question-asking logits of a prepared batch: every snapshot
        through the frozen encoder in one (E*B)-row call without gradients,
        then T teacher-forced decoder steps (``rng``: the decoder's
        dropouts; ``encoder``: the module, default the training encoder)."""
        e, b, s = batch["lang_ids"].shape
        lens = self._index(batch["lang_lens"]).reshape(e * b)
        with torch.no_grad():  # frozen encoder in eval mode (no_grad parity)
            ctx, h, c = functional_call(
                self.encoder if encoder is None else encoder, params["encoder"],
                (self._index(batch["lang_ids"]).reshape(e * b, s), lens),
                {"token_type_ids": self._index(batch["lang_segs"]).reshape(e * b, s),
                 "rng": None}, strict=True)
        ctxs, hs, cs = ctx.unflatten(0, (e, b)), h.unflatten(0, (e, b)), c.unflatten(0, (e, b))
        ctx_masks = (torch.arange(s, device=self.device)[None, :]
                     >= lens[:, None]).unflatten(0, (e, b))
        cur_row, view = self._index(batch["cur_row"]), self._index(batch["view"])
        step2event = np.asarray(batch["step2event"])
        h, c, prev = hs[0], cs[0], 0
        qa = []
        for t in range(cur_row.shape[1]):
            event = int(step2event[t])
            if event != prev:
                # A re-encode step re-seeds the decoder state from the new
                # encoding (classifier/agent.py:446-457).
                h, c, prev = hs[event], cs[event], event
            a_t, f_t, cand_feat, _ = gather_step_inputs(self.runtime, cur_row[:, t],
                                                        view[:, t])
            h, c, _, qa_logit, _ = functional_call(
                self.decoder, params["decoder"],
                (a_t, f_t, cand_feat, h, c, ctxs[event], ctx_masks[event]), {"rng": rng},
                strict=True)
            qa.append(qa_logit[:, 0])
        return torch.stack(qa, dim=1)

    def loss_fn(self, params, batch: dict, rng: DropoutRng | None = None,
                count_sum=None, encoder=None):
        """(loss, qa_logits): the per-step masked mean of the pos-weighted
        BCE, summed over T and divided by T (classifier/agent.py:493-507,585).
        ``count_sum`` (:meth:`_count_sum`) takes the kept counts to the
        global batch's; None: this batch's.  ``encoder``: as
        :meth:`episode_outputs`'."""
        qa_logits = self.episode_outputs(params, batch, rng, encoder)
        t = torch.as_tensor(np.stack([~np.asarray(batch["qa_ignore"]),
                                      np.asarray(batch["qa_target"]) > 0])).to(self.device)
        keep, target = t[0].float(), t[1].float()
        per = bce_with_logits(qa_logits, target, self.pos_weight) * keep
        n = keep.sum(dim=0)
        if count_sum is not None:  # each step's kept count over the global batch
            n = count_sum(n)
        step_losses = per.sum(dim=0) / torch.clamp(n, min=1.0)
        return step_losses.sum() / qa_logits.shape[1], qa_logits

    def train_step_fn(self):
        """``run(state, batch) -> (state, loss)``: one step of the prepared
        ``batch`` with the decoder's dropouts, the optimizer (clip 40 +
        Adam, on the question head alone with ``only_finetune_classifier``)."""

        def run(state, batch):
            # With only_finetune_classifier the frozen parameters take no
            # gradient and no update: only the question head is touched.
            labels = (question_head_labels(state["params"])
                      if self.only_finetune_classifier else None)
            count_sum = self._count_sum()
            loss, _, grads = self.value_and_grads(
                state["params"], lambda p: self.loss_fn(p, batch, state["rng"], count_sum),
                labels)
            state, logged = self.apply_grads(state, grads, {"loss": loss})
            return state, logged["loss"]

        return run

    def evaluate(self, params, batches) -> dict[str, float]:
        """Deterministic pass over prepared ``batches``: the binary
        classification metrics of the non-ignored steps (sigmoid >= 0.5)
        and the mean loss (classifier/agent.py:596-603)."""
        preds, labels = [], []
        total_loss, n = 0.0, 0
        with torch.no_grad():
            for batch in batches:
                loss, qa_logits = self.loss_fn(params, batch, **self._eval_kw())
                total_loss += float(loss)
                n += 1
                keep = ~np.asarray(batch["qa_ignore"])
                probs = torch.sigmoid(qa_logits).cpu().numpy()
                preds.extend((probs[keep] >= 0.5).astype(int).tolist())
                labels.extend(np.asarray(batch["qa_target"])[keep].astype(int).tolist())
        metrics = binary_classification_metrics(labels, preds)
        metrics["loss"] = total_loss / max(n, 1)
        return metrics
