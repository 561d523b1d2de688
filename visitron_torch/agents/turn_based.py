"""Turn-based (low-level action space) navigation agent
(visitron_tpu/agents/turn_based.py; reference tasks/turn_based/agent.py:68-477).

Six output actions (left, right, up, down, forward, <end>); the input
embedding takes 8 ids (+<start>, <ignore>); the decoder sees one view's
scene feature a step; forward always moves to the most centred visible
neighbour (env_actions[4] == (1, 0, 0)).

Training is teacher-forced along an episode precomputed on the host
(``NavEpisodeBatcher.with_turn_teacher``): the encoder, then T decoder steps
on the device, each a masked CE over the items still active; the loss is
the sum of the step losses over T.  ``train_step_fn`` runs it with every
dropout active, takes the gradients with ``torch.autograd.grad`` (the BERT
attention and LayerNorms backward through K1b and K2b), clips them and
applies Adam.

Under a dp ``mesh`` the step is the viewpoint agent's data-parallel step
(global per-step active counts, summed gradients and loss, rank-folded
dropout and sampling seeds); the optimizer state stays replicated, as in
the JAX package, whose turn-based task takes no ``--zero1``.

The student rollout (``rollout_student``, ``test``) applies each turn on the
host, as the JAX package does: the navigable locations of a (viewpoint,
view) pair come from host tables, so every step moves the (B,) rows, views
and forward flags to the card and reads one (B,) action vector back.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from visitron_torch import geometry as geo
from visitron_torch.agents import decoding
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.agents.viewpoint import DialogAgent
from visitron_torch.models import BertConfig, TurnBasedDecoderLSTM
from visitron_torch.models.layers import DropoutRng
from visitron_torch.ops.masking import NEG_INF
from visitron_torch.train.optim import agent_optimizer

MODEL_ACTIONS = ["left", "right", "up", "down", "forward", "<end>", "<start>", "<ignore>"]
START_ID = MODEL_ACTIONS.index("<start>")
END_ID = MODEL_ACTIONS.index("<end>")
FORWARD_ID = MODEL_ACTIONS.index("forward")
IGNORE_ID = MODEL_ACTIONS.index("<ignore>")


@dataclass
class TurnBasedAgent(DialogAgent):
    cfg: BertConfig
    runtime: NavRuntime
    feature_dim: int
    episode_len: int = 40
    aemb: int = 32
    rnn_dim: int = 512
    encoder_hidden_size: int = 512
    dropout: float = 0.5
    learning_rate: float = 1e-4
    bf16_adam_moments: bool = False
    seed: int = 88
    device: object = None  # None: the mesh's device, else the card
    mesh: object = None  # a (dp, tp) parallel.Mesh: data / tensor-parallel training

    def __post_init__(self):
        self._resolve_device()
        self._make_encoder(hidden_size=self.encoder_hidden_size,
                           decoder_hidden_size=self.rnn_dim, dropout_ratio=self.dropout)
        self.decoder = TurnBasedDecoderLSTM(
            input_action_size=len(MODEL_ACTIONS), output_action_size=6,
            embedding_size=self.aemb, hidden_size=self.rnn_dim,
            feature_size=self.feature_dim, ctx_size=self.encoder_hidden_size,
            dropout_ratio=self.dropout).to(self.device).eval()
        # Clip 40 + Adam, as the JAX turn-based trainer builds it
        # (--agent_max_grad_norm reaches the viewpoint agent alone).
        self.optimizer = agent_optimizer(self.learning_rate, "adam", 40.0,
                                         bf16_moments=self.bf16_adam_moments,
                                         norm=self._clip_norm())
        self.results: dict = {}
        self.readbacks = 0  # (B,) action vectors the student rollouts read back

    def init_state(self, params: dict | None = None) -> dict:
        """Training state: ``params`` (fresh, or the given full ones),
        ``opt_state``, the dropout generators ``rng`` and ``sampler`` (seed +
        2), as in ViewpointAgent."""
        if params is None:
            params = self.init_params()
        sampler = torch.Generator(device=self.device).manual_seed(
            self._rank_seed(self.seed + 2))
        return self._train_state(params, rng=self.dropout_rng(), sampler=sampler)

    def decode_step(self, params, a_prev, h, c, ctx, ctx_mask, cur_row, view, fwd_ok,
                    rng: DropoutRng | None = None):
        """One decoder step on the view ``view`` of ``cur_row``; forward is
        masked where nothing is navigable (turn_based/agent.py:316-318).
        Returns (logit (B, 6), h_1, c_1)."""
        f_t = self.runtime.feats[cur_row, view]  # (B, D): one view
        h, c, _, logit = functional_call(self.decoder, params["decoder"],
                                         (a_prev, f_t, h, c, ctx, ctx_mask), {"rng": rng},
                                         strict=True)
        forward = torch.arange(6, device=self.device) == FORWARD_ID
        return logit.masked_fill(forward[None, :] & ~fwd_ok[:, None], NEG_INF), h, c

    # -- teacher-forced training ------------------------------------------------
    def episode_loss(self, params, batch: dict, rng: DropoutRng | None = None,
                     count_sum=None, encoder=None):
        """Mean teacher-forced loss of a trimmed batch with turn-teacher
        arrays: each step's CE over its active items (n = max(sum(active),
        1)), summed over T and divided by T.  After the end the next input is
        the <ignore> id (turn_based/agent.py:212-232).  ``count_sum``
        (:meth:`_count_sum`) takes the active counts to the global batch's;
        None: this batch's.  ``encoder``: as :meth:`encode`'s."""
        ctx, h, c, ctx_mask = self.encode(params, batch, rng, encoder)
        cur_row, view = self._index(batch["cur_row"]), self._index(batch["view"])
        teacher = self._index(batch["teacher"])
        flags = torch.as_tensor(np.stack([batch["fwd_ok"], batch["active"]])).to(self.device)
        fwd_ok, active = flags[0], flags[1]
        t_len = cur_row.shape[1]
        a_prev = torch.full((cur_row.shape[0],), START_ID, dtype=torch.int64,
                            device=self.device)
        counts = active.float().sum(0)
        if count_sum is not None:  # each step's active count over the global batch
            counts = count_sum(counts)
        loss = torch.zeros((), device=self.device)
        for t in range(t_len):
            logit, h, c = self.decode_step(params, a_prev, h, c, ctx, ctx_mask,
                                           cur_row[:, t], view[:, t], fwd_ok[:, t], rng)
            act = active[:, t]
            ce = F.cross_entropy(logit.float(), torch.where(act, teacher[:, t], 0),
                                 reduction="none")
            loss = loss + torch.sum(ce * act.float()) / torch.clamp(counts[t], min=1.0)
            a_prev = torch.where(act, teacher[:, t], IGNORE_ID)
        return loss / t_len

    def train_step_fn(self):
        """``run(state, batch) -> (state, loss)``: one teacher-forced step
        with every dropout active, the global-norm clip and Adam."""

        def run(state, batch):
            batch = self.train_trim(batch)
            count_sum = self._count_sum()
            loss, _, grads = self.value_and_grads(
                state["params"],
                lambda p: (self.episode_loss(p, batch, state["rng"], count_sum), None))
            state, logged = self.apply_grads(state, grads, {"loss": loss})
            return state, logged["loss"]

        return run

    def eval_loss_fn(self, use_dropout: bool = False):
        """Teacher-forced validation loss without gradients: ``run(params,
        batch, rng=None)``; ``use_dropout`` needs the ``rng``."""

        def run(params, batch, rng: DropoutRng | None = None):
            if use_dropout and rng is None:
                raise ValueError("eval_loss_fn(use_dropout=True) needs an rng")
            with torch.no_grad():
                return self.episode_loss(params, self.trim_batch(batch),
                                         rng if use_dropout else None,
                                         **self._eval_kw())

        return run

    # -- student rollout -----------------------------------------------------------
    def rollout_student(self, params, batch: dict, feedback: str = "argmax",
                        generator: torch.Generator | None = None):
        """Trajectories [(viewpointId, heading, elevation)] from the start
        pose, the turns applied on the host: ``argmax`` or a categorical
        draw from ``generator`` (any other ``feedback``)."""
        rt = self.runtime
        batch = self.trim_batch(batch)
        ctx, h, c, ctx_mask = self.encode(params, batch, **self._eval_kw())
        b = len(batch["scans"])
        rows = np.asarray(batch["start_rows"], np.int64).copy()
        views = np.asarray(batch["start_views"], np.int64).copy()
        ended = np.zeros(b, bool)
        a_prev = torch.full((b,), START_ID, dtype=torch.int64, device=self.device)
        traj = []
        for i in range(b):
            scan, vp = rt.row_to_id(int(rows[i]))
            traj.append({"inst_idx": batch["inst_idx"][i],
                         "path": [(vp, geo.heading_of_view(int(views[i])),
                                   geo.elevation_of_view(int(views[i])))]})
        for _ in range(self.episode_len):
            fwd_ok = [len(rt.navigable_at(int(rows[i]), int(views[i]))) > 0 for i in range(b)]
            step_in = torch.as_tensor(np.stack([rows, views, fwd_ok])).to(self.device)
            logit, h, c = self.decode_step(params, a_prev, h, c, ctx, ctx_mask,
                                           step_in[0], step_in[1], step_in[2].bool())
            if feedback == "argmax":
                a_prev = torch.argmax(logit, dim=-1)
            else:
                a_prev = decoding.categorical(logit.float(), generator)
            a = a_prev.cpu().numpy()  # the host applies the turn
            self.readbacks += 1
            for i in range(b):
                if ended[i]:
                    continue
                if a[i] == END_ID:
                    ended[i] = True
                    continue
                rows[i], views[i] = rt.apply_turn_action(int(rows[i]), int(views[i]),
                                                         int(a[i]))
                scan, vp = rt.row_to_id(int(rows[i]))
                traj[i]["path"].append((vp, geo.heading_of_view(int(views[i])),
                                        geo.elevation_of_view(int(views[i]))))
            if ended.all():
                break
        return traj

    def test(self, params, batches, feedback: str = "argmax",
             generator: torch.Generator | None = None) -> dict:
        """{inst_idx: trajectory} of the student rollouts of ``batches``
        until an instance repeats; ``generator`` (None: one on the agent's
        device seeded with 1) draws the sampled actions."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(1)
        self.results = {}
        looped = False
        with torch.inference_mode():
            for batch in batches:
                for traj in self.rollout_student(params, batch, feedback, generator):
                    if traj["inst_idx"] in self.results:
                        looped = True
                    else:
                        self.results[traj["inst_idx"]] = traj["path"]
                if looped:
                    break
        return self.results
