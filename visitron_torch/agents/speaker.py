"""Speaker agent: trajectory -> instruction generation and back-translation
augmentation (visitron_tpu/agents/speaker.py; the reference ships the
speaker modules unwired, tasks/viewpoint_select/agent_models.py:512-629).

  * Training: teacher trajectories of ``NavEpisodeBatcher`` paired with the
    task data's text (``attach_words``).  The trajectory features are
    gathered on the device from the ``NavRuntime`` tables, the encoder and
    decoder run with every dropout active (and, with ``feat_dropout``, the
    EnvDrop feature dropout on the visual dims, one mask per episode), the
    loss is the token-mean fp32 word CE over the non-pad targets, and one
    Adam step at ``learning_rate`` follows (optax.adam: no clip).
  * Generation (``generate_fn``): greedy at temperature 0, else a
    categorical draw at that temperature from an explicit generator; the
    ``max_words`` decode loop keeps its tokens and ``ended`` flags on the
    device and reads nothing back.
  * ``augment``: random shortest-path walks over the nav graphs, captioned
    and written as R2R-format records (scan / path / heading /
    instructions), which ``build_aug_instances`` / ``--aug_data`` feed back
    into viewpoint fine-tuning.  The walks come from a numpy generator and
    every batch draws one seed from it, at temperature 0 too, so the
    records follow the JAX package's draws exactly; a batch reads back its
    ids once, and its self-scores once more under ``keep_fraction``.

``params`` are ``{"encoder": {name: tensor}, "decoder": {name: tensor}}``;
``visitron_torch.convert.convert_agent_params`` carries the JAX speaker's
across, ``convert_opt_state`` its optax.adam state.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from visitron_torch import geometry as geo
from visitron_torch.agents import decoding
from visitron_torch.agents.runtime import NavRuntime
from visitron_torch.agents.viewpoint import DialogAgent
from visitron_torch.models.layers import DropoutRng
from visitron_torch.models.speaker import SpeakerDecoder, SpeakerEncoder
from visitron_torch.train.optim import chain, scale_by_adam, scale_by_learning_rate

TRAJ_KEYS = ("cur_row", "view", "teacher", "active")


@dataclass
class SpeakerAgent(DialogAgent):
    runtime: NavRuntime
    feature_dim: int                 # scene feature dim D (without angle feat)
    vocab_size: int
    bos_id: int                      # [CLS] starts decoding
    eos_id: int                      # [SEP] ends decoding
    pad_id: int = 0
    episode_len: int = 10
    max_words: int = 64
    angle_feat_size: int = 4
    hidden_size: int = 512
    wemb: int = 256
    dropout: float = 0.5
    learning_rate: float = 1e-4
    seed: int = 88
    movement_frame: bool = False     # action angle feats relative to the
                                     # previous move's exact heading
    feat_dropout: float = 0.0        # feature dropout on the visual dims
    device: object = None  # None: the card

    def __post_init__(self):
        self._resolve_device()
        f = self.feature_dim + self.angle_feat_size
        self.encoder = SpeakerEncoder(feature_size=f, hidden_size=self.hidden_size,
                                      dropout_ratio=self.dropout).to(self.device).eval()
        self.decoder = SpeakerDecoder(vocab_size=self.vocab_size, embedding_size=self.wemb,
                                      hidden_size=self.hidden_size,
                                      dropout_ratio=self.dropout).to(self.device).eval()
        self.optimizer = chain(scale_by_adam(), scale_by_learning_rate(self.learning_rate))
        self.readbacks = 0  # device-to-host reads of augment's batches

    def init_state(self) -> dict:
        """Training state: ``params`` (init_params at the agent's seed),
        ``opt_state`` and ``rng``, the dropout generators (seed + 1)."""
        params = self.init_params()
        return {"params": params, "opt_state": self.optimizer.init(params),
                "rng": self.dropout_rng()}

    # -- trajectory features (on the device, from the NavRuntime tables) ----------
    def traj_feats(self, cur_row, view, teacher, active):
        """(B, T) int tensors -> (action_embeds (B, T, D+4), pano (B, T, 36,
        D+4)), fp32.  A step's action embedding is the taken candidate's
        scene feature and its angle feature (zero at the stop step and
        after the end); its panorama is the 36-view grid at the current
        state with the panorama angle table."""
        rt = self.runtime
        b, t = cur_row.shape
        rows, views = cur_row.reshape(-1), view.reshape(-1)
        pano = rt.feats[rows]  # (BT, 36, D)
        f_t = torch.cat([pano, rt.pano_af[views]], dim=-1)
        slot = teacher.reshape(-1).clamp(0, rt.max_candidates - 1)[:, None]
        pts = torch.take_along_dim(rt.point[rows], slot, dim=1)[:, 0]
        a_vis = torch.take_along_dim(pano, pts[:, None, None], dim=1)[:, 0]  # (BT, D)
        abs_h = torch.take_along_dim(rt.heading[rows], slot, dim=1)[:, 0]
        if self.movement_frame:
            # The taken heading relative to the previous move's exact
            # heading (step 0: the snapped start view's).
            abs_bt = abs_h.reshape(b, t)
            start = (view[:, 0] % geo.HEADINGS_PER_ROW).to(abs_h.dtype) * geo.ANGLE_INC
            prev = torch.cat([start[:, None], abs_bt[:, :-1]], dim=1)
            ch = (abs_bt - prev).reshape(-1)
        else:
            # The snapped view's heading in the feature dtype, the increment
            # rounded on the host, as gather_step_inputs does.
            inc = float(torch.tensor(geo.ANGLE_INC, dtype=a_vis.dtype))
            ch = abs_h - (views % geo.HEADINGS_PER_ROW).to(a_vis.dtype) * inc
        ce = torch.take_along_dim(rt.elev[rows], slot, dim=1)[:, 0]
        a_af = torch.stack([torch.sin(ch), torch.cos(ch), torch.sin(ce), torch.cos(ce)], -1)
        a_t = torch.cat([a_vis, a_af.to(a_vis.dtype)], dim=-1)
        stopped = (teacher.reshape(-1) >= rt.count[rows]) | ~active.reshape(-1)
        a_t = a_t.masked_fill(stopped[:, None], 0.0)
        f = self.feature_dim + self.angle_feat_size
        return a_t.reshape(b, t, f).float(), f_t.reshape(b, t, geo.NUM_VIEWS, f).float()

    def device_batch(self, batch: dict) -> dict:
        """The trajectory arrays (and ``words``, where present) as int64 /
        bool tensors on the agent's device; tensors pass through."""
        if isinstance(batch["cur_row"], torch.Tensor):
            return batch
        traj = torch.as_tensor(np.stack([np.asarray(batch[k], np.int64) for k in TRAJ_KEYS])
                               ).to(self.device)
        out = dict(zip(TRAJ_KEYS, traj))
        out["active"] = out["active"].bool()
        if "words" in batch:
            out["words"] = self._index(batch["words"])
        return out

    def encode_traj(self, params, batch: dict, rng: DropoutRng | None = None):
        """(ctx (B, T, H), ctx_mask (B, T) True at the steps past each
        trajectory's length) of a device batch; ``rng`` turns on the
        dropouts and the feature dropout."""
        a_t, f_t = self.traj_feats(*(batch[k] for k in TRAJ_KEYS))
        lengths = batch["active"].sum(dim=1)
        if rng is not None and self.feat_dropout > 0.0:
            # EnvDrop's speaker feature dropout: the visual dims only, one
            # mask per episode, the angle features kept.
            d, p = self.feature_dim, self.feat_dropout
            keep = torch.rand((a_t.shape[0], 1, d), generator=rng.masks,
                              device=a_t.device) < 1.0 - p
            scale = keep.to(a_t.dtype) / (1.0 - p)
            a_t = torch.cat([a_t[..., :d] * scale, a_t[..., d:]], dim=-1)
            f_t = torch.cat([f_t[..., :d] * scale[:, :, None, :], f_t[..., d:]], dim=-1)
        ctx = functional_call(self.encoder, params["encoder"], (a_t, f_t, lengths),
                              {"rng": rng}, strict=True)
        t = batch["active"].shape[1]
        ctx_mask = torch.arange(t, device=ctx.device)[None, :] >= lengths[:, None]
        return ctx, ctx_mask

    # -- loss ----------------------------------------------------------------------
    def word_ce(self, params, batch: dict, rng: DropoutRng | None = None):
        """Teacher-forced per-token word CE of a device batch whose
        ``words`` (B, L) start with BOS: (ce, valid), both (B, L-1), over
        words[:, 1:], valid where the target is not padding."""
        ctx, ctx_mask = self.encode_traj(params, batch, rng)
        words = batch["words"]
        h0 = torch.zeros((words.shape[0], self.hidden_size), device=ctx.device)
        logits, _, _ = functional_call(self.decoder, params["decoder"],
                                       (words[:, :-1], ctx, ctx_mask, h0, h0), {"rng": rng},
                                       strict=True)
        targets = words[:, 1:]
        ce = F.cross_entropy(logits.float().flatten(0, 1), targets.flatten(),
                             reduction="none").reshape(targets.shape)
        return ce, (targets != self.pad_id).float()

    def loss(self, params, batch: dict, rng: DropoutRng | None = None):
        """The token-mean word CE (the training objective)."""
        ce, valid = self.word_ce(params, batch, rng)
        return torch.sum(ce * valid) / torch.clamp(valid.sum(), min=1.0)

    def train_step_fn(self):
        """``run(state, batch) -> (state, loss)``: one step with every
        dropout active, then Adam."""

        def run(state, batch):
            batch = self.device_batch(batch)
            loss, _, grads = self.value_and_grads(
                state["params"], lambda p: (self.loss(p, batch, state["rng"]), None))
            return self.apply_grads(state, grads)[0], loss

        return run

    def eval_loss_fn(self):
        """``run(params, batch)``: the deterministic word CE of held-out
        (trajectory, text) pairs."""

        def run(params, batch):
            with torch.no_grad():
                return self.loss(params, self.device_batch(batch))

        return run

    def caption_ce_fn(self):
        """``run(params, batch)``: each example's deterministic word CE, the
        speaker's self-score of a caption against its trajectory (lower:
        the caption is likelier under the model that produced it)."""

        def run(params, batch):
            with torch.no_grad():
                ce, valid = self.word_ce(params, self.device_batch(batch))
                return (ce * valid).sum(1) / torch.clamp(valid.sum(1), min=1.0)

        return run

    # -- generation ----------------------------------------------------------------
    def generate_fn(self, temperature: float = 0.0):
        """``run(params, batch, generator=None) -> (B, max_words)`` ids on the
        device: greedy at ``temperature`` 0, else drawn from the softmax at
        that temperature with ``generator`` (on the agent's device)."""

        def run(params, batch, generator: torch.Generator | None = None):
            with torch.no_grad():
                ctx, ctx_mask = self.encode_traj(params, self.device_batch(batch))
                return self.decode_loop(params, ctx, ctx_mask, temperature, generator)

        return run

    def decode_loop(self, params, ctx, ctx_mask, temperature: float = 0.0,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        """``max_words`` decode steps from BOS; after EOS an item emits
        padding.  Tokens and flags stay on the device."""
        b = ctx.shape[0]
        h = torch.zeros((b, self.hidden_size), device=ctx.device)
        c = h
        word = torch.full((b,), self.bos_id, dtype=torch.int64, device=ctx.device)
        ended = torch.zeros(b, dtype=torch.bool, device=ctx.device)
        out = []
        for _ in range(self.max_words):
            logits, h, c = functional_call(self.decoder, params["decoder"],
                                           (word[:, None], ctx, ctx_mask, h, c), strict=True)
            lg = logits[:, 0].float()
            if temperature > 0.0:
                nxt = decoding.categorical(lg / temperature, generator)
            else:
                nxt = torch.argmax(lg, dim=-1)
            word = nxt.masked_fill(ended, self.pad_id)
            ended = ended | (word == self.eos_id)
            out.append(word)
        return torch.stack(out, dim=1)

    # -- host-side helpers ---------------------------------------------------------
    @staticmethod
    def instance_text(inst) -> str:
        """Supervision text of a NavInstance: the dialog turns joined (NDH)
        or the instruction (R2R/R4R/RxR)."""
        raw = inst.raw or {}
        if isinstance(raw.get("dialog_history"), list):
            text = " ".join(t.get("message", "") for t in raw["dialog_history"]
                            if t.get("message"))
            return text or str(raw.get("target", ""))
        if raw.get("instructions"):
            return raw["instructions"][0]
        return str(raw.get("instruction", ""))

    def attach_words(self, batch: dict, tokenizer, text_by_idx: dict) -> dict:
        """The trajectory arrays of a ``NavEpisodeBatcher`` teacher batch
        and its (B, max_words+1) word ids (by the batch's inst_idx)."""
        texts = [text_by_idx[i] for i in batch["inst_idx"]]
        out = {k: np.asarray(batch[k]) for k in TRAJ_KEYS}
        out["words"] = self.words_batch(tokenizer, texts)
        return out

    def words_batch(self, tokenizer, texts: list[str]) -> np.ndarray:
        """Texts as (B, max_words+1) ids: [BOS] w... [EOS] [PAD]..."""
        out = np.full((len(texts), self.max_words + 1), self.pad_id, np.int32)
        for i, text in enumerate(texts):
            ids = tokenizer.encode(text)[: self.max_words - 1]
            row = [self.bos_id] + ids + [self.eos_id]
            out[i, : len(row)] = row
        return out

    def decode_words(self, tokenizer, ids) -> list[str]:
        """Ids -> text (specials stripped, wordpieces merged)."""
        texts = []
        stop = {self.bos_id, self.eos_id, self.pad_id}
        for row in np.asarray(ids):
            toks = tokenizer.convert_ids_to_tokens([int(i) for i in row if int(i) not in stop])
            words: list[str] = []
            for tk in toks:
                if tk.startswith("##") and words:
                    words[-1] += tk[2:]
                else:
                    words.append(tk)
            texts.append(" ".join(words))
        return texts

    def sample_walks(self, rng: np.random.Generator, n: int, min_hops: int = 2,
                     max_hops: int = 6) -> dict:
        """``n`` random shortest-path walks over the nav graphs: scans,
        start rows and views, goal rows and start headings."""
        rt = self.runtime
        scans = sorted(rt.graphs)
        recs = {"scans": [], "start_rows": [], "start_views": [], "goal_rows": [],
                "headings": []}
        attempts = 0
        max_attempts = max(1000, 200 * n)
        while len(recs["scans"]) < n:
            attempts += 1
            if attempts > max_attempts:
                raise RuntimeError(
                    f"sample_walks: no viewpoint pairs with hops in [{min_hops}, {max_hops}] "
                    f"after {attempts} attempts ({len(recs['scans'])}/{n} found): widen "
                    "the hop range")
            scan = scans[rng.integers(len(scans))]
            g = rt.graphs[scan]
            off = rt.feat_table.scan_offsets[scan]
            u, v = rng.integers(g.num_viewpoints, size=2)
            if u == v or not np.isfinite(g.dist[u, v]):
                continue
            hops = len(g.shortest_path(int(u), int(v))) - 1
            if not min_hops <= hops <= max_hops:
                continue
            heading = float(rng.uniform(0, 2 * np.pi))
            recs["scans"].append(scan)
            recs["start_rows"].append(off + int(u))
            recs["start_views"].append(
                geo.view_of(geo.snap_heading(heading), geo.snap_elevation(0.0)))
            recs["goal_rows"].append(off + int(v))
            recs["headings"].append(heading)
        return recs

    def walk_arrays(self, walks: dict) -> dict:
        """The teacher arrays (cur_row, view, teacher, active) of
        ``sample_walks``' walks over ``episode_len`` steps."""
        return self.runtime.teacher_rollout_arrays(
            walks["scans"], np.asarray(walks["start_rows"], np.int32),
            np.asarray(walks["start_views"], np.int32),
            np.asarray(walks["goal_rows"], np.int32), self.episode_len)

    def augment(self, params, tokenizer, rng: np.random.Generator, n: int,
                batch_size: int = 32, min_hops: int = 2, max_hops: int = 6,
                prefix: str = "AUG", temperature: float = 0.0,
                keep_fraction: float | None = None,
                target_vocab: list[str] | None = None) -> list[dict]:
        """R2R-format augmentation records of sampled walks, captioned at
        ``temperature`` (0: greedy).

        ``keep_fraction`` in (0, 1] gates quality: ``n / keep_fraction``
        candidates, each self-scored by ``caption_ce_fn``, of which the
        ``n`` lowest are kept, with a ``speaker_ce`` field.
        ``target_vocab`` stamps each record with a sampled ``target`` word,
        so that ``build_aug_instances`` builds the NDH sequence format."""
        gen = self.generate_fn(temperature)
        score = self.caption_ce_fn() if keep_fraction is not None else None
        target = n if keep_fraction is None else int(np.ceil(n / keep_fraction))
        rt = self.runtime
        records = []
        empty_rounds = 0
        while len(records) < target:
            if empty_rounds >= 5:
                raise RuntimeError(
                    f"augment: speaker produced empty captions for 5 consecutive batches "
                    f"({len(records)}/{target} records): the checkpoint likely decodes "
                    "EOS immediately; train longer or raise --aug_temperature")
            # Whole batches, and one seed a batch at every temperature: the
            # JAX package's draws from ``rng``, so the same walks follow.
            walks = self.sample_walks(rng, batch_size, min_hops, max_hops)
            arrays = self.walk_arrays(walks)
            seed = int(rng.integers(2 ** 31))
            generator = None
            if temperature > 0.0:
                generator = torch.Generator(device=self.device).manual_seed(seed)
            batch = self.device_batch(arrays)
            ids = gen(params, batch, generator).cpu().numpy()
            self.readbacks += 1
            texts = self.decode_words(tokenizer, ids)
            ces = None
            if score is not None:
                batch["words"] = self._index(self.words_batch(tokenizer, texts))
                ces = score(params, batch).cpu().numpy()
                self.readbacks += 1
            before = len(records)
            for i, text in enumerate(texts):
                if len(records) >= target:
                    break
                if not text:
                    continue
                # The visited path, from the teacher arrays.
                rows = [int(arrays["cur_row"][i, 0])]
                for t in range(1, self.episode_len):
                    if not arrays["active"][i, t]:
                        break
                    r = int(arrays["cur_row"][i, t])
                    if r != rows[-1]:
                        rows.append(r)
                rec = {"scan": walks["scans"][i],
                       "path": [rt.row_to_id(r)[1] for r in rows],
                       "heading": walks["headings"][i],
                       "path_id": f"{prefix}_{len(records)}",
                       "instructions": [text]}
                if ces is not None:
                    rec["speaker_ce"] = float(ces[i])
                if target_vocab is not None:
                    rec["target"] = str(rng.choice(target_vocab))
                records.append(rec)
            empty_rounds = empty_rounds + 1 if len(records) == before else 0
        if keep_fraction is not None:
            records = sorted(records, key=lambda r: r["speaker_ce"])[:n]
            for k, rec in enumerate(records):
                rec["path_id"] = f"{prefix}_{k}"
        return records


def write_aug_records(records: list[dict], path: str) -> None:
    with open(path, "w") as f:
        json.dump(records, f)


def build_aug_instances(path: str, tokenizer, max_seq_length: int = 512,
                        oscar_setting: bool = False, tar_back: bool = False) -> list:
    """Speaker-generated R2R-format records as NavInstances (appended to the
    fine-tuning instances by ``--aug_data``).  A record with a ``target``
    gets the NDH sequence format (the [TAR] span and the caption as a
    dialog turn); one without keeps the bare R2R format."""
    from visitron_torch.data.datasets import NavInstance
    from visitron_torch.data.dialog import MAX_TARGET_LENGTH, build_dialog_sequence

    with open(path) as f:
        records = json.load(f)
    out = []
    for item in records:
        tgt = item.get("target")
        target_tokens = tokenizer.tokenize(tgt)[:MAX_TARGET_LENGTH] if tgt else None
        for j, instr in enumerate(item["instructions"]):
            seq = build_dialog_sequence(
                tokenizer, [tokenizer.tokenize(instr)], target_tokens=target_tokens,
                oscar_setting=oscar_setting, tar_back=tar_back,
                max_seq_length=max_seq_length)
            p = list(item["path"])
            out.append(NavInstance(
                inst_idx=f"{item['path_id']}_{j}", scan=item["scan"],
                token_ids=seq.token_ids, segment_ids=seq.segment_ids, length=seq.length,
                start_pano={"heading": item["heading"], "elevation": 0, "pano": p[0]},
                planner_path=p, player_path=p, trusted_path=p, end_panos=[p[-1]],
                raw=item))
    return out
