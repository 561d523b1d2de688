"""Pretraining dataset: dialog+region sequences, dynamic masking, region feats
(visitron_tpu/data/pretrain_dataset.py).

PretrainDataset parity (tasks/viewpoint_select/data_loader_pretrain.py:52-712):
  * sequence = [CLS] (+target) dialog turns [SEP] region-tokens [SEP], padded;
  * region tokens: top-5 per view across 36 views, set-deduped, re-tokenized,
    last 179 kept (:520-536);
  * dynamic BERT masking 80/10/10 per epoch, with forced masking of region
    tokens under masked-token-prediction (:549-613);
  * image features: top-5 regions x 36 views (<=180), 128-d relative-view
    location embeddings, padded/truncated to ``max_img_seq_length`` (:615-693);
  * labels extended with -1 over image positions; next_action is the 1-in-36
    relative view label (:692-711).

Produces fixed-shape numpy batches.  The dataset draws from its numpy rng in
the JAX package's order, so one seed gives the same batches.  The region
tokens are joined through a Python ``set``, whose order is stable only within
one process.  The preprocessed-example cache (``cache_path``) tokenizes once
across epochs and runs, keyed by a fingerprint of what shapes the examples.
Multi-host epochs (``epoch_batches(host_id, num_hosts)``) take each host's
strided shard of one (seed, epoch) shuffle.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np

from visitron_torch import geometry as geo
from visitron_torch.data.dialog import MAX_TARGET_LENGTH, build_dialog_sequence

MAX_REGION_LABELS_LENGTH = 180 - 1


class _CacheUnpickler(pickle.Unpickler):
    """Reads the example cache, which holds dicts of numbers, strings and
    numpy arrays: any other class (a cache written by another package, say)
    is refused, so reading a cache never imports a module."""

    def find_class(self, module, name):
        if module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} has no place in the example cache")


@dataclass
class PretrainExample:
    inst_idx: str
    scan: str
    viewpoint: str
    current_view_index: int
    next_action: int
    token_ids: np.ndarray  # (S,) int32
    segment_ids: np.ndarray  # (S,) int32
    length: int
    token_classes: np.ndarray | None  # (S,) int32 detector class per token or -1


class PretrainDataset:
    def __init__(
        self,
        records: list[dict],
        tokenizer,
        region_store=None,
        detector_classes: list[str] | None = None,
        masked_token_prediction: bool = False,
        no_action_grounding: bool = False,
        mlm_probability: float = 0.15,
        max_seq_length: int = 512,
        max_img_seq_length: int = 256,
        regions_per_view: int = 5,
        region_feat_dim: int = 2054,
        oscar_setting: bool = False,
        tar_back: bool = False,
        truncate_dialog: bool = True,
        debug: bool = False,
        seed: int = 0,  # masking + shuffle determinism (self.seed kept for
                        # the epoch-keyed shuffle stream, see epoch_batches)
        cache_path: str | None = None,
    ):
        self.tokenizer = tokenizer
        self.region_store = region_store
        self.mtp = masked_token_prediction
        self.no_action_grounding = no_action_grounding
        self.mlm_probability = mlm_probability
        self.max_seq_length = max_seq_length
        self.max_img_seq_length = max_img_seq_length
        self.regions_per_view = regions_per_view
        self.region_feat_dim = region_feat_dim
        self.debug = debug
        self.rng = np.random.default_rng(seed)
        self.seed = seed
        self._epoch = 0  # epoch counter for the shuffle stream
        self.loc_embeddings = geo.all_viewpoint_loc_embeddings()  # (36, 36, 128)
        if self.mtp:
            if detector_classes is None:
                raise ValueError("masked_token_prediction needs detector_classes")
            self.class2id = {c: i for i, c in enumerate(detector_classes)}
        # Preprocessed-example cache (tokenize once across epochs AND runs;
        # check_and_load_preprocessed_data parity, utils_data.py:241-284).
        # The fingerprint ties the cache to everything that shapes examples.
        self._cache_meta = {
            "n": len(records),
            "first": records[0]["inst_idx"] if records else "",
            "last": records[-1]["inst_idx"] if records else "",
            "vocab": len(tokenizer),
            "max_seq_length": max_seq_length,
            "oscar_setting": oscar_setting, "tar_back": tar_back,
            "mtp": self.mtp, "regions_per_view": regions_per_view,
            "truncate_dialog": truncate_dialog, "debug": debug,
            "format": "visitron_torch",
        }
        self.examples = self._load_cache(cache_path) if cache_path else None
        if self.examples is None:
            self.examples = [
                self._preprocess(rec, oscar_setting, tar_back, truncate_dialog)
                for rec in records
            ]
            if cache_path:
                self._save_cache(cache_path)

    def _load_cache(self, path: str):
        """The cached examples, or None when there is no cache, it cannot be
        read, or its fingerprint differs (the examples are then rebuilt and
        the cache rewritten)."""
        if not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                payload = _CacheUnpickler(f).load()
        except (OSError, EOFError, pickle.UnpicklingError):
            return None
        if not isinstance(payload, dict) or payload.get("meta") != self._cache_meta:
            return None
        return [PretrainExample(**ex) for ex in payload["examples"]]

    def _save_cache(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"meta": self._cache_meta,
                         "examples": [vars(ex) for ex in self.examples]}, f, protocol=-1)
        os.replace(tmp, path)

    # -- static preprocessing (tokenize once; parity :99-234) ---------------
    def _region_tokens(self, scan: str, viewpoint: str) -> list[str]:
        labels: list[str] = []
        for view in range(geo.NUM_VIEWS):
            if self.debug:
                labels.extend(["wall"] * self.regions_per_view)
            else:
                key = f"{scan}_{viewpoint}_{view}".encode()
                labels.extend(self.region_store.get_region_tokens(key)[: self.regions_per_view])
        uniq = set(labels)
        text = " ".join(uniq)
        toks = self.tokenizer.tokenize(text)
        return toks[-MAX_REGION_LABELS_LENGTH:]

    def _preprocess(self, rec: dict, oscar_setting, tar_back, truncate_dialog) -> PretrainExample:
        dialog = rec["dialog_history"]
        if isinstance(dialog, str):  # R2R/R4R/RxR: one instruction turn
            turns = [self.tokenizer.tokenize(dialog)]
            target_tokens = None
        else:
            turns = [self.tokenizer.tokenize(t["message"]) for t in dialog]
            target_tokens = self.tokenizer.tokenize(rec["target"])[:MAX_TARGET_LENGTH]
        region_tokens = self._region_tokens(rec["scan"], rec["viewpoint"])
        seq = build_dialog_sequence(
            self.tokenizer,
            turns,
            target_tokens=target_tokens,
            oscar_setting=oscar_setting,
            tar_back=tar_back,
            max_seq_length=self.max_seq_length,
            region_tokens=region_tokens,
            truncate=truncate_dialog,
        )
        token_classes = None
        if self.mtp:
            token_classes = np.full(self.max_seq_length, -1, np.int32)
            # Region-token span tracked by construction (robust under
            # truncation of the sequence tail).
            start, end = seq.region_span
            for i, tokstr in enumerate(seq.tokens[start:end]):
                token_classes[start + i] = self.class2id.get(tokstr, -1)
        return PretrainExample(
            inst_idx=str(rec["inst_idx"]),
            scan=rec["scan"],
            viewpoint=rec["viewpoint"],
            current_view_index=int(rec["current_view_index"]),
            next_action=int(rec["target_rel_view_index"]),
            token_ids=seq.token_ids,
            segment_ids=seq.segment_ids,
            length=seq.length,
            token_classes=token_classes,
        )

    def __len__(self) -> int:
        return len(self.examples)

    # -- dynamic masking (parity :549-613) ----------------------------------
    def _mask_tokens(self, ids: np.ndarray, token_classes) -> tuple[np.ndarray, np.ndarray]:
        tk = self.tokenizer
        labels = ids.copy()
        special = np.isin(labels, tk.all_special_ids)
        pad = labels == tk.pad_token_id
        prob = np.full(labels.shape, self.mlm_probability)
        prob[special | pad] = 0.0
        masked = self.rng.random(labels.shape) < prob
        if self.mtp:
            region = token_classes != -1
            masked |= region
        inputs = ids.copy()
        labels[~masked] = -1
        if self.mtp:
            labels[region] = -1  # region tokens train the token head, not MLM
        replace = (self.rng.random(labels.shape) < 0.8) & masked
        inputs[replace] = tk.mask_token_id
        if self.mtp:
            replace |= region
            inputs[region] = tk.mask_token_id
        random_sel = (self.rng.random(labels.shape) < 0.5) & masked & ~replace
        inputs[random_sel] = self.rng.integers(0, len(tk), size=int(random_sel.sum()))
        return inputs, labels

    # -- image features (parity :615-693) ------------------------------------
    def _img_features(self, ex: PretrainExample) -> tuple[np.ndarray, np.ndarray, int]:
        feats = []
        views = []
        for view in range(geo.NUM_VIEWS):
            if self.debug:
                f = self.rng.random((self.regions_per_view, self.region_feat_dim), dtype=np.float32)
            else:
                key = f"{ex.scan}_{ex.viewpoint}_{view}".encode()
                f = np.asarray(self.region_store[key][: self.regions_per_view], np.float32)
            feats.append(f)
            views.extend([view] * f.shape[0])
        img = np.concatenate(feats, axis=0)
        loc = self.loc_embeddings[ex.current_view_index][np.asarray(views)]
        m = self.max_img_seq_length
        n = img.shape[0]
        if n > m:
            img, loc, n = img[-m:], loc[-m:], m
        elif n < m:
            img = np.concatenate([img, np.zeros((m - n, img.shape[1]), img.dtype)], 0)
            loc = np.concatenate([loc, np.zeros((m - n, loc.shape[1]), loc.dtype)], 0)
        return img, loc, n

    def batch(self, indices, bucket: int = 64) -> dict[str, np.ndarray]:
        """Assemble a fixed-shape training batch for the given example indices.

        The image sequence is length-bucketed: padded to the batch's max
        region count rounded up to a ``bucket`` multiple (<= max_img_seq_length)
        instead of always max_img_seq_length — masked positions are inert, so
        this is exact while cutting joint-encoder work (typical NDH panoramas
        carry 180 regions vs the 256 cap)."""
        exs = [self.examples[i] for i in indices]
        s, m = self.max_seq_length, self.max_img_seq_length
        b = len(exs)
        out = {
            "input_ids": np.zeros((b, s), np.int32),
            "token_type_ids": np.zeros((b, s), np.int32),
            "attention_mask": np.zeros((b, s + m), np.int32),
            "labels": np.full((b, s + m), -1, np.int32),
            "token_labels": np.full((b, s + m), -1, np.int32),
            "img_feats": np.zeros((b, m, self.region_feat_dim), np.float32),
            "img_location_embeddings": np.zeros((b, m, 128), np.float32),
            "next_action": np.zeros((b,), np.int32),
        }
        n_imgs = []
        feats = []
        for ex in exs:
            img, loc, n_img = self._img_features(ex)
            feats.append((img, loc))
            n_imgs.append(n_img)
        m_eff = min(m, -(-max(max(n_imgs), 1) // bucket) * bucket)
        if m_eff < m:
            m = m_eff
            for k in ["attention_mask", "labels", "token_labels"]:
                out[k] = out[k][:, : s + m]
            out["img_feats"] = out["img_feats"][:, :m]
            out["img_location_embeddings"] = out["img_location_embeddings"][:, :m]
        for i, ex in enumerate(exs):
            inputs, labels = self._mask_tokens(ex.token_ids, ex.token_classes)
            img, loc = feats[i][0][:m], feats[i][1][:m]
            n_img = min(n_imgs[i], m)
            out["input_ids"][i] = inputs
            out["token_type_ids"][i] = ex.segment_ids
            out["attention_mask"][i, : ex.length] = 1
            out["attention_mask"][i, s : s + n_img] = 1
            out["labels"][i, :s] = labels
            if self.mtp:
                out["token_labels"][i, :s] = ex.token_classes
            out["img_feats"][i] = img
            out["img_location_embeddings"][i] = loc
            out["next_action"][i] = -1 if self.no_action_grounding else ex.next_action
        return out

    def set_epoch(self, epoch: int) -> None:
        """Align the epoch-keyed shuffle stream after a resume, so resumed
        epochs iterate the same (seed, epoch) order an uninterrupted run
        would — without this the first post-resume epoch replays epoch 0's
        shuffle."""
        self._epoch = int(epoch)

    def epoch_batches(self, batch_size: int, shuffle: bool = True,
                      drop_last: bool = True, host_id: int = 0,
                      num_hosts: int = 1):
        """Epoch iterator over batches of ``batch_size``, the per-host batch.

        With ``num_hosts > 1`` every host derives the same global shuffle
        from the (seed, epoch) stream, takes its strided shard
        (DistributedSampler's) and yields the same number of batches,
        counted from the global example count, so no host waits in a step
        for another's extra batch."""
        order = np.arange(len(self.examples))
        if shuffle:
            # Epoch-keyed stream, not self.rng (which batch() consumes for
            # the masking, differently on each host): the order depends only
            # on (seed, epoch), so the hosts' shards stay complementary.
            np.random.default_rng((self.seed, self._epoch)).shuffle(order)
            self._epoch += 1
        if num_hosts > 1:
            order = order[host_id::num_hosts]
            end = (len(self.examples) // num_hosts) // batch_size * batch_size
        else:
            end = (len(order) // batch_size) * batch_size if drop_last else len(order)
        for i in range(0, end, batch_size):
            yield self.batch(order[i : i + batch_size])
