"""The multimodal pretraining model in plain PyTorch (Oscar's PreTrainOscar
with VisitronBert's region embeddings): the joint text + region sequence,
BERT, the MLM head tied to the word embeddings, the next-action head on the
pooled [CLS] and the region-token head; the loss is the sum of the three
mean cross entropies over their labels (label -1 ignored).  Imports nothing
of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from h100bench.reference.core import (Prec, Streams, bert, bert_plan, drop, key_bias, layer_norm,
                                      text_embeddings)


def _ce_sum(logits, labels):
    valid = labels != -1
    ce = F.cross_entropy(logits.flatten(0, -2), torch.where(valid, labels, 0).flatten(),
                         reduction="none")
    return (ce * valid.flatten()).sum()


def loss_grads(P, batch: dict, cfg: dict, seed, prec: Prec, block: int,
               streams: Streams | None = None):
    """(loss, grads) of one step on a host batch (the trainer's layout) with
    every dropout the program applies (``seed``: the trainer's; None: none;
    ``streams``: the draws of the steps so far), in blocks of ``block``
    rows."""
    device = P["bert.word_embeddings.weight"].device
    b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    ids, types = b["input_ids"].long(), b["token_type_ids"].long()
    n, text = ids.shape
    img = b["img_feats"].shape[1]
    s = text + img
    labels, tokens = b["labels"][:, :s].long(), b["token_labels"][:, :s].long()
    nxt = b["next_action"].long()
    counts = [max(1, int((x != -1).sum())) for x in (labels, nxt, tokens)]
    st = streams or Streams(seed, device)
    plan = bert_plan(st, n, s, cfg, text=text, img=img)
    leaves = {k: v.detach().requires_grad_() for k, v in P.items()}
    grads = {k: torch.zeros_like(v) for k, v in P.items()}
    p, eps = cfg["hidden_dropout_prob"], cfg["layer_norm_eps"]
    total = 0.0
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        L = leaves
        t_emb = text_embeddings(L, "bert.", ids[lo:hi], types[lo:hi], plan, lo, hi, cfg)
        i_emb = (prec.linear(b["img_feats"][lo:hi], L["bert.img_embedding.weight"],
                             L["bert.img_embedding.bias"])
                 + prec.linear(b["img_location_embeddings"][lo:hi],
                               L["bert.location_embeds.weight"], L["bert.location_embeds.bias"]))
        i_emb = drop(i_emb, plan["img"][lo:hi] if plan["img"] is not None else None, p)
        seq = bert(L, "bert.", torch.cat([t_emb, i_emb], 1),
                   key_bias(b["attention_mask"][lo:hi] > 0), plan, lo, hi, cfg, prec)
        pooled = torch.tanh(prec.linear(seq[:, 0], L["bert.pooler.dense.weight"],
                                        L["bert.pooler.dense.bias"]))
        x = F.gelu(prec.linear(seq, L["mlm_transform.weight"], L["mlm_transform.bias"]))
        x = layer_norm(x, L["mlm_layer_norm.weight"], L["mlm_layer_norm.bias"], eps)
        mlm = prec.linear(x, L["bert.word_embeddings.weight"]) + L["mlm_bias"]
        act = prec.linear(pooled, L["next_action.weight"], L["next_action.bias"])
        tok = prec.linear(seq, L["token_head.weight"], L["token_head.bias"])
        loss = (_ce_sum(mlm, labels[lo:hi]) / counts[0] + _ce_sum(act, nxt[lo:hi]) / counts[1]
                + _ce_sum(tok, tokens[lo:hi]) / counts[2])
        got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        for k, g in zip(leaves, got):
            if g is not None:
                grads[k] += g
        total += float(loss.detach())
    return total, grads
