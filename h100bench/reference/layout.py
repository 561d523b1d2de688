"""The parameters of each configuration, by name and shape, in the order
the weights are drawn: the flax-compatible names the program's modules
carry (their ``named_parameters``), written out from the configuration."""

from __future__ import annotations


def bert_shapes(cfg: dict, pre: str, image: bool) -> dict:
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    out = {f"{pre}word_embeddings.weight": (cfg["vocab_size"], h),
           f"{pre}embeddings.position_embeddings.weight": (cfg["max_position_embeddings"], h),
           f"{pre}embeddings.token_type_embeddings.weight": (cfg["type_vocab_size"], h),
           f"{pre}embeddings.layer_norm.weight": (h,),
           f"{pre}embeddings.layer_norm.bias": (h,)}
    for i in range(cfg["num_hidden_layers"]):
        L = f"{pre}encoder.layer_{i}."
        for name, (o, n) in (("attention.qkv", (3 * h, h)), ("attention_output", (h, h)),
                             ("attention_layer_norm", (h, None)), ("intermediate", (inter, h)),
                             ("output", (h, inter)), ("output_layer_norm", (h, None))):
            if n is not None:
                out[f"{L}{name}.weight"] = (o, n)
            else:
                out[f"{L}{name}.weight"] = (o,)
            out[f"{L}{name}.bias"] = (o,)
    out[f"{pre}pooler.dense.weight"] = (h, h)
    out[f"{pre}pooler.dense.bias"] = (h,)
    if image:
        out[f"{pre}img_embedding.weight"] = (h, cfg["img_feature_dim"])
        out[f"{pre}img_embedding.bias"] = (h,)
        out[f"{pre}location_embeds.weight"] = (h, 128)
        out[f"{pre}location_embeds.bias"] = (h,)
    return out


def ndh_shapes(config: dict) -> dict:
    """{"encoder/...": shape, "decoder/...": shape}: OscarEncoder (BERT text
    model, LSTM, the decoder's initial-state projection) and AttnDecoderLSTM."""
    a, h = config["agent"], config["bert"]["hidden_size"]
    enc, rnn, emb = a["encoder_hidden_size"], a["rnn_dim"], a["aemb"]
    feat = a["feature_dim"] + a["angle_feat_size"]
    out = {f"encoder/{k}": v for k, v in bert_shapes(config["bert"], "bert.bert.", False).items()}
    out.update({"encoder/lstm.fwd.wi": (4 * enc, h), "encoder/lstm.fwd.wh": (4 * enc, enc),
                "encoder/lstm.fwd.bi": (4 * enc,), "encoder/lstm.fwd.bh": (4 * enc,),
                "encoder/encoder_lstm2decoder_ht.weight": (rnn, enc),
                "encoder/encoder_lstm2decoder_ht.bias": (rnn,),
                "decoder/embedding.weight": (emb, a["angle_feat_size"]),
                "decoder/embedding.bias": (emb,),
                "decoder/feat_att_layer.linear_in.weight": (feat, rnn),
                "decoder/lstm.wi": (4 * rnn, emb + feat), "decoder/lstm.wh": (4 * rnn, rnn),
                "decoder/lstm.bi": (4 * rnn,), "decoder/lstm.bh": (4 * rnn,),
                "decoder/attention_layer.linear_in.weight": (enc, rnn),
                "decoder/attention_layer.linear_out.weight": (rnn, enc + rnn),
                "decoder/candidate_att_layer.linear_in.weight": (feat, rnn)})
    return out


def pretrain_shapes(config: dict) -> dict:
    """PretrainModel: the MLM bias, VisitronBert with its region projections,
    the MLM transform and LayerNorm, the next-action and region-token heads."""
    c = config["bert"]
    h = c["hidden_size"]
    out = {"mlm_bias": (c["vocab_size"],)}
    out.update(bert_shapes(c, "bert.", True))
    out.update({"mlm_transform.weight": (h, h), "mlm_transform.bias": (h,),
                "mlm_layer_norm.weight": (h,), "mlm_layer_norm.bias": (h,),
                "next_action.weight": (c["action_space"], h), "next_action.bias": (c["action_space"],),
                "token_head.weight": (c["detector_classes"], h),
                "token_head.bias": (c["detector_classes"],)})
    return out
