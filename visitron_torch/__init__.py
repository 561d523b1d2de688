"""VISITRON in PyTorch for NVIDIA Hopper: a port of ``visitron_tpu``.

So far the port covers the NDH argmax serving rollout
(``agents.ViewpointAgent.test``), the NDH teacher-forced fine-tuning train
step (``agents.ViewpointAgent.train_step_fn`` with ``train.optim``) and the
multimodal pretraining train step (``train.PretrainTrainer``), with
hand-written CUDA kernels for the fused attention in its packed and
(B, H, S, D) layouts (``ops.attention``), the fused add+LayerNorm
(``ops.layernorm``) and the fused masked softmax cross-entropy
(``ops.crossentropy``), forward and backward.  The package imports torch, numpy and scipy, and nothing of
JAX.
"""
