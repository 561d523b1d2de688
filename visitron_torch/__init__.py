"""VISITRON in PyTorch for NVIDIA Hopper: a port of ``visitron_tpu``.

So far the port covers the NDH argmax serving rollout
(``agents.ViewpointAgent.test``) and the NDH teacher-forced fine-tuning
train step (``agents.ViewpointAgent.train_step_fn`` with ``train.optim``),
with hand-written CUDA kernels for the packed fused attention
(``ops.attention``) and the fused add+LayerNorm (``ops.layernorm``), forward
and backward.  The package imports torch, numpy and scipy, and nothing of
JAX.
"""
