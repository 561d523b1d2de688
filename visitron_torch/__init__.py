"""VISITRON in PyTorch for NVIDIA Hopper: a port of ``visitron_tpu``.

So far the port covers the NDH argmax serving rollout
(``agents.ViewpointAgent.test``) with hand-written CUDA kernels for the
packed fused attention forward (``ops.attention``) and the fused
add+LayerNorm forward (``ops.layernorm``).  The package imports torch, numpy
and scipy, and nothing of JAX.
"""
