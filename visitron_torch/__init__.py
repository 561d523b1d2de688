"""VISITRON in PyTorch for NVIDIA Hopper: a port of ``visitron_tpu``.

The port covers the NDH serving rollout
(``agents.ViewpointAgent.test``), the NDH fine-tuning train steps,
teacher-forced, student-forced and RL (``agents.ViewpointAgent``), the
multimodal pretraining train step (``train.PretrainTrainer``), and the
``python -m visitron_torch.run`` CLI with its trainers and checkpoints
(``train.finetune``, ``train.pretrain``), data, tensor, sequence, context
and pipeline parallel across processes over NCCL (``parallel``), with
hand-written CUDA kernels for the fused attention in its packed and
(B, H, S, D) layouts and the flash attention (``ops.attention``), the fused
add+LayerNorm (``ops.layernorm``) and the fused masked softmax
cross-entropy (``ops.crossentropy``), forward and backward.  The package
imports torch, numpy and scipy, and nothing of JAX.
"""
