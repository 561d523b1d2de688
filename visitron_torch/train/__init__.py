"""Training pieces of the port: the optimizers (optim.py), the pretraining
trainer and loop (pretrain.py), the fine-tuning trainer (finetune.py), the
turn-based and classifier trainers (turn_based.py, classifier.py), the
checkpoint manager (checkpoint.py), the workspace (workspace.py), logging
(logging.py) and the preemption guard (preemption.py)."""

from visitron_torch.train.optim import adamw_with_warmup, agent_optimizer, make_schedule
from visitron_torch.train.pretrain import PretrainTrainer

__all__ = ["adamw_with_warmup", "agent_optimizer", "make_schedule", "PretrainTrainer"]
