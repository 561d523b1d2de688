"""Training pieces of the port: the optimizers (optim.py) and the
pretraining trainer (pretrain.py)."""

from visitron_torch.train.optim import adamw_with_warmup, agent_optimizer, make_schedule
from visitron_torch.train.pretrain import PretrainTrainer

__all__ = ["adamw_with_warmup", "agent_optimizer", "make_schedule", "PretrainTrainer"]
