"""The value head of RL fine-tuning (visitron_tpu/models/speaker.py:Critic;
the reference's present-but-unwired module, agent_models.py:632-643): a
decoder state to a value estimate.  The speaker encoder and decoder are not
ported yet.

Its parameters come from its Dense layers' ``initial_params`` through
``layers.init_module_params``, as for the other modules.
"""

from __future__ import annotations

import torch
from torch import nn

from visitron_torch.models.layers import Dense, DropoutRng, maybe_drop


class Critic(nn.Module):
    def __init__(self, hidden_size: int = 512, dropout_ratio: float = 0.5):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.dense_0 = Dense(hidden_size, hidden_size)
        self.dense_1 = Dense(hidden_size, 1)

    def forward(self, state: torch.Tensor, rng: DropoutRng | None = None) -> torch.Tensor:
        """state: (B, hidden) -> value (B,).  ``rng`` turns the dropout on."""
        x = torch.relu(self.dense_0(state))
        x = maybe_drop(x, self.dropout_ratio, rng)
        return self.dense_1(x)[..., 0]
