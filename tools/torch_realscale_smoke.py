"""Real-Matterport-scale residency smoke of the PyTorch port on the card
(tools/realscale_smoke.py's counterpart; visitron_torch/testing/realscale.py).

Builds a synthetic world with Matterport's statistics (90 scans x 120
viewpoints = 10,800 viewpoints x 36 views x 2048-d), packs its scene table
as bfloat16 on the host (1,592,524,800 bytes, page-locked), places it on the
card with the candidate and next-hop tables, and runs two BERT-base train
steps (bf16, batch 64) at T 10 on planner_path and at T 40 on trusted_path,
printing the losses and the card's memory.  Success = finite losses at both
shapes with the whole world resident.

Usage: python tools/torch_realscale_smoke.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    from visitron_torch.testing import realscale

    realscale.run(log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
