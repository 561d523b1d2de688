"""End-to-end science run of the PyTorch port on the card
(tools/synthetic_e2e.py's counterpart; visitron_torch/testing/science.py).

Trains the viewpoint-selection agent (BERT-base dialog encoder, 2048-d scene
features) on synthetic NDH episodes and reports Goal Progress / Success Rate
on its training episodes before and after training (overfit check): the
train -> argmax rollout -> Evaluator loop at reference model scale.  Prints
one JSON line per evaluation and the loss every 50 steps.

Usage: python tools/torch_synthetic_e2e.py [--iters 300] [--batch 32]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--episodes", type=int, default=200)
    ap.add_argument("--seq", type=int, default=512)
    # Reference-default workload: --episode-len 40 --path-type trusted_path.
    ap.add_argument("--episode-len", type=int, default=10)
    ap.add_argument("--path-type", default="planner_path",
                    choices=["planner_path", "player_path", "trusted_path"])
    ap.add_argument("--remat", action="store_true",
                    help="layer-wise rematerialization (fit longer episodes)")
    args = ap.parse_args()

    from visitron_torch.testing import science

    science.run(iters=args.iters, log=lambda line: print(line, flush=True),
                batch=args.batch, episodes=args.episodes, seq=args.seq,
                episode_len=args.episode_len, path_type=args.path_type, remat=args.remat)


if __name__ == "__main__":
    main()
