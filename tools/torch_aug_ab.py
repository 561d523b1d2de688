"""Back-translation augmentation efficacy A/B of the PyTorch port on the card
(tools/aug_ab.py's counterpart; visitron_torch/testing/aug_ab.py).

Trains a speaker on a ``directional_language`` synthetic world, captions
sampled shortest-path walks into R2R-format records, fine-tunes a fresh
follower under the same iteration budget with and without them, and scores
GP/SR/SPL/nDTW on held-out episodes.  Prints one JSON line per evaluation
with the JAX tool's tags, the A/B result last, then the fidelity of the
captions rotated one walk on (``control``: what a speaker blind to its
trajectory scores) and the host seconds of each stage.

Usage: python tools/torch_aug_ab.py [--iters 800] [--n-aug 300] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=800)
    ap.add_argument("--speaker-iters", type=int, default=600)
    ap.add_argument("--n-aug", type=int, default=300)
    ap.add_argument("--train-episodes", type=int, default=150)
    ap.add_argument("--val-episodes", type=int, default=64)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--episode-len", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--keep-frac", type=float, default=0.0,
                    help="speaker-CE quality gate: over-generate 1/frac "
                         "candidates, keep the best n (0 = no gate)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="caption sampling temperature (0 = greedy)")
    ap.add_argument("--arms", default="baseline,aug",
                    help="comma list of arms: baseline (train only), aug (train + "
                         "aug), aug_only (aug records alone: a caption-faithfulness "
                         "probe), real_only (n-aug fresh real episodes alone: the "
                         "probe's ceiling)")
    ap.add_argument("--targets", action="store_true",
                    help="stamp aug records with sampled targets so they get the NDH "
                         "sequence format ([TAR] span)")
    ap.add_argument("--oracle-captions", action="store_true",
                    help="caption the sampled walks with the world's own directional "
                         "sentence instead of the speaker (skips speaker training)")
    ap.add_argument("--aug-seed", type=int, default=3,
                    help="seed of walk sampling and caption generation")
    ap.add_argument("--feat-dropout", type=float, default=0.0,
                    help="speaker feature dropout on the visual dims")
    ap.add_argument("--movement-frame", action="store_true",
                    help="speaker action-angle features in the turn-delta frame")
    ap.add_argument("--seed", type=int, default=88,
                    help="training seed: agent/speaker init and batcher shuffles (the "
                         "world stays seed 13)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card, which must be present)")
    args = ap.parse_args()

    from visitron_torch.testing import aug_ab

    out = aug_ab.run(iters=args.iters, speaker_iters=args.speaker_iters, n_aug=args.n_aug,
                      train_episodes=args.train_episodes, val_episodes=args.val_episodes,
                      batch=args.batch, episode_len=args.episode_len, seq=args.seq,
                      keep_frac=args.keep_frac, temperature=args.temperature, arms=args.arms,
                      targets=args.targets, oracle_captions=args.oracle_captions,
                      aug_seed=args.aug_seed, feat_dropout=args.feat_dropout,
                      movement_frame=args.movement_frame, seed=args.seed,
                      device="cpu" if args.cpu else None,
                      log=lambda line: print(line, flush=True))
    # Not lines of the JAX tool's: the fidelity of the same records with their
    # captions rotated one walk on (the control), and the host seconds of each
    # stage.
    print(json.dumps({"tag": "control", **out["control"]}), flush=True)
    print(json.dumps({"tag": "seconds", **{k: round(v, 2) for k, v in out["seconds"].items()},
                      "total": round(sum(out["seconds"].values()), 2)}), flush=True)


if __name__ == "__main__":
    main()
