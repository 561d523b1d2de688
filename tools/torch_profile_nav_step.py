"""Profile the production-scale NDH train step of the PyTorch port on the card
and summarize its device time (tools/profile_nav_step.py's counterpart;
visitron_torch/testing/nav_profile.py).

Runs the exact bench.py train step (BERT-base dialog encode + 10-step
decode + full backward and Adam, batch 64, S 512) once warm, then 3 steps
under torch.profiler, and prints one JSON object: ms a step (host clock,
profiler included), the device busy time and idle share a step, the CUDA
kernels' time a step by kind and the top 20 kernels by time.  Without a
CUDA kernel in the trace it fails.

Usage: python tools/torch_profile_nav_step.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import torch

    from visitron_torch.testing import nav_profile

    step, state, batch = nav_profile.build_step()
    summary, _ = nav_profile.profile_steps(step, state, batch)
    print(json.dumps({"device": torch.cuda.get_device_name(0), **summary}), flush=True)


if __name__ == "__main__":
    main()
