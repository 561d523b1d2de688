"""Tiny versions of the cells for the CPU tests: the same code at widths a
test run holds (BERT 2 x 128, head dim 64, so the fused-attention path is
taken; a 3-scan world)."""

from __future__ import annotations

import copy

import numpy as np
import torch

from h100bench import spec, world as inputs


# The NDH cells' files, which no BENCHMARK.json entry runs yet.
NDH = {"ndh_train.mp3d.b128.t10": "visitron-ndh", "ndh_eval.mp3d.b256.t40": "visitron-ndh"}


def cell(name: str) -> dict:
    bench = spec.load_benchmark()
    if name in NDH:
        entry = {"name": name, "config": NDH[name], "traffic": name, "chips": 1}
        c = copy.deepcopy(spec.assemble(entry, bench))
    else:
        c = copy.deepcopy(spec.cell(name, bench))
    c["config"]["bert"].update(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                               intermediate_size=256)
    t = c["traffic"]
    if "agent" in c["config"]:
        c["config"]["agent"].update(feature_dim=32, rnn_dim=32, encoder_hidden_size=32, aemb=8)
    if "world" in t:
        t["world"].update(scans=3, viewpoints_per_scan=12)
        t.update(instances=48, batch=8, dialog={"turns": [2, 3], "words": [5, 12]},
                 path_nodes=[3, 5], reference_block=3)
        t["episode_len"] = 4 if t["loop"] == "ndh_train" else 6
        if "sample" in t:
            t["sample"] = 8
    else:
        t.update(batch=4, text=128, img=128, pool=3, text_len=[40, 128], regions=[60, 128],
                 reference_block=3)
    return c


def complete_graphs(monkeypatch, viewpoints: int, cell_: dict) -> None:
    """Make every scan a complete graph of ``viewpoints`` viewpoints, each
    with viewpoints - 1 neighbours, and paths of one hop."""
    make = inputs.make_scan

    def complete(rng, name, n, mean_degree):
        sc = make(rng, name, n, mean_degree)
        sc.adjacency = ~np.eye(n, dtype=bool)
        sc.dist, sc.pred = inputs.shortest_paths(sc.positions, sc.adjacency)
        return sc

    monkeypatch.setattr(inputs, "make_scan", complete)
    cell_["traffic"]["world"]["viewpoints_per_scan"] = viewpoints
    cell_["traffic"]["path_nodes"] = [2, 2]


def mend_stop_slot(monkeypatch) -> None:
    """The program's stop slot (slot ``count``) zeroed, as the published
    agent's is: the program's mend that the NDH cells wait for, in the test
    alone."""
    from visitron_torch.agents import viewpoint

    raw = viewpoint.gather_step_inputs

    def mended(rt, cur_row, view):
        a_t, f_t, cand, mask = raw(rt, cur_row, view)
        k = torch.arange(cand.shape[1], device=cand.device)[None, :]
        stop = (k == rt.count[cur_row][:, None])[..., None]
        return a_t, f_t, cand.masked_fill(stop, 0), mask

    monkeypatch.setattr(viewpoint, "gather_step_inputs", mended)
