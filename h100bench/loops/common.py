"""What the loops share: seeds, the clock, the program's NDH world and agent
built from the benchmark's inputs, parameters handed to both sides, and the
record a run fills for the metric readers."""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from h100bench import params, world as inputs


def derive(seed: int, name: str) -> int:
    """A seed in [0, 2**31) for one named use of the run's seed."""
    return int(inputs.stream(seed, "seed/" + name).integers(2 ** 31))


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@dataclass
class Record:
    """What one run measured, for the metric readers and the result line."""
    loop: str
    setup_s: float = 0.0
    setup_stages: dict = field(default_factory=dict)
    window_s: float = 0.0
    work: dict = field(default_factory=dict)  # units completed in the window
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    # The traced run: a stretch of steps without the profiler, then the same
    # steps under it.
    trace: object = None
    traced_wall_s: float = 0.0  # the stretch's wall, profiler off
    traced_flops: float = 0.0  # model FLOPs of the stretch
    traced_launches: dict = field(default_factory=dict)  # kernel -> (ops, bytes) list
    readings: dict = field(default_factory=dict)
    limits: dict = field(default_factory=dict)
    reference_s: float = 0.0  # the comparison's seconds, after the window
    correct: bool = False


class Stages:
    """Set-up seconds by stage, on the host clock, each up to a device sync."""

    def __init__(self, device, t_start: float):
        self.device, self.t_start = device, t_start
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def done(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def total(self) -> float:
        return time.perf_counter() - self.t_start


def ndh_world(config: dict, traffic: dict, seed: int, device):
    """(world, scene table): the graphs from ``seed`` and the table drawn on
    ``device`` in the served dtype."""
    w = traffic["world"]
    world = inputs.World(derive(seed, "world"), w["scans"], w["viewpoints_per_scan"],
                         w.get("mean_degree", 3.0))
    table = inputs.scene_table(derive(seed, "table"), world.num_rows,
                               config["agent"]["feature_dim"], device,
                               dtype_of(config["dtype"]))
    return world, table


def episodes(world, traffic: dict, seed: int, name: str, n: int) -> list:
    d = traffic["dialog"]
    return world.episodes(derive(seed, name), name, n, tuple(d["turns"]), tuple(d["words"]),
                          tuple(traffic["path_nodes"]), traffic.get("max_seq_length", 512))


def ndh_program(config: dict, traffic: dict, world, table, agent_seed: int, device,
                episode_len: int):
    """The program's runtime and agent over the benchmark's world: its
    graphs from the connectivity records, the scene table as the runtime's
    feature table (already on the device, in the served dtype)."""
    from visitron_torch.agents import NavRuntime, ViewpointAgent
    from visitron_torch.data.features import SceneFeatureTable
    from visitron_torch.graph import NavGraph
    from visitron_torch.models import BertConfig

    graphs, row_index, offsets = {}, {}, {}
    for si, sc in enumerate(world.scans):
        graphs[sc.name] = NavGraph.from_connectivity(sc.name, sc.connectivity())
        if graphs[sc.name].viewpoints != sc.viewpoints:
            raise RuntimeError(f"scan {sc.name}: the program reordered its viewpoints")
        offsets[sc.name] = int(world.offsets[si])
        for i, vp in enumerate(sc.viewpoints):
            row_index[f"{sc.name}_{vp}"] = int(world.offsets[si]) + i
    feat_table = SceneFeatureTable(table=table, row_index=row_index, scan_offsets=offsets)
    dt = dtype_of(config["dtype"])
    agent_cfg = config["agent"]
    runtime = NavRuntime.build(graphs, feat_table, max_candidates=agent_cfg["max_candidates"],
                               device_dtype=dt, device=device)
    bert = BertConfig(dtype=dt, **config["bert"])
    opt = config["optimizer"]
    agent = ViewpointAgent(bert, runtime, feature_dim=agent_cfg["feature_dim"],
                           episode_len=episode_len, angle_feat_size=agent_cfg["angle_feat_size"],
                           aemb=agent_cfg["aemb"], rnn_dim=agent_cfg["rnn_dim"],
                           encoder_hidden_size=agent_cfg["encoder_hidden_size"],
                           dropout=agent_cfg["dropout"], learning_rate=opt["learning_rate"],
                           optimizer_kind=opt["kind"], max_grad_norm=opt["max_grad_norm"],
                           seed=agent_seed, device=device)
    return runtime, agent


def nav_instances(world, eps: list) -> list:
    """The episodes as the program's NavInstance records (path: planner)."""
    from visitron_torch.data.datasets import NavInstance

    out = []
    for e in eps:
        sc = world.scans[e.scan]
        path = [sc.viewpoints[i] for i in e.path]
        out.append(NavInstance(inst_idx=e.idx, scan=sc.name, token_ids=e.token_ids,
                               segment_ids=e.segment_ids, length=e.length,
                               start_pano={"heading": e.heading, "elevation": 0.0,
                                           "pano": path[0]},
                               planner_path=path, player_path=path, trusted_path=path,
                               end_panos=[path[-1]]))
    return out


def weights(shapes: dict, seed: int, device) -> dict:
    """The initial weights of ``shapes`` (reference/layout.py) from the seed."""
    return params.make(shapes, derive(seed, "params"), device)


def adam_moment(opt_state, key: str = "mu"):
    """The first Adam state in an optimizer state (a chain's list of states)."""
    for s in opt_state:
        if isinstance(s, dict) and key in s:
            return s[key]
    raise KeyError(f"no Adam {key} in the optimizer state")


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if torch.device(device).type == "cuda" else 0


def leaves_minus(a: dict, b: dict) -> dict:
    return {k: a[k].float() - b[k].float() for k in a}


def sample(rng_seed: int, n: int, k: int, must: list) -> list:
    """``k`` distinct indices of ``n`` drawn from the seed, with ``must``."""
    rng = np.random.default_rng(rng_seed)
    rest = [i for i in rng.permutation(n).tolist() if i not in must]
    return sorted(set(must) | set(rest[:max(0, k - len(set(must)))]))
