#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port (``visitron_torch``) on one card.

    python3 chip_smoke.py                  # on a machine with an H100
    python3 chip_smoke.py --cpu-rehearsal  # tiny sizes, plain twins, on the CPU

Phases, one or more lines each; any failure raises and exits non-zero:

  1. device   the card's name, count, and nvidia-smi's name and power limit
              (no CUDA device: the script fails);
  2. build    nvcc builds both kernels for sm_90a from visitron_torch/csrc
              (ptxas register/shared-memory lines, build seconds);
  3. K1       packed fused attention vs its plain twin at the serving shapes
              (B 64, S 256 and 512, 12 heads of 64, bf16 with padding), in
              fp32, and with hash dropout at rate 0.1; times of the kernel,
              the twin, torch's scaled_dot_product_attention as a yardstick
              (never called by the port), and the bound;
  4. K2       fused add+LayerNorm vs its plain twin (R = 64*256 and 64*512,
              H 768, bf16 and fp32, with and without a residual); times and
              F.layer_norm as the yardstick;
  5. serving  the NDH argmax serving rollout, ViewpointAgent.test, at BERT-base
              width and depth (bf16, batch 64, 10-step episodes, 2048-d
              features, rnn 512, random weights from a seed), with and without
              ``submit``; trajectories checked against the graph; kernel
              launch counts read around each run; fp32 agreement of the card
              with the CPU on a 2-item batch; ms per batch, episodes/s,
              actions/s, the time split (BERT / LSTM / decode loop), peak memory.

The line before the last is a JSON object listing each kernel with its
launches in the serving run, max error, and times; the last line is
``{"ok": true, "device": {...}}``.  A rehearsal prints neither.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from visitron_torch import _build
from visitron_torch import geometry as geo
from visitron_torch.agents import NavEpisodeBatcher, NavRuntime, ViewpointAgent
from visitron_torch.data import (SceneFeatureTable, WordPieceTokenizer,
                                 build_wordpiece_vocab)
from visitron_torch.data.datasets import build_nav_instances
from visitron_torch.models import BertConfig
from visitron_torch.models.lstm import masked_lstm_scan
from visitron_torch.ops.attention import (fused_attention_packed,
                                          fused_attention_packed_reference)
from visitron_torch.ops.layernorm import fused_add_layernorm, layernorm_reference
from visitron_torch.testing import SyntheticWorld
from visitron_torch.testing.synthetic import _TARGETS, _WORDS

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0
# Tolerances of kernel against plain twin.  bf16: both round the output (and
# the probabilities) to bf16 at different points, so a few bf16 ulps of the
# value; fp32: summation order only.
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}  # (atol, rtol)
AGREE_TOL = (1e-3, 1e-3)  # card vs CPU, fp32, whole model: (atol, rtol)
ATTN_SOURCE = ("visitron_torch/csrc/attention.cu",
               "visitron_tpu/ops/attention.py:705")
LN_SOURCE = ("visitron_torch/csrc/layernorm.cu",
             "visitron_tpu/ops/layernorm.py:95")

REHEARSAL = False


def say(msg: str) -> None:
    print(("[rehearsal, CPU, plain twins] " if REHEARSAL else "") + msg, flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol) -> float:
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    bad = diff > atol + rtol * want.float().abs()
    say(f"  {name}: max|err| {err:.3g} (tolerance {atol:g} + {rtol:g}*|ref|)"
        f"{'' if not bad.any() else f', {int(bad.sum())} values outside'}")
    if bad.any() or not torch.isfinite(got.float()).all():
        fail(f"{name}: kernel disagrees with its plain twin")
    return err


def sync() -> None:
    if not REHEARSAL:
        torch.cuda.synchronize()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call: CUDA events around ``iters`` calls after warm-up."""
    for _ in range(warmup):
        fn()
    if REHEARSAL:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def copies_for_cold_l2(nbytes: int) -> int:
    """Input sets to cycle through so that one pass exceeds the 50 MB L2."""
    return max(1, -(-200_000_000 // max(nbytes, 1)))


# -- phase 1 -------------------------------------------------------------------

def phase_device() -> dict:
    if REHEARSAL:
        say("device: cpu (nvidia-smi not run)")
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on an H100")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"device: {kind} (count {count}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    say(f"nvidia-smi: {smi}")
    return {"platform": "gpu", "kind": kind, "count": count}


# -- phase 2 -------------------------------------------------------------------

def phase_build() -> None:
    if REHEARSAL:
        say("build: skipped (no nvcc)")
        return
    _build.load()
    info = _build.build_info
    say(f"build: {'compiled' if info['compiled'] else 'reused'} {info['library']} "
        f"in {info['seconds']:.2f} s")
    for source, lines in info["ptxas"].items():
        for line in lines:
            say(f"  {source}: {line}")


# -- phase 3: K1 -------------------------------------------------------------------

def attention_inputs(b, s, h, d, dtype, device, g):
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device=device).to(dtype)
    lengths = torch.randint(s // 2, s + 1, (b,), generator=g, device=device)
    bias = torch.where(torch.arange(s, device=device)[None] < lengths[:, None],
                       0.0, -1e9).float().contiguous()
    return qkv, bias


def phase_k1(device, shapes) -> dict:
    """Returns {S: timing dict} at the bf16 serving shapes."""
    say("K1 fused_attention_packed vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED)
    b, h, d = shapes["batch"], shapes["heads"], shapes["head_dim"]
    out = {}
    for s in shapes["seqs"]:
        for dtype, rate in ((torch.bfloat16, 0.0), (torch.float32, 0.0),
                            (torch.bfloat16, 0.1), (torch.float32, 0.1)):
            if rate > 0 and s != shapes["seqs"][0]:
                continue
            qkv, bias = attention_inputs(b, s, h, d, dtype, device, g)
            q, k, v = qkv.split(h * d, dim=-1)
            seed = 1234 if rate > 0 else None
            got, lse = fused_attention_packed(q, k, v, bias, h, seed, rate, need_lse=True)
            want, lse_want = fused_attention_packed_reference(q, k, v, bias, h, seed,
                                                              rate, need_lse=True)
            sync()
            tag = f"B{b} S{s} H{h} D{d} {str(dtype)[6:]} rate {rate}"
            err = check_close(f"out {tag}", got, want, TOL[dtype])
            check_close(f"lse {tag}", lse, lse_want, TOL[torch.float32])
            if dtype != torch.bfloat16 or rate > 0:
                continue
            n = 1 if REHEARSAL else copies_for_cold_l2(qkv.numel() * qkv.element_size())
            sets = [(qkv, bias)] + [attention_inputs(b, s, h, d, dtype, device, g)
                                    for _ in range(n - 1)]
            split = [(x.split(h * d, dim=-1), kb) for x, kb in sets]
            it = iter(range(10 ** 9))

            def kernel():
                (q_, k_, v_), kb = split[next(it) % len(split)]
                fused_attention_packed(q_, k_, v_, kb, h)

            def plain():
                (q_, k_, v_), kb = split[next(it) % len(split)]
                fused_attention_packed_reference(q_, k_, v_, kb, h)

            def library():
                (q_, k_, v_), kb = split[next(it) % len(split)]
                four = [t.view(b, s, h, d).transpose(1, 2) for t in (q_, k_, v_)]
                F.scaled_dot_product_attention(
                    *four, attn_mask=kb.to(dtype)[:, None, None, :])

            ms = time_ms(kernel)
            plain_ms = time_ms(plain, iters=5, warmup=1)
            lib_ms = time_ms(library)
            nbytes = 4 * b * s * h * d * qkv.element_size() + b * s * 4
            ops = 4 * b * h * s * s * d
            bms, by = bound_ms(nbytes, ops, dtype)
            say(f"  time {tag}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
                f"sdpa {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.2f} GFLOP)")
            out[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    return out


# -- phase 4: K2 -------------------------------------------------------------------

def ln_inputs(rows, hidden, dtype, device, g):
    x = torch.randn(rows, hidden, generator=g, device=device).to(dtype)
    res = torch.randn(rows, hidden, generator=g, device=device).to(dtype)
    return x, res


def phase_k2(device, shapes) -> dict:
    """Returns {rows: timing dict} for the bf16 residual variant."""
    say("K2 fused_add_layernorm vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    hidden = shapes["hidden"]
    gamma = (1.0 + 0.1 * torch.randn(hidden, generator=g, device=device)).contiguous()
    beta = (0.1 * torch.randn(hidden, generator=g, device=device)).contiguous()
    eps = 1e-12
    out = {}
    for rows in shapes["rows"]:
        for dtype in (torch.bfloat16, torch.float32):
            x, res = ln_inputs(rows, hidden, dtype, device, g)
            for with_res in (True, False):
                r = res if with_res else None
                got = fused_add_layernorm(x, r, gamma, beta, eps)
                want = layernorm_reference(x, r, gamma, beta, eps)
                sync()
                tag = f"R{rows} H{hidden} {str(dtype)[6:]} residual {with_res}"
                err = check_close(tag, got, want, TOL[dtype])
                if dtype != torch.bfloat16:
                    continue
                elt = x.element_size()
                n = 1 if REHEARSAL else copies_for_cold_l2(2 * x.numel() * elt)
                sets = [(x, res)] + [ln_inputs(rows, hidden, dtype, device, g)
                                     for _ in range(n - 1)]
                it = iter(range(10 ** 9))

                def pick():
                    x_, r_ = sets[next(it) % len(sets)]
                    return x_, (r_ if with_res else None)

                def kernel():
                    fused_add_layernorm(*pick(), gamma, beta, eps)

                def plain():
                    layernorm_reference(*pick(), gamma, beta, eps)

                def library():
                    x_, r_ = pick()
                    F.layer_norm(x_ if r_ is None else x_ + r_, (hidden,),
                                 gamma.to(dtype), beta.to(dtype), eps)

                ms = time_ms(kernel, iters=50)
                plain_ms = time_ms(plain)
                lib_ms = time_ms(library, iters=50)
                nbytes = (3 if with_res else 2) * rows * hidden * elt + 2 * hidden * 4
                bms, by = bound_ms(nbytes, 10 * rows * hidden, torch.float32)
                say(f"  time {tag}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
                    f"F.layer_norm {lib_ms:.4f} ms, bound {bms:.4f} ms "
                    f"({by}: {nbytes / 1e6:.1f} MB)")
                if with_res:
                    out[rows] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                 "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    return out


# -- phase 5: serving ------------------------------------------------------------

def build_world(sizes, device, dtype):
    world = SyntheticWorld(
        seed=3, num_scans=sizes["scans"], viewpoints_per_scan=sizes["viewpoints"],
        scene_feat_dim=sizes["feat"], dialog_turns=(2, 6), words_per_turn=(10, 30))
    table = SceneFeatureTable.pack(world.graphs, world.scene_features(), vfov=60)
    tok = WordPieceTokenizer(build_wordpiece_vocab(
        [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=4096))
    with tempfile.TemporaryDirectory() as d:
        root = world.write_task_data(d, counts={"val_unseen": sizes["instances"]})
        instances = build_nav_instances(root, ["val_unseen"], tok,
                                        max_seq_length=sizes["seq"])
    runtime = NavRuntime.build(world.graphs, table, device_dtype=dtype, device=device)
    return world, table, tok, instances, runtime


def make_agent(sizes, tok, runtime, dtype, device):
    cfg = BertConfig(vocab_size=len(tok), max_position_embeddings=sizes["seq"],
                     type_vocab_size=4, dtype=dtype, **sizes["bert"])
    return ViewpointAgent(cfg, runtime, feature_dim=sizes["feat"],
                          episode_len=sizes["episode_len"], rnn_dim=sizes["rnn"],
                          encoder_hidden_size=sizes["rnn"], device=device)


def check_trajectories(results, instances, runtime, episode_len) -> None:
    by_idx = {it.inst_idx: it for it in instances}
    if set(results) != set(by_idx):
        fail(f"results cover {len(results)} of {len(by_idx)} instances")
    for idx, path in results.items():
        it = by_idx[idx]
        g = runtime.graphs[it.scan]
        row, view = runtime.start_state(it.scan, it.path("trusted_path")[0],
                                        it.start_pano["heading"], 0.0)
        start = (runtime.row_to_id(row)[1], geo.heading_of_view(view),
                 geo.elevation_of_view(view))
        if tuple(path[0]) != start:
            fail(f"instance {idx}: starts at {path[0]}, expected {start}")
        if not 1 <= len(path) <= episode_len + 1:
            fail(f"instance {idx}: {len(path)} poses for {episode_len} steps")
        for (a, _, _), (b, _, _) in zip(path, path[1:]):
            if not g.adjacency[g.index[a], g.index[b]]:
                fail(f"instance {idx}: step {a} -> {b} is not a graph edge")


def counted_run(agent, params, batcher, submit: bool):
    fused_attention_packed.launches = 0
    fused_add_layernorm.launches = 0
    sync()
    t0 = time.perf_counter()
    results = agent.test(params, batcher.eval_batches(), feedback="argmax",
                         submit=submit)
    sync()
    seconds = time.perf_counter() - t0
    return results, seconds, fused_attention_packed.launches, fused_add_layernorm.launches


def phase_serving(device, sizes) -> dict:
    say("serving: NDH argmax rollout, ViewpointAgent.test")
    t0 = time.perf_counter()
    world, table, tok, instances, runtime = build_world(sizes, device, sizes["dtype"])
    agent = make_agent(sizes, tok, runtime, sizes["dtype"], device)
    params = agent.init_params(SEED)
    batcher = NavEpisodeBatcher(instances, runtime, batch_size=sizes["batch"])
    n_batches = -(-len(instances) // sizes["batch"])
    bucket = agent.trim_batch(next(iter(batcher.eval_batches())))["ids"].shape[1]
    lengths = [it.length for it in instances]
    say(f"  set-up {time.perf_counter() - t0:.1f} s: {len(instances)} instances "
        f"(dialogs {min(lengths)}-{max(lengths)} tokens, S bucket {bucket}), "
        f"{table.table.shape[0]} viewpoints, {n_batches} batches of {sizes['batch']}, "
        f"BERT {agent.cfg.num_hidden_layers}x{agent.cfg.hidden_size} {str(sizes['dtype'])[6:]}")

    agent.test(params, batcher.eval_batches(), feedback="argmax")  # warm-up
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    runs = {}
    for submit in (False, True):
        results, seconds, k1, k2 = counted_run(agent, params, batcher, submit)
        check_trajectories(results, instances, runtime, sizes["episode_len"])
        if not REHEARSAL:
            want1 = agent.cfg.num_hidden_layers * n_batches
            want2 = (2 * agent.cfg.num_hidden_layers + 1) * n_batches
            if (k1, k2) != (want1, want2):
                fail(f"kernel launches K1 {k1}, K2 {k2}; expected {want1}, {want2}")
        # Host-clock repeats: the rollout is partly bound by the host issuing
        # launches, so single readings spread; report the median and range.
        ms = sorted([seconds * 1e3 / n_batches]
                    + [counted_run(agent, params, batcher, submit)[1] * 1e3 / n_batches
                       for _ in range(4)])
        med = ms[len(ms) // 2]
        steps = np.mean([len(p) - 1 for p in results.values()])
        say(f"  submit={submit}: {len(results)} trajectories valid (mean {steps:.2f} "
            f"moves); launches K1 {k1}, K2 {k2}; {med:.2f} ms/batch (median of "
            f"{len(ms)} runs, range {ms[0]:.2f}-{ms[-1]:.2f}), "
            f"{sizes['batch'] / med * 1e3:.1f} episodes/s, "
            f"{sizes['batch'] * sizes['episode_len'] / med * 1e3:.1f} actions/s")
        runs[submit] = {"ms_per_batch": med, "k1": k1, "k2": k2}
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    say(f"  peak device memory: {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")

    # Where the time goes in one batch of the device rollout.
    with torch.inference_mode():
        batch = agent.trim_batch(next(iter(batcher.eval_batches())))
        total = time_ms(lambda: agent.device_rollout(params, batch), iters=10, warmup=2)
        encode = time_ms(lambda: agent.encode(params, batch), iters=10, warmup=2)
        ids = agent._index(batch["ids"])
        lengths_t = agent._index(batch["lengths"])
        bert_params = {k[len("bert."):]: v for k, v in params["encoder"].items()
                       if k.startswith("bert.")}
        bert_kw = {"token_type_ids": agent._index(batch["segs"]),
                   "attention_mask": (torch.arange(ids.shape[1], device=ids.device)[None]
                                      < lengths_t[:, None]).int()}

        def bert_call():
            return functional_call(agent.encoder.bert, bert_params, (ids,), bert_kw)

        bert = time_ms(bert_call, iters=10, warmup=2)
        lstm_params = {n: params["encoder"][f"lstm.fwd.{n}"] for n in ("wi", "wh", "bi", "bh")}
        seq32 = bert_call()[0].float()
        lstm = time_ms(lambda: masked_lstm_scan(lstm_params, seq32, lengths_t), iters=10,
                       warmup=2)
    say(f"  time split of one batch (S {bucket}): device rollout {total:.2f} ms = "
        f"encode {encode:.2f} ms + {sizes['episode_len']} decode steps "
        f"{total - encode:.2f} ms; alone: BERT {bert:.2f} ms, masked LSTM "
        f"{lstm:.2f} ms (inside encode they overlap: the LSTM loop is bound by "
        f"the host issuing its launches); LSTM share {lstm / total:.1%}")
    if not REHEARSAL:
        profile_rollout(agent, params, batch)
    return {"bucket": bucket, "runs": runs, "peak_bytes": peak, "instances": instances,
            "tok": tok, "world": world, "table": table}


def profile_rollout(agent, params, batch) -> None:
    """Device busy share of one device rollout and its top kernels, from a
    torch.profiler trace (CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        agent.device_rollout(params, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            agent.device_rollout(params, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    say(f"  profile of one device rollout: {len(kernels)} device kernels, busy "
        f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall (idle share "
        f"{1 - busy_us / wall_us:.1%}; the wall includes the profiler's own cost)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        say(f"    {us / 1e3:8.3f} ms  {n:5d} x  {name[:90]}")


def phase_agreement(device, sizes, sl) -> None:
    """fp32 on the card (kernels) against fp32 on the CPU (plain twins)."""
    say("agreement: fp32 card vs CPU on a 2-item batch")
    agents = {}
    for dev in (device, "cpu"):
        rt = NavRuntime.build(sl["world"].graphs, sl["table"], device_dtype=torch.float32,
                              device=dev)
        agents[dev] = make_agent(sizes, sl["tok"], rt, torch.float32, dev)
    batcher = NavEpisodeBatcher(sl["instances"][:2], agents[device].runtime, batch_size=2)
    batch = agents[device].trim_batch(next(iter(batcher.eval_batches())))
    out = {}
    with torch.inference_mode():
        for dev, agent in agents.items():
            params = agent.init_params(SEED)
            ctx, h0, c0, ctx_mask = agent.encode(params, batch)
            out[dev] = {"ctx": ctx, "h0": h0, "c0": c0, "params": params,
                        "ctx_mask": ctx_mask}
        ref = agents[device]
        rows, views, _, logits = ref.device_rollout(out[device]["params"], batch)
        # The CPU decoder follows the card's trajectory, so every step compares
        # the same decoder inputs.
        cpu = agents["cpu"]
        o = out["cpu"]
        h, c = o["h0"], o["c0"]
        cur_row = cpu._index(batch["start_rows"])
        view = cpu._index(batch["start_views"])
        cpu_logits = []
        for t in range(sizes["episode_len"]):
            logit, h, c = cpu.decode_step(o["params"], h, c, o["ctx"], o["ctx_mask"],
                                          cur_row, view)
            cpu_logits.append(logit)
            cur_row, view = rows[:, t].cpu(), views[:, t].cpu()
    for name in ("ctx", "h0", "c0"):
        check_close(name, out[device][name].cpu(), out["cpu"][name], AGREE_TOL)
    check_close(f"logits of {sizes['episode_len']} steps", logits.cpu(),
                torch.stack(cpu_logits, 1), AGREE_TOL)


def kernels_line(k1_times, k2_times, sl) -> dict:
    bucket = sl["bucket"]
    runs = sl["runs"][False]
    k1 = k1_times[bucket]
    k2 = k2_times[sl["ln_rows"]]
    return {"kernels": [
        {"name": "fused_attention_packed", "route": "cuda", "source": ATTN_SOURCE[0],
         "replaces": ATTN_SOURCE[1], "launches": runs["k1"],
         "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": k1["library_ms"]},
        {"name": "fused_add_layernorm", "route": "cuda", "source": LN_SOURCE[0],
         "replaces": LN_SOURCE[1], "launches": runs["k2"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"]},
    ]}


def main(argv=None) -> int:
    global REHEARSAL
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run every phase at a tiny size with the plain twins on "
                         "the CPU; prints no result")
    args = ap.parse_args(argv)
    REHEARSAL = args.cpu_rehearsal
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    if REHEARSAL:
        device = "cpu"
        attn = {"batch": 2, "heads": 2, "head_dim": 64, "seqs": (128,)}
        ln = {"hidden": 128, "rows": (2 * 128,)}
        sizes = {"scans": 1, "viewpoints": 12, "feat": 32, "instances": 6, "seq": 128,
                 "batch": 4, "episode_len": 3, "rnn": 24, "dtype": torch.float32,
                 "bert": {"num_hidden_layers": 2, "hidden_size": 128,
                          "num_attention_heads": 2, "intermediate_size": 256}}
    else:
        device = "cuda"
        attn = {"batch": 64, "heads": 12, "head_dim": 64, "seqs": (256, 512)}
        ln = {"hidden": 768, "rows": (64 * 256, 64 * 512)}
        sizes = {"scans": 4, "viewpoints": 60, "feat": 2048, "instances": 128,
                 "seq": 512, "batch": 64, "episode_len": 10, "rnn": 512,
                 "dtype": torch.bfloat16, "bert": {}}
    dev_info = phase_device()
    phase_build()
    k1_times = phase_k1(device, attn)
    k2_times = phase_k2(device, ln)
    sl = phase_serving(device, sizes)
    bucket = sl["bucket"]
    sl["ln_rows"] = sizes["batch"] * bucket
    if bucket not in k1_times:
        k1_times.update(phase_k1(device, {**attn, "batch": sizes["batch"],
                                          "seqs": (bucket,)}))
    if sl["ln_rows"] not in k2_times:
        k2_times.update(phase_k2(device, {**ln, "rows": (sl["ln_rows"],)}))
    phase_agreement(device, sizes, sl)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if REHEARSAL:
        return 0
    print(json.dumps(kernels_line(k1_times, k2_times, sl)), flush=True)
    print(json.dumps({"ok": True, "device": dev_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
