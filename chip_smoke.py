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
  5. K1b      the attention backward vs its plain twin at the train shapes
              (B 64, S 256 and 512, 12 heads of 64, bf16 with padded keys,
              fp32, and hash dropout at rate 0.1, whose masks are K1f's);
              times of the kernel, the twin, the autograd backward of torch's
              scaled_dot_product_attention as a yardstick, and the bound;
  6. K2b      the add+LayerNorm backward vs its twin (R = 64*256 and 64*512,
              H 768, bf16 and fp32, with and without a residual; dh, dgamma,
              dbeta); times and the autograd backward of F.layer_norm(x + res);
  7. serving  the NDH argmax serving rollout, ViewpointAgent.test, at BERT-base
              width and depth (bf16, batch 64, 10-step episodes, 2048-d
              features, rnn 512, random weights from a seed), with and without
              ``submit``; trajectories checked against the graph; kernel
              launch counts read around each run; fp32 agreement of the card
              with the CPU on a 2-item batch; ms per batch, episodes/s,
              actions/s, the time split (BERT / LSTM / decode loop), peak memory;
  8. train    the NDH teacher-forced train step, ViewpointAgent.train_step_fn
              over NavEpisodeBatcher.train_batches (planner_path, batch 64,
              10-step episodes, the agent's dropouts, Adam at 5e-5, clip 40):
              2 warm-up steps and 8 timed; losses finite, params changed,
              K1f / K1b / K2f / K2b launches counted around one step and the
              timed run; ms per step, nav actions/s, the forward / backward /
              optimizer split, the device idle share from torch.profiler, peak
              memory; then one fp32 step with every dropout at 0 on a 2-item
              batch on the card and on the CPU: loss, gradients and updated
              parameters agree.

The line before the last is a JSON object listing each kernel with its
launches in its path's run (K1f and K2f: serving; K1b and K2b: train), max
error, and times; the last line is ``{"ok": true, "device": {...}}``.  A
rehearsal prints neither.
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
                                          fused_attention_packed_bwd,
                                          fused_attention_packed_bwd_reference,
                                          fused_attention_packed_reference)
from visitron_torch.ops.layernorm import (fused_add_layernorm, fused_add_layernorm_bwd,
                                          layernorm_bwd_reference, layernorm_reference)
from visitron_torch.train.optim import apply_updates, tree_leaves
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
# Gradients of K1b: bf16 rounds a_eff and ds where the twin does and sums in
# another order, so an output may differ by about one bf16 ulp (the largest
# error seen on an H100 at the shapes below was 3.9e-3); the limit is about
# twice that, and rtol 1e-2 covers one ulp (2^-7 relative) at any magnitude.
# fp32: summation order only.
GRAD_TOL = {torch.bfloat16: (8e-3, 1e-2), torch.float32: (1e-4, 1e-4)}
# dgamma/dbeta: fp32 sums over R = 16K-32K rows in another order.
SUM_TOL = (1e-3, 1e-4)
AGREE_TOL = (1e-3, 1e-3)  # card vs CPU, fp32, whole model: (atol, rtol)
ATTN_SOURCE = ("visitron_torch/csrc/attention.cu",
               "visitron_tpu/ops/attention.py:705")
LN_SOURCE = ("visitron_torch/csrc/layernorm.cu",
             "visitron_tpu/ops/layernorm.py:95")
ATTN_BWD_REPLACES = "visitron_tpu/ops/attention.py:742"
LN_BWD_REPLACES = "visitron_tpu/ops/layernorm.py:123"

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


# -- phase 5: K1b ----------------------------------------------------------------

def phase_k1b(device, shapes) -> dict:
    """Returns {S: timing dict} at the bf16 train shapes."""
    say("K1b fused_attention_packed_bwd vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    b, h, d = shapes["batch"], shapes["heads"], shapes["head_dim"]
    out = {}

    def inputs(s, dtype, rate, seed):
        qkv, bias = attention_inputs(b, s, h, d, dtype, device, g)
        q, k, v = qkv.split(h * d, dim=-1)
        dout = torch.randn(b, s, h * d, generator=g, device=device).to(dtype)
        _, lse = fused_attention_packed(q, k, v, bias, h, seed, rate, need_lse=True)
        return q, k, v, bias, dout, lse

    for s in shapes["seqs"]:
        for dtype, rate in ((torch.bfloat16, 0.0), (torch.float32, 0.0),
                            (torch.bfloat16, 0.1), (torch.float32, 0.1)):
            if rate > 0 and s != shapes["seqs"][0]:
                continue
            seed = 1234 if rate > 0 else None
            args = inputs(s, dtype, rate, seed)
            got = fused_attention_packed_bwd(*args, h, seed, rate)
            want = fused_attention_packed_bwd_reference(*args, h, seed, rate)
            sync()
            tag = f"B{b} S{s} H{h} D{d} {str(dtype)[6:]} rate {rate}"
            err = max(check_close(f"{name} {tag}", x, y, GRAD_TOL[dtype])
                      for name, x, y in zip(("dq", "dk", "dv"), got, want))
            if rate > 0:
                say("  (the twin's keep mask is K1f's, checked in phase K1: the two "
                    "kernels' masks agree)")
            if dtype != torch.bfloat16 or rate > 0:
                continue
            elt = args[0].element_size()
            n = 1 if REHEARSAL else copies_for_cold_l2(4 * b * s * h * d * elt)
            sets = [args] + [inputs(s, dtype, 0.0, None) for _ in range(n - 1)]
            it = iter(range(10 ** 9))

            def kernel():
                fused_attention_packed_bwd(*sets[next(it) % len(sets)], h)

            def plain():
                fused_attention_packed_bwd_reference(*sets[next(it) % len(sets)], h)

            graphs = []
            for q_, k_, v_, kb, do_, _ in sets:
                four = [t.view(b, s, h, d).transpose(1, 2).detach().requires_grad_()
                        for t in (q_, k_, v_)]
                o4 = F.scaled_dot_product_attention(
                    *four, attn_mask=kb.to(dtype)[:, None, None, :])
                graphs.append((o4, four, do_.view(b, s, h, d).transpose(1, 2)))

            def library():
                o4, four, do4 = graphs[next(it) % len(graphs)]
                torch.autograd.grad(o4, four, do4, retain_graph=True)

            ms = time_ms(kernel)
            plain_ms = time_ms(plain, iters=3, warmup=1)
            lib_ms = time_ms(library)
            del graphs
            nbytes = 7 * b * s * h * d * elt + b * h * s * 4 + b * s * 4
            ops = 10 * b * h * s * s * d
            bms, by = bound_ms(nbytes, ops, dtype)
            say(f"  time {tag}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
                f"sdpa backward {lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: "
                f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP; the two kernels "
                f"do {1.8 * ops / 1e9:.2f})")
            out[s] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    return out


# -- phase 6: K2b ------------------------------------------------------------------

def phase_k2b(device, shapes) -> dict:
    """Returns {rows: timing dict} for the bf16 residual variant."""
    say("K2b fused_add_layernorm_bwd vs plain twin")
    g = torch.Generator(device=device).manual_seed(SEED + 3)
    hidden = shapes["hidden"]
    gamma = (1.0 + 0.1 * torch.randn(hidden, generator=g, device=device)).contiguous()
    eps = 1e-12
    out = {}

    def inputs(rows, dtype):
        dy = torch.randn(rows, hidden, generator=g, device=device).to(dtype)
        return (dy, *ln_inputs(rows, hidden, dtype, device, g))

    for rows in shapes["rows"]:
        for dtype in (torch.bfloat16, torch.float32):
            dy, x, res = inputs(rows, dtype)
            for with_res in (True, False):
                r = res if with_res else None
                got = fused_add_layernorm_bwd(dy, x, r, gamma, eps)
                want = layernorm_bwd_reference(dy, x, r, gamma, eps)
                sync()
                tag = f"R{rows} H{hidden} {str(dtype)[6:]} residual {with_res}"
                err = check_close(f"dh {tag}", got[0], want[0], TOL[dtype])
                check_close(f"dgamma {tag}", got[1], want[1], SUM_TOL)
                check_close(f"dbeta {tag}", got[2], want[2], SUM_TOL)
                if dtype != torch.bfloat16:
                    continue
                elt = x.element_size()
                n = 1 if REHEARSAL else copies_for_cold_l2(4 * x.numel() * elt)
                sets = [(dy, x, res)] + [inputs(rows, dtype) for _ in range(n - 1)]
                it = iter(range(10 ** 9))

                def pick():
                    dy_, x_, r_ = sets[next(it) % len(sets)]
                    return dy_, x_, (r_ if with_res else None)

                def kernel():
                    fused_add_layernorm_bwd(*pick(), gamma, eps)

                def plain():
                    layernorm_bwd_reference(*pick(), gamma, eps)

                graphs = []
                for dy_, x_, r_ in sets:
                    xl, rl = x_.detach().requires_grad_(), r_.detach().requires_grad_()
                    gl = gamma.to(dtype).requires_grad_()
                    bl = torch.zeros(hidden, dtype=dtype, device=device,
                                     requires_grad=True)
                    y_ = F.layer_norm(xl + rl if with_res else xl, (hidden,), gl, bl, eps)
                    graphs.append((y_, [xl, rl, gl, bl] if with_res else [xl, gl, bl],
                                   dy_))

                def library():
                    y_, leaves, dy_ = graphs[next(it) % len(graphs)]
                    torch.autograd.grad(y_, leaves, dy_, retain_graph=True)

                ms = time_ms(kernel, iters=50)
                plain_ms = time_ms(plain)
                lib_ms = time_ms(library, iters=50)
                del graphs
                nbytes = (4 if with_res else 3) * rows * hidden * elt + 3 * hidden * 4
                bms, by = bound_ms(nbytes, 20 * rows * hidden, torch.float32)
                say(f"  time {tag}: kernel {ms:.4f} ms (with the sum of its partials), "
                    f"plain twin {plain_ms:.4f} ms, F.layer_norm backward "
                    f"{lib_ms:.4f} ms, bound {bms:.4f} ms ({by}: {nbytes / 1e6:.1f} MB)")
                if with_res:
                    out[rows] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                 "bound_ms": bms, "bound_by": by, "max_abs_err": err}
    return out


# -- phase 7: serving ------------------------------------------------------------

def build_world(sizes, device, dtype):
    world = SyntheticWorld(
        seed=3, num_scans=sizes["scans"], viewpoints_per_scan=sizes["viewpoints"],
        scene_feat_dim=sizes["feat"], dialog_turns=(2, 6), words_per_turn=(10, 30))
    table = SceneFeatureTable.pack(world.graphs, world.scene_features(), vfov=60)
    tok = WordPieceTokenizer(build_wordpiece_vocab(
        [" ".join(_WORDS), " ".join(_TARGETS)], vocab_size=4096))
    with tempfile.TemporaryDirectory() as d:
        root = world.write_task_data(d, counts={"val_unseen": sizes["instances"],
                                                "train": sizes["instances"]})
        instances, train_instances = (
            build_nav_instances(root, [split], tok, max_seq_length=sizes["seq"])
            for split in ("val_unseen", "train"))
    runtime = NavRuntime.build(world.graphs, table, device_dtype=dtype, device=device)
    return world, table, tok, instances, train_instances, runtime


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
    world, table, tok, instances, train_instances, runtime = build_world(
        sizes, device, sizes["dtype"])
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
            "train_instances": train_instances, "tok": tok, "world": world,
            "table": table, "agent": agent, "runtime": runtime}


def profile_rollout(agent, params, batch) -> None:
    """Device busy share of one device rollout and its top kernels."""
    with torch.inference_mode():
        profile_device(lambda: agent.device_rollout(params, batch), "device rollout")


def profile_device(fn, what: str) -> float:
    """Run ``fn`` once warm, then once under torch.profiler (CUPTI); print the
    device busy time, the idle share and the top kernels; return the idle
    share."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    idle = 1 - busy_us / wall_us
    say(f"  profile of one {what}: {len(kernels)} device kernels, busy "
        f"{busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall (idle share "
        f"{idle:.1%}; the wall includes the profiler's own cost)")
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]:
        say(f"    {us / 1e3:8.3f} ms  {n:5d} x  {name[:90]}")
    return idle


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


# -- phase 8: train -----------------------------------------------------------------

COUNTED = (fused_attention_packed, fused_attention_packed_bwd, fused_add_layernorm,
           fused_add_layernorm_bwd)


def zero_counts() -> None:
    for fn in COUNTED:
        fn.launches = 0


def read_counts() -> tuple:
    return tuple(fn.launches for fn in COUNTED)


def phase_train(device, sizes, sl) -> dict:
    say("train: NDH teacher-forced train step, ViewpointAgent.train_step_fn")
    agent, runtime, cfg = sl["agent"], sl["runtime"], sl["agent"].cfg
    n_warm, n_timed = 2, 8
    t0 = time.perf_counter()
    batcher = NavEpisodeBatcher(sl["train_instances"], runtime, batch_size=sizes["batch"],
                                path_type="planner_path")
    batches = list(batcher.train_batches(n_warm + n_timed,
                                         episode_len=sizes["episode_len"]))
    buckets = [agent.trim_batch(b)["ids"].shape[1] for b in batches]
    state = agent.init_state()
    start = [t.clone() for t in tree_leaves(state["params"])]
    step = agent.train_step_fn()
    say(f"  set-up {time.perf_counter() - t0:.1f} s: {len(sl['train_instances'])} train "
        f"instances, S buckets {buckets}, dropout hidden {cfg.hidden_dropout_prob} / "
        f"attention {cfg.attention_probs_dropout_prob} / agent {agent.dropout}, Adam lr "
        f"{agent.learning_rate}, clip {agent.max_grad_norm}")
    losses = []
    for batch in batches[:n_warm]:
        state, loss = step(state, batch)
        losses.append(loss)
    if not REHEARSAL:
        torch.cuda.reset_peak_memory_stats()
    zero_counts()
    per_step, ms = None, []
    for batch in batches[n_warm:]:
        sync()
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        sync()
        ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(loss)
        per_step = per_step or read_counts()
    totals = read_counts()
    peak = None if REHEARSAL else torch.cuda.max_memory_allocated()
    layers = cfg.num_hidden_layers
    want = (layers, layers, 2 * layers + 1, 2 * layers + 1)
    say(f"  launches in one step: K1f {per_step[0]}, K1b {per_step[1]}, K2f "
        f"{per_step[2]}, K2b {per_step[3]}; in the {n_timed} timed steps: {totals}")
    if not REHEARSAL and (per_step != want
                          or totals != tuple(n_timed * w for w in want)):
        fail(f"kernel launches per step {per_step}, timed run {totals}; expected "
             f"{want} per step")
    losses = torch.stack(losses).float().cpu()
    if not torch.isfinite(losses).all():
        fail(f"non-finite train losses {losses.tolist()}")
    final = tree_leaves(state["params"])
    moved = sum(not torch.equal(a, b) for a, b in zip(start, final))
    if moved < len(final) - 2 or not all(torch.isfinite(p).all() for p in final):
        fail(f"{moved} of {len(final)} parameters changed, or some are not finite")
    med = sorted(ms)[len(ms) // 2]
    actions = sizes["batch"] * sizes["episode_len"]
    say(f"  losses {', '.join(f'{x:.4f}' for x in losses.tolist())}; {moved} of "
        f"{len(final)} parameter tensors changed (the BERT pooler takes no part)")
    say(f"  {med:.2f} ms/step (median of {n_timed} steps, range {min(ms):.2f}-"
        f"{max(ms):.2f}), {actions / med * 1e3:.1f} nav actions/s; peak device "
        f"memory {'n/a' if peak is None else f'{peak / 2**30:.2f} GiB'}")
    time_split(agent, state, batches[n_warm])
    idle = None if REHEARSAL else profile_device(
        lambda: step(state, batches[n_warm]), "train step")
    bucket = max(set(buckets[n_warm:]), key=buckets[n_warm:].count)
    return {"ms_per_step": med, "range": (min(ms), max(ms)), "k1b": totals[1],
            "k2b": totals[3], "bucket": bucket, "peak_bytes": peak, "idle": idle}


def time_split(agent, state, batch) -> None:
    """Where one step's time goes (CUDA events around each piece run alone):
    the whole forward, forward + backward and optimizer, and BERT, the
    masked LSTM and the decode half (projections excluded) each alone,
    forward and forward + backward.  The LSTM loop and the decode steps are
    bound by the host issuing launches, so inside the step the device runs
    BERT's kernels while the host is still issuing the LSTM's: the pieces
    alone add up to more than the step."""
    batch = agent.trim_batch(batch)
    params, rng = state["params"], state["rng"]
    live = {part: {n: p.detach().requires_grad_() for n, p in d.items()}
            for part, d in params.items()}
    timed = lambda fn: time_ms(fn, iters=3, warmup=1)  # noqa: E731
    fwd = timed(lambda: agent.episode_loss(live, batch, rng))
    total = timed(lambda: agent.loss_and_grads(params, batch, rng))
    _, grads = agent.loss_and_grads(params, batch, rng)
    opt = time_ms(lambda: apply_updates(params, agent.optimizer.update(
        grads, state["opt_state"], params)[0]), iters=5, warmup=1)
    ids, lengths = agent._index(batch["ids"]), agent._index(batch["lengths"])
    bert_params = {k[len("bert."):]: v for k, v in live["encoder"].items()
                   if k.startswith("bert.")}
    bert_kw = {"token_type_ids": agent._index(batch["segs"]), "rng": rng,
               "attention_mask": (torch.arange(ids.shape[1], device=ids.device)[None]
                                  < lengths[:, None]).int()}

    def bert():
        return functional_call(agent.encoder.bert, bert_params, (ids,), bert_kw)[0]

    seq = bert()
    cot = torch.randn_like(seq)
    lstm_params = {n: live["encoder"][f"lstm.fwd.{n}"] for n in ("wi", "wh", "bi", "bh")}
    seq32 = seq.detach().float().requires_grad_()

    def lstm():
        ys, (h, c) = masked_lstm_scan(lstm_params, seq32, lengths)
        return ys, h, c

    cots = [torch.randn_like(t) for t in lstm()]
    enc = [t.detach().requires_grad_() if t.is_floating_point() else t
           for t in agent.encode(params, batch)]
    dec_params = list(live["decoder"].values())

    def decode():
        return agent.teacher_forced_loss(live, batch, *enc, rng)

    parts = {
        "BERT": (bert, lambda: torch.autograd.grad(bert(), list(bert_params.values()),
                                                   cot, allow_unused=True)),
        "masked LSTM": (lstm, lambda: torch.autograd.grad(
            lstm(), [seq32, *lstm_params.values()], cots)),
        f"{agent.episode_len} decode steps + loss": (decode, lambda: torch.autograd.grad(
            decode(), [*enc[:3], *dec_params])),
    }
    alone = []
    for name, (f, fb) in parts.items():
        tf, tfb = timed(f), timed(fb)
        alone.append(f"{name} forward {tf:.2f} / backward {tfb - tf:.2f} ms")
    say(f"  time split of one step (S {ids.shape[1]}): forward {fwd:.2f} ms + backward "
        f"{total - fwd:.2f} ms + optimizer {opt:.2f} ms ({len(tree_leaves(params))} "
        f"tensors); alone: {'; '.join(alone)}")


def phase_train_agreement(device, sizes, sl) -> None:
    """One fp32 train step with every dropout at 0 on a 2-item batch: the card
    (kernels) against the CPU (plain twins)."""
    say("train agreement: one fp32 step, dropouts 0, card vs CPU on a 2-item batch")
    agents = {}
    for dev in (device, "cpu"):
        rt = NavRuntime.build(sl["world"].graphs, sl["table"], device_dtype=torch.float32,
                              device=dev)
        cfg = BertConfig(vocab_size=len(sl["tok"]), max_position_embeddings=sizes["seq"],
                         type_vocab_size=4, dtype=torch.float32, hidden_dropout_prob=0.0,
                         attention_probs_dropout_prob=0.0, **sizes["bert"])
        agents[dev] = ViewpointAgent(cfg, rt, feature_dim=sizes["feat"],
                                     episode_len=sizes["episode_len"], rnn_dim=sizes["rnn"],
                                     encoder_hidden_size=sizes["rnn"], dropout=0.0,
                                     device=dev)
    batcher = NavEpisodeBatcher(sl["train_instances"][:2], agents["cpu"].runtime,
                                batch_size=2, path_type="planner_path")
    batch = next(batcher.train_batches(1, episode_len=sizes["episode_len"]))
    out = {}
    for dev, agent in agents.items():
        state = agent.init_state()
        loss, grads = agent.loss_and_grads(state["params"], agent.trim_batch(batch), None)
        new, _ = agent.train_step_fn()(state, batch)
        out[dev] = (loss, torch.cat([g.flatten() for g in tree_leaves(grads)]),
                    torch.cat([(p1 - p0).flatten() for p1, p0 in
                               zip(tree_leaves(new["params"]), tree_leaves(state["params"]))]))
    n = len(tree_leaves(new["params"]))
    check_close("loss", out[device][0].cpu(), out["cpu"][0], AGREE_TOL)
    check_close(f"gradients ({n} tensors)", out[device][1].cpu(), out["cpu"][1], AGREE_TOL)
    # Adam's first step moves a parameter by lr * g / (|g| + eps): +-lr
    # wherever |g| is well above eps and above the gradients' disagreement,
    # so there the two updates agree to lr * 1e-2 and both move by > lr / 2.
    # Elsewhere each update is bounded by lr, their difference by 2 lr.
    lr = agents["cpu"].learning_rate
    step, want, g = out[device][2].cpu(), out["cpu"][2], out["cpu"][1]
    big = g.abs() > 10 * AGREE_TOL[0]
    diff = (step - want).abs()
    err = float(diff[big].max()) / lr
    say(f"  update of the Adam step ({n} tensors, {int(big.sum())} of {g.numel()} "
        f"entries with |g| > {10 * AGREE_TOL[0]:g}): max|card - cpu| {err:.3g} lr "
        f"(tolerance 1e-2 lr there, 2 lr elsewhere); min moved "
        f"{float(step[big].abs().min()) / lr:.3g} lr (must exceed 0.5 lr)")
    if not big.any():
        fail("no gradient entry large enough to check the Adam update")
    if err > 1e-2 or float(diff.max()) > 2 * lr + 1e-6:
        fail(f"Adam update disagrees between {device} and the CPU")
    if float(step[big].abs().min()) <= 0.5 * lr or not torch.equal(
            step[big].sign(), -g[big].sign()):
        fail("the Adam step on the card did not move each parameter by ~lr against its gradient")


def kernels_line(times, sl, tr) -> dict:
    """One entry per kernel: K1f and K2f at the serving bucket with the
    serving run's launches, K1b and K2b at the train bucket with the train
    run's."""
    runs = sl["runs"][False]
    rows = (sl["ln_rows"], tr["ln_rows"])
    entries = (("fused_attention_packed", ATTN_SOURCE, times["k1"][sl["bucket"]],
                runs["k1"]),
               ("fused_add_layernorm", LN_SOURCE, times["k2"][rows[0]], runs["k2"]),
               ("fused_attention_packed_bwd", (ATTN_SOURCE[0], ATTN_BWD_REPLACES),
                times["k1b"][tr["bucket"]], tr["k1b"]),
               ("fused_add_layernorm_bwd", (LN_SOURCE[0], LN_BWD_REPLACES),
                times["k2b"][rows[1]], tr["k2b"]))
    return {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
         "library_ms": t["library_ms"]}
        for name, (src, replaces), t, launches in entries]}


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
    times = {"k1": phase_k1(device, attn), "k2": phase_k2(device, ln),
             "k1b": phase_k1b(device, attn), "k2b": phase_k2b(device, ln)}
    sl = phase_serving(device, sizes)
    sl["ln_rows"] = sizes["batch"] * sl["bucket"]
    phase_agreement(device, sizes, sl)
    tr = phase_train(device, sizes, sl)
    tr["ln_rows"] = sizes["batch"] * tr["bucket"]
    phase_train_agreement(device, sizes, sl)
    # Kernel times at a path's bucket, where the shape phases did not cover it.
    for key, phase, bucket, rows in (("k1", phase_k1, sl["bucket"], None),
                                     ("k2", phase_k2, None, sl["ln_rows"]),
                                     ("k1b", phase_k1b, tr["bucket"], None),
                                     ("k2b", phase_k2b, None, tr["ln_rows"])):
        if bucket is not None and bucket not in times[key]:
            times[key].update(phase(device, {**attn, "batch": sizes["batch"],
                                             "seqs": (bucket,)}))
        if rows is not None and rows not in times[key]:
            times[key].update(phase(device, {**ln, "rows": (rows,)}))
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if REHEARSAL:
        return 0
    print(json.dumps(kernels_line(times, sl, tr)), flush=True)
    print(json.dumps({"ok": True, "device": dev_info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
