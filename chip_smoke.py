#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with one CUDA GPU (Hopper:
the CUDA kernels are built for sm_90a).  Every phase is fatal: the script
exits non-zero, and prints no result line, when there is no GPU, when it
does not find the port beside it, or when any check fails.

Phases:
  1. the card's name and power limit (nvidia-smi) and the TF32 flags,
     which are switched off: the reference computes in f32;
  2. build the kernels from the sources in the checkout, in parallel:
     ``stale_agg_refresh``, ``flash_attention`` and ``selective_scan``
     (CUDA C++, one nvcc each) and ``batched_dot`` (Triton);
  3. hold each kernel against its plain PyTorch version on the card, at
     the main paths' shapes and at ragged ones, and time kernel, plain
     version and (where one exists) the one-call PyTorch equivalent;
  4. the §6.1 path: ``run_experiment`` of the 3-model world (3 CNN tasks,
     120 clients, P = 103,018 parameters per model) for ``stalevre`` and
     ``stalevr`` on the card, with every kernel's launch count set to 0
     before and read after; one more round of each under
     ``torch.profiler``, which must show both kernels; rounds 0-1 held
     against the same rounds run with the plain versions on the card;
  5. the real-model path: ``build_model_setting``'s world (2 x qwen3-0.6b
     + 1 x falcon-mamba-7b at their published widths, depth cut to 2 and
     1 layers; 4 clients, cap 8, seq_len 256) for ``lvr`` and
     ``stalevre``: 3 rounds each through ``RoundEngine.round_step`` and
     one more under the profiler, which must show the attention and scan
     kernels, with the launch counts set to 0 before and read after;
     rounds 0-1 held against the same rounds with all four plain versions;
  6. the reference's own check: ``tests/golden_engine.json`` reproduced on
     the card (lvr and stalevre, 3 rounds of the small 2-model world);
  7. one JSON line ``{"kernels": [...]}``, then the last line
     ``{"ok": true, "device": {...}}``.

Profiler tables and a JSON report go to ``--out`` (default
``results/chip_smoke/``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense, 700 W): HBM bandwidth and f32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
MAIN_P = 103_018          # parameters of one §6.1 CNN (channels=8)
MAIN_N = 120              # clients of the §6.1 world
MAIN_C = (24, 120)        # K1 rows / K2 cohort: stalevre, stalevr

# the real-model path: published widths, depth cut; 4 clients, cap 8
MODEL_ARCHS = ("qwen3-0.6b", "qwen3-0.6b", "falcon-mamba-7b")
MODEL_LAYERS = {"qwen3-0.6b": 2, "falcon-mamba-7b": 1}
MODEL_P = {"qwen3-0.6b": 342_627_840, "falcon-mamba-7b": 637_984_768}
MODEL_CLIENTS, MODEL_CAP, MODEL_SEQ = 4, 8, 256
MODEL_SERVER = dict(local_epochs=2, batch_size=4)
# K4 (B, H, Hk, S, D, window) and K5 (Bsz, S, di, N, G) at the path's
# calls: cohort local SGD (4 clients x 4 sequences folded into the batch,
# per-client A and D as K5's groups), the 4 x 8-sequence loss probe, and
# ragged shapes; the first entry is the one the kernels line reports
K4_SHAPES = [(16, 16, 8, 256, 128, 0), (32, 16, 8, 256, 128, 0),
             (3, 4, 2, 130, 64, 48), (2, 4, 4, 100, 64, 0),
             (1, 2, 1, 257, 128, 0)]
K5_SHAPES = [(16, 256, 8192, 16, 4), (32, 256, 8192, 16, 1),
             (2, 100, 200, 16, 1), (3, 17, 33, 8, 3)]


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 50, warmup: int = 10) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call),
    with the 50 MB L2 flushed before every call: the main path finds its
    operands cold."""
    import torch
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for i in range(reps):
        flush.zero_()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return ms[len(ms) // 2]


def bound_ms(n_bytes: float, n_flop: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flop / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _free(torch):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def kernel_batched_dot(torch, gen):
    from repro_torch.kernels.batched_dot.batched_dot import batched_dot
    from repro_torch.kernels.batched_dot.ref import batched_dot_ref
    worst, shapes = 0.0, []
    # the §6.1 cohorts, the real-model cohorts (4 clients at P = 0.34 B and
    # 0.64 B: 64-bit offsets, [C, P] tensors of 5.5 and 10.2 GB) and tails
    big = tuple(MODEL_P.values())
    for C, P in [(MAIN_C[0], MAIN_P), (MAIN_C[1], MAIN_P),
                 (MODEL_CLIENTS, big[0]), (MODEL_CLIENTS, big[1]), (7, 1001),
                 (3, 1)]:
        G = torch.randn(C, P, generator=gen, device="cuda")
        h = torch.randn(C, P, generator=gen, device="cuda")
        dots, norms = batched_dot(G, h)
        dots2, norms2 = batched_dot(G, h)
        torch.cuda.synchronize()
        check(torch.equal(dots, dots2) and torch.equal(norms, norms2),
              f"batched_dot [{C},{P}] is not deterministic")
        rd, rn = batched_dot_ref(G, h)
        # tolerance of the reference's kernel tests: rtol 2e-5,
        # atol 2e-5 sqrt(P) (f32 sums over P in another order)
        atol = 2e-5 * math.sqrt(P)
        for got, want, what in ((dots, rd, "dots"), (norms, rn, "norms")):
            err = (got - want).abs()
            check(bool((err <= atol + 2e-5 * want.abs()).all()),
                  f"batched_dot [{C},{P}] {what} off by {err.max().item()}")
            worst = max(worst, err.max().item())
        if P == MAIN_P or P in big:
            reps = dict(reps=50, warmup=10) if P == MAIN_P else \
                dict(reps=10, warmup=2)
            ms = time_ms(lambda: batched_dot(G, h), **reps)
            plain = time_ms(lambda: batched_dot_ref(G, h), **reps)
            lib = time_ms(lambda: (torch.linalg.vecdot(G, h),
                                   torch.linalg.vecdot(h, h)), **reps)
            b, by = bound_ms(2 * C * P * 4 + 2 * C * 4, 4 * C * P)
            shapes.append({"C": C, "P": P, "ms": ms, "plain_ms": plain,
                           "bound_ms": b, "bound_by": by, "library_ms": lib})
        del G, h, rd, rn
        _free(torch)
    return worst, shapes


def kernel_stale_agg_refresh(torch, gen):
    from repro_torch.kernels.stale_agg.ref import stale_agg_refresh_ref
    from repro_torch.kernels.stale_agg.stale_agg import stale_agg_refresh
    worst, shapes = 0.0, []
    big = tuple(MODEL_P.values())
    for C, N, P in [(MAIN_C[0], MAIN_N, MAIN_P), (MAIN_C[1], MAIN_N, MAIN_P),
                    (MODEL_CLIENTS, MODEL_CLIENTS, big[0]),
                    (MODEL_CLIENTS, MODEL_CLIENTS, big[1]), (5, 9, 1001)]:
        G = torch.randn(C, P, generator=gen, device="cuda")
        h_kernel = torch.randn(N, P, generator=gen, device="cuda")
        idx = torch.randperm(N, generator=gen, device="cuda")[:C]
        coeff = torch.rand(C, generator=gen, device="cuda") * 2
        beta = torch.rand(C, generator=gen, device="cuda")
        act = (torch.rand(C, generator=gen, device="cuda") > 0.3).float()
        # one cohort padding slot: coeff 0, act 0 and a NaN update row
        coeff[C // 2], act[C // 2] = 0.0, 0.0
        G[C // 2, : max(1, P // 3)] = float("nan")
        act[0] = 1.0
        stale_sum = torch.randn(P, generator=gen, device="cuda")
        untouched = torch.ones(N, dtype=torch.bool, device="cuda")
        untouched[idx] = False
        untouched[idx[act == 0]] = True
        # the rows the refresh must leave alone, before it runs
        kept = h_kernel[untouched].clone()
        h_plain = h_kernel.clone()
        delta = stale_agg_refresh(coeff, beta, act, idx, G, h_kernel,
                                  stale_sum)
        torch.cuda.synchronize()
        want = stale_agg_refresh_ref(coeff, beta, act, idx, G, h_plain,
                                     stale_sum)
        check(bool(torch.isfinite(delta).all()),
              f"stale_agg_refresh C={C}: the NaN padding slot leaked")
        # tolerance of the reference's kernel tests: rtol 2e-4, atol 2e-4 C
        err = (delta - want).abs()
        check(bool((err <= 2e-4 * C + 2e-4 * want.abs()).all()),
              f"stale_agg_refresh C={C} delta off by {err.max().item()}")
        worst = max(worst, err.max().item())
        check(torch.equal(h_kernel, h_plain),
              f"stale_agg_refresh C={C} P={P}: refreshed store not bitwise")
        check(torch.equal(h_kernel[untouched], kept),
              f"stale_agg_refresh C={C}: rows outside the refresh changed")
        del kept, want, err
        if P == MAIN_P or P in big:
            reps = dict(reps=50, warmup=10) if P == MAIN_P else \
                dict(reps=10, warmup=2)
            ms = time_ms(lambda: stale_agg_refresh(coeff, beta, act, idx, G,
                                                   h_kernel, stale_sum),
                         **reps)
            plain = time_ms(lambda: stale_agg_refresh_ref(
                coeff, beta, act, idx, G, h_plain, stale_sum), **reps)
            n_live = int(((coeff != 0) | (act != 0)).sum())
            n_act = int((act > 0).sum())
            b, by = bound_ms((2 * n_live + n_act + 2) * P * 4 + 4 * C * 4,
                             4 * n_live * P)
            shapes.append({"C": C, "N": N, "P": P, "ms": ms,
                           "plain_ms": plain, "bound_ms": b, "bound_by": by,
                           "library_ms": None})
        del G, h_kernel, h_plain, stale_sum, delta
        _free(torch)
    return worst, shapes


def attention_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask lets through: the work of one head."""
    n = 0
    for i in range(S):
        hi = i + 1 if causal else S
        lo = max(0, i - window + 1) if window > 0 else 0
        n += hi - lo
    return n


def kernel_flash_attention(torch, gen):
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    F = torch.nn.functional
    worst, shapes = 0.0, []
    for i, (B, H, Hk, S, D, window) in enumerate(K4_SHAPES):
        q = torch.randn(B, H, S, D, generator=gen, device="cuda")
        k = torch.randn(B, Hk, S, D, generator=gen, device="cuda")
        v = torch.randn(B, Hk, S, D, generator=gen, device="cuda")
        out = flash_attention(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        plain = lambda: attention_ref(q, k, v, causal=True, window=window)
        want = plain()
        # the reference's kernel bound: rtol 2e-3, atol 2e-3 (online vs
        # materialized softmax)
        err = (out - want).abs()
        check(bool((err <= 2e-3 + 2e-3 * want.abs()).all()),
              f"flash_attention {K4_SHAPES[i]} off by {err.max().item()}")
        worst = max(worst, err.max().item())
        if i >= 2:
            continue
        ms = time_ms(lambda: flash_attention(q, k, v, causal=True,
                                             window=window))
        plain_ms = time_ms(plain)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        pairs = attention_pairs(S, True, window)
        b, by = bound_ms((2 * B * H + 2 * B * Hk) * S * D * 4,
                         4 * B * H * pairs * D)
        shapes.append({"B": B, "H": H, "Hk": Hk, "S": S, "D": D,
                       "window": window, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b, "bound_by": by, "library_ms": lib})
    return worst, shapes


def kernel_selective_scan(torch, gen):
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.selective_scan.selective_scan import \
        selective_scan
    worst, shapes = 0.0, []
    F = torch.nn.functional
    for i, (Bsz, S, di, N, G) in enumerate(K5_SHAPES):
        r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
        u, Bm, Cm = r(Bsz, S, di), r(Bsz, S, N), r(Bsz, S, N)
        dt = F.softplus(r(Bsz, S, di) - 1)
        A, D = -torch.exp(r(G, di, N)), r(G, di)
        y = selective_scan(u, dt, Bm, Cm, A, D)
        torch.cuda.synchronize()
        plain = lambda: selective_scan_ref(u, dt, Bm, Cm, A, D)
        want = plain()
        # the reference's kernel bound: rtol 1e-4, atol 1e-4
        err = (y - want).abs()
        check(bool((err <= 1e-4 + 1e-4 * want.abs()).all()),
              f"selective_scan {K5_SHAPES[i]} off by {err.max().item()}")
        worst = max(worst, err.max().item())
        if i >= 2:
            continue
        ms = time_ms(lambda: selective_scan(u, dt, Bm, Cm, A, D))
        plain_ms = time_ms(plain, reps=5, warmup=1)
        b, by = bound_ms((3 * Bsz * S * di + 2 * Bsz * S * N
                          + G * di * (N + 1)) * 4,
                         Bsz * S * di * (7 * N + 3))
        # no single PyTorch call computes the selective scan
        shapes.append({"Bsz": Bsz, "S": S, "di": di, "N": N, "G": G,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                       "bound_by": by, "library_ms": None})
    return worst, shapes


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the port's four kernel launch sites to their plain versions
    (the comparison runs of phases 4 and 5; the port itself has no such
    switch)."""
    from repro_torch.core.methods import stale_family
    from repro_torch.kernels.batched_dot import ops as bd_ops
    from repro_torch.kernels.batched_dot.ref import batched_dot_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.selective_scan import ops as ss_ops
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    from repro_torch.kernels.stale_agg.ref import stale_agg_refresh_ref
    sites = ((bd_ops, "batched_dot", batched_dot_ref),
             (stale_family, "stale_agg_refresh", stale_agg_refresh_ref),
             (fa_ops, "flash_attention", attention_ref),
             (ss_ops, "selective_scan", selective_scan_ref))
    saved = [getattr(mod, name) for mod, name, _ in sites]
    for mod, name, plain in sites:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for (mod, name, _), fn in zip(sites, saved):
            setattr(mod, name, fn)


def spec(method: str, rounds: int):
    from repro_torch.fl.experiments import ExperimentSpec
    return ExperimentSpec(method=method, n_models=3, n_clients=MAIN_N,
                          rounds=rounds, eval_every=rounds)


def check_finite(torch, out, method: str) -> None:
    import numpy as np
    for k, v in out["metrics"].items():
        check(bool(np.isfinite(v).all()), f"{method}: metric {k} not finite")
    for g, w in enumerate(out["state"].params):
        check(bool(torch.isfinite(w).all()), f"{method}: params of group "
              f"{g} not finite")
    check(all(math.isfinite(a) for a in out["final_acc"]),
          f"{method}: accuracy not finite")


# device kernel names of each ported kernel, as the profiler lists them
KERNEL_KEYS = {
    "batched_dot": ("batched_dot_partial_kernel", "batched_dot_final_kernel"),
    "stale_agg_refresh": ("stale_agg_refresh_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "selective_scan": ("selective_scan_kernel",),
}


def profile_round(torch, engine, state, method: str, out_dir: Path,
                  kernels=("batched_dot", "stale_agg_refresh")):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = engine.round_step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    # device-side events only (kernels, memcpy/memset): host ops also carry
    # the device time of the kernels they launched
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0), reverse=True)
    busy_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"profile_{method}.txt", "w") as f:
        f.write(f"round wall {wall * 1e3:.3f} ms (under the profiler), "
                f"device busy {busy_us / 1e3:.3f} ms in {launches} device "
                f"events\n")
        for dev_us, count, key in rows:
            f.write(f"{dev_us:12.1f} us {count:6d}  {key[:160]}\n")
    names = [r[2] for r in rows]
    # in-situ device time per launch of each kernel in this round
    per_launch = {}
    for kernel in kernels:
        keys = KERNEL_KEYS[kernel]
        hits = [r for r in rows if any(k in r[2] for k in keys)]
        check(any(keys[0] in n for n in names),
              f"{method}: the profiler saw no {kernel} kernel in a round")
        n = max(r[1] for r in hits)
        per_launch[kernel] = sum(r[0] for r in hits) / n / 1e3
    return state, {"round_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
                   "device_idle_share": 1.0 - busy_us / 1e3 / (wall * 1e3),
                   "device_events": launches,
                   "kernel_device_ms_per_launch": per_launch,
                   "top": [[r[2][:80], r[0] / 1e3] for r in rows[:8]]}


def main_path(torch, out_dir: Path):
    import numpy as np
    from repro_torch.fl.experiments import run_experiment
    from repro_torch.kernels import launch_counts, reset_launch_counts

    runs = {}
    reset_launch_counts()
    for method in ("stalevre", "stalevr"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[method] = run_experiment(spec(method, 3))
        torch.cuda.synchronize()
        runs[method]["seconds"] = time.perf_counter() - t0
    launches = {k: launch_counts[k] for k in ("batched_dot",
                                              "stale_agg_refresh")}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the §6.1 path")

    report = {}
    for method, out in runs.items():
        eng = out["engine"]
        check(eng.device.type == "cuda", f"{method} did not run on the card")
        check([lay.P for lay in eng.layouts] == [MAIN_P],
              f"{method}: P = {[lay.P for lay in eng.layouts]}")
        check(out["metrics"]["H1"].shape == (3, 3)
              and out["metrics"]["beta"].shape == (3, 3, MAIN_N),
              f"{method}: metric shapes {out['metrics']['H1'].shape}, "
              f"{out['metrics']['beta'].shape}")
        check_finite(torch, out, method)
        state, prof = profile_round(torch, eng, out["state"], method,
                                    out_dir)
        # steady rounds, host clock around synchronized rounds
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            state, _ = eng.round_step(state)
        torch.cuda.synchronize()
        rps = 3 / (time.perf_counter() - t0)
        # rounds 0-1 against the plain kernel versions on the card
        before = dict(launch_counts)
        with plain_kernels():
            plain = run_experiment(spec(method, 2))
        check(dict(launch_counts) == before,
              "the plain comparison run launched a kernel")
        for k in ("H1", "Zp", "Zl", "loss", "beta"):
            got, want = out["metrics"][k][:2], plain["metrics"][k][:2]
            check(np.allclose(got, want, rtol=1e-4, atol=1e-6),
                  f"{method} metric {k}: kernels vs plain versions differ "
                  f"by {np.abs(got - want).max()}")
        check(np.array_equal(out["metrics"]["active"][:2],
                             plain["metrics"]["active"][:2]),
              f"{method}: participation draws differ from the plain run")
        report[method] = {"rounds_per_s": rps,
                          "run_experiment_s": out["seconds"],
                          "final_acc": out["final_acc"], **prof}
        print(f"main path {method}: {rps:.3f} rounds/s steady, "
              f"run_experiment(3 rounds) {out['seconds']:.2f} s, "
              f"profiled round {prof['round_ms']:.1f} ms wall, "
              f"{prof['device_busy_ms']:.1f} ms device busy", flush=True)
    return launches, report


def model_engine(method: str):
    """The real-model world of ``build_model_setting`` at the archs'
    published widths, depth cut (``MODEL_LAYERS``), on the card."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import RoundEngine, ServerConfig
    from repro_torch.fl.experiments import build_model_setting
    cfgs = {n: dataclasses.replace(get_config(n), n_layers=L)
            for n, L in MODEL_LAYERS.items()}
    tasks, B, avail = build_model_setting(
        MODEL_ARCHS, n_clients=MODEL_CLIENTS, cap=MODEL_CAP,
        seq_len=MODEL_SEQ, cfgs=cfgs)
    return RoundEngine(tasks, B, avail,
                       ServerConfig(method=method, active_rate=0.5,
                                    **MODEL_SERVER))


def model_rounds(torch, eng, n: int):
    """Fresh state, ``n`` synchronized rounds: (state, per-round metrics as
    numpy, per-round seconds)."""
    state = eng.init_state()
    mets, secs = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = eng.round_step(state)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        mets.append({k: v.cpu().numpy() for k, v in m.items()})
    return state, mets, secs


def model_path(torch, out_dir: Path):
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    methods = ("lvr", "stalevre")
    runs, report = {}, {}
    reset_launch_counts()
    for method in methods:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = model_engine(method)
        check([lay.P for lay in eng.layouts] == list(MODEL_P.values()),
              f"model world {method}: P = {[l.P for l in eng.layouts]}")
        state, mets, secs = model_rounds(torch, eng, 3)
        accs = eng.evaluate(state)
        state, prof = profile_round(
            torch, eng, state, f"model_{method}", out_dir,
            kernels=("flash_attention", "selective_scan")
            + (("batched_dot", "stale_agg_refresh")
               if method == "stalevre" else ()))
        for g, w in enumerate(state.params):
            check(bool(torch.isfinite(w).all()),
                  f"model world {method}: params of group {g} not finite")
        for m in mets:
            for k, v in m.items():
                check(bool(np.isfinite(v).all()),
                      f"model world {method}: metric {k} not finite")
        check(mets[0]["H1"].shape == (3,) and mets[0]["active"].shape[1] == 3,
              f"model world {method}: metric shapes")
        check(all(math.isfinite(a) for a in accs),
              f"model world {method}: accuracy not finite")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        del state
        _free(torch)
        runs[method] = (eng, mets)
        steady = (len(secs) - 1) / sum(secs[1:])
        report[method] = {"rounds_per_s": steady, "round_s": secs,
                          "wall_s": time.perf_counter() - t0,
                          "peak_memory_gb": peak_gb,
                          "peak_reserved_gb": reserved_gb, "accuracy": accs,
                          **prof}
        print(f"model path {method}: rounds "
              f"{', '.join(f'{t:.2f}' for t in secs)} s ({steady:.3f} "
              f"rounds/s steady over rounds 1-2), profiled round "
              f"{prof['round_ms']:.1f} ms wall, {prof['device_busy_ms']:.1f} "
              f"ms device busy (idle {prof['device_idle_share']:.3f}), peak "
              f"{peak_gb:.1f} GB allocated, {reserved_gb:.1f} GB reserved",
              flush=True)
    launches = {k: launch_counts[k] for k in KERNEL_KEYS}
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the model path")

    # rounds 0-1 against the same rounds with the four plain versions
    for method in methods:
        eng, mets = runs[method]
        with plain_kernels():
            state, plain, _ = model_rounds(torch, eng, 2)
        del state
        _free(torch)
        worst = 0.0
        for r in range(2):
            check(np.array_equal(mets[r]["active"], plain[r]["active"]),
                  f"model world {method} round {r}: participation draws "
                  f"differ from the plain run")
            for k in ("H1", "Zp", "Zl", "loss", "beta"):
                if k not in mets[r]:
                    continue
                got, want = mets[r][k], plain[r][k]
                worst = max(worst, float(np.abs(got - want).max()))
                check(np.allclose(got, want, rtol=1e-4, atol=1e-5),
                      f"model world {method} round {r} metric {k}: kernels "
                      f"vs plain versions differ by "
                      f"{np.abs(got - want).max()}")
        report[method]["plain_max_abs_diff"] = worst
    check({k: launch_counts[k] for k in KERNEL_KEYS} == launches,
          "the plain comparison runs launched a kernel")
    print(f"model path: rounds 0-1 equal the plain-version runs (draws "
          f"exact, metrics within rtol 1e-4 / atol 1e-5; worst "
          f"{max(r['plain_max_abs_diff'] for r in report.values()):.3g})",
          flush=True)
    return launches, report


def golden_check(torch) -> None:
    """tests/golden_engine.json (the reference's pinned trajectories) on
    the card, at the golden test's own tolerance (rtol 2e-3, atol 1e-3)."""
    from repro_torch.core.engine import RoundEngine, ServerConfig
    from repro_torch.fl.experiments import build_setting
    golden = json.loads((ROOT / "tests" / "golden_engine.json").read_text())
    for method in ("lvr", "stalevre"):
        tasks, B, avail = build_setting(n_models=2, n_clients=16, seed=0,
                                        small=True)
        eng = RoundEngine(tasks, B, avail,
                          ServerConfig(method=method, local_epochs=2,
                                       seed=1))
        state = eng.init_state()
        for want in golden[method]:
            state, mets = eng.round_step(state)
            for key, v in want.items():
                if key == "round":
                    continue
                name, s = key.split("/")
                got = float(mets[name][int(s)])
                check(abs(got - v) <= 1e-3 + 2e-3 * abs(v),
                      f"golden {method} round {want['round']} {key}: "
                      f"{got} vs {v}")
    print("golden_engine.json reproduced on the card (lvr, stalevre)",
          flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="results/chip_smoke",
                        help="directory for the profiler tables and report "
                             "(relative to the checkout root)")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found: run "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    t_start = time.perf_counter()

    # 1. the card, and f32 without TF32 (the reference computes in f32)
    print(gpu_line(), flush=True)
    print(f"PYTORCH_CUDA_ALLOC_CONF="
          f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF', '(unset)')}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build the kernels from the checkout's sources, in parallel: one
    # nvcc per CUDA source, and the Triton kernel's JIT
    from repro_torch.kernels.batched_dot.batched_dot import batched_dot
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.selective_scan import selective_scan
    from repro_torch.kernels.stale_agg import stale_agg
    t0 = time.perf_counter()

    def warm_triton():
        x = torch.ones(2, MAIN_P, device="cuda")
        batched_dot(x, x)
        batched_dot(x[:, :1001].contiguous(), x[:, :1001].contiguous())
        batched_dot(x[:, :1].contiguous(), x[:, :1].contiguous())
        torch.cuda.synchronize()

    cuda_kernels = (("stale_agg_refresh", stale_agg),
                    ("flash_attention", flash_attention),
                    ("selective_scan", selective_scan))
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        builds = [(name, pool.submit(mod.build)) for name, mod in cuda_kernels]
        tri = pool.submit(warm_triton)
        lib_paths = {name: fut.result() for name, fut in builds}
        tri.result()
    print(f"built {', '.join(lib_paths)} (nvcc) and batched_dot (Triton) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in lib_paths.items():
        print(f"== nvcc report of {name} ({path.relative_to(ROOT)})",
              flush=True)
        print((path.parent / "nvcc.log").read_text().strip(), flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    checked = {}
    for name, fn in (("batched_dot", kernel_batched_dot),
                     ("stale_agg_refresh", kernel_stale_agg_refresh),
                     ("flash_attention", kernel_flash_attention),
                     ("selective_scan", kernel_selective_scan)):
        checked[name] = fn(torch, gen)
        print(json.dumps({"kernel": name, "max_abs_err": checked[name][0],
                          "shapes": checked[name][1]}), flush=True)
    print("kernels agree with their plain versions: " + ", ".join(
        f"{n} max abs err {e:.3g}" for n, (e, _) in checked.items())
        + " (stale_agg_refresh store bitwise)", flush=True)

    # 4. the §6.1 path, 5. the real-model path, 6. the reference's goldens
    out_dir = ROOT / args.out
    launches, report = main_path(torch, out_dir)
    model_launches, model_report = model_path(torch, out_dir)
    golden_check(torch)

    kernels = []
    for name, route, source, replaces in (
            ("batched_dot", "triton",
             "src/repro_torch/kernels/batched_dot/batched_dot.py",
             "src/repro/kernels/batched_dot/batched_dot.py:40"),
            ("stale_agg_refresh", "cuda",
             "src/repro_torch/kernels/stale_agg/stale_agg_refresh.cu",
             "src/repro/kernels/stale_agg/stale_agg.py:98"),
            ("flash_attention", "cuda",
             "src/repro_torch/kernels/flash_attention/flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:74"),
            ("selective_scan", "cuda",
             "src/repro_torch/kernels/selective_scan/selective_scan.cu",
             "src/repro/kernels/selective_scan/selective_scan.py:50")):
        err, shapes = checked[name]
        # K1/K2: the §6.1 stalevre shape (C = 24); K4/K5: the model
        # path's cohort local-SGD shape
        main = shapes[0]
        in_situ = {f"model_{m}": model_report[m][
            "kernel_device_ms_per_launch"].get(name) for m in model_report}
        if name in launches:
            in_situ.update({m: report[m]["kernel_device_ms_per_launch"][name]
                            for m in report})
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces,
            "launches": launches.get(name, 0) + model_launches[name],
            "launches_by_path": {"section_6_1": launches.get(name, 0),
                                 "model_world": model_launches[name]},
            "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": shapes, "main_path_device_ms_per_launch": in_situ})
    (out_dir / "report.json").write_text(json.dumps(
        {"gpu": gpu_line(), "kernels": kernels, "main_path": report,
         "model_path": model_report}, indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
