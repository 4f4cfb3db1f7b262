#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--out DIR]

Run from the root of a checkout, on a machine with one CUDA GPU (Hopper:
the CUDA kernel is built for sm_90a).  Every phase is fatal: the script
exits non-zero, and prints no result line, when there is no GPU, when it
does not find the port beside it, or when any check fails.

Phases:
  1. the card's name and power limit (nvidia-smi) and the TF32 flags,
     which are switched off: the reference computes in f32;
  2. build the kernels from the sources in the checkout, in parallel:
     ``stale_agg_refresh`` (CUDA C++, nvcc) and ``batched_dot`` (Triton);
  3. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes and at a ragged one, and time kernel, plain
     version and (where one exists) the one-call PyTorch equivalent;
  4. the main path: ``run_experiment`` of the §6.1 3-model world (3 CNN
     tasks, 120 clients, P = 103,018 parameters per model) for
     ``stalevre`` and ``stalevr`` on the card, with every kernel's launch
     count set to 0 before and read after; one more round of each under
     ``torch.profiler``, which must show both kernels; rounds 0-1 held
     against the same rounds run with the plain versions on the card;
  5. the reference's own check: ``tests/golden_engine.json`` reproduced on
     the card (lvr and stalevre, 3 rounds of the small 2-model world);
  6. one JSON line ``{"kernels": [...]}``, then the last line
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


def kernel_batched_dot(torch, gen):
    from repro_torch.kernels.batched_dot.batched_dot import batched_dot
    from repro_torch.kernels.batched_dot.ref import batched_dot_ref
    worst, shapes = 0.0, []
    for C, P in [(MAIN_C[0], MAIN_P), (MAIN_C[1], MAIN_P), (7, 1001),
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
        if P != MAIN_P:
            continue
        ms = time_ms(lambda: batched_dot(G, h))
        plain = time_ms(lambda: batched_dot_ref(G, h))
        lib = time_ms(lambda: (torch.linalg.vecdot(G, h),
                               torch.linalg.vecdot(h, h)))
        b, by = bound_ms(2 * C * P * 4 + 2 * C * 4, 4 * C * P)
        shapes.append({"C": C, "P": P, "ms": ms, "plain_ms": plain,
                       "bound_ms": b, "bound_by": by, "library_ms": lib})
    return worst, shapes


def kernel_stale_agg_refresh(torch, gen):
    from repro_torch.kernels.stale_agg.ref import stale_agg_refresh_ref
    from repro_torch.kernels.stale_agg.stale_agg import stale_agg_refresh
    worst, shapes = 0.0, []
    for C, N, P in [(MAIN_C[0], MAIN_N, MAIN_P), (MAIN_C[1], MAIN_N, MAIN_P),
                    (5, 9, 1001)]:
        G = torch.randn(C, P, generator=gen, device="cuda")
        h = torch.randn(N, P, generator=gen, device="cuda")
        idx = torch.randperm(N, generator=gen, device="cuda")[:C]
        coeff = torch.rand(C, generator=gen, device="cuda") * 2
        beta = torch.rand(C, generator=gen, device="cuda")
        act = (torch.rand(C, generator=gen, device="cuda") > 0.3).float()
        # one cohort padding slot: coeff 0, act 0 and a NaN update row
        coeff[C // 2], act[C // 2] = 0.0, 0.0
        G[C // 2, : max(1, P // 3)] = float("nan")
        act[0] = 1.0
        stale_sum = torch.randn(P, generator=gen, device="cuda")
        h_kernel, h_plain = h.clone(), h.clone()
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
              f"stale_agg_refresh C={C}: refreshed store not bitwise")
        untouched = torch.ones(N, dtype=torch.bool, device="cuda")
        untouched[idx] = False
        untouched[idx[act == 0]] = True
        check(torch.equal(h_kernel[untouched], h[untouched]),
              f"stale_agg_refresh C={C}: rows outside the refresh changed")
        if P != MAIN_P:
            continue
        ms = time_ms(lambda: stale_agg_refresh(coeff, beta, act, idx, G,
                                               h_kernel, stale_sum))
        plain = time_ms(lambda: stale_agg_refresh_ref(
            coeff, beta, act, idx, G, h_plain, stale_sum))
        n_live = int(((coeff != 0) | (act != 0)).sum())
        n_act = int((act > 0).sum())
        b, by = bound_ms((2 * n_live + n_act + 2) * P * 4 + 4 * C * 4,
                         4 * n_live * P)
        shapes.append({"C": C, "N": N, "P": P, "ms": ms, "plain_ms": plain,
                       "bound_ms": b, "bound_by": by, "library_ms": None})
    return worst, shapes


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_kernels():
    """Route the port's two kernel ops to their plain versions (the
    comparison run of phase 4; the port itself has no such switch)."""
    from repro_torch.core.methods import stale_family
    from repro_torch.kernels.batched_dot import ops as bd_ops
    from repro_torch.kernels.batched_dot.ref import batched_dot_ref
    from repro_torch.kernels.stale_agg.ref import stale_agg_refresh_ref
    saved = bd_ops.batched_dot, stale_family.stale_agg_refresh
    bd_ops.batched_dot, stale_family.stale_agg_refresh = (
        batched_dot_ref, stale_agg_refresh_ref)
    try:
        yield
    finally:
        bd_ops.batched_dot, stale_family.stale_agg_refresh = saved


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


def profile_round(torch, engine, state, method: str, out_dir: Path):
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
    for kernel, keys in (("batched_dot", ("batched_dot_partial_kernel",
                                          "batched_dot_final_kernel")),
                         ("stale_agg_refresh", ("stale_agg_refresh_kernel",))):
        hits = [r for r in rows if any(k in r[2] for k in keys)]
        n = max((r[1] for r in hits), default=0)
        per_launch[kernel] = (sum(r[0] for r in hits) / n / 1e3) if n else 0.0
    check(any("batched_dot_partial_kernel" in n for n in names),
          f"{method}: the profiler saw no batched_dot kernel in a round")
    check(any("stale_agg_refresh_kernel" in n for n in names),
          f"{method}: the profiler saw no stale_agg_refresh kernel")
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
    launches = dict(launch_counts)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)

    # 2. build both kernels from the checkout's sources, in parallel
    from repro_torch.kernels.batched_dot.batched_dot import batched_dot
    from repro_torch.kernels.stale_agg import stale_agg
    t0 = time.perf_counter()

    def warm_triton():
        x = torch.ones(2, MAIN_P, device="cuda")
        batched_dot(x, x)
        batched_dot(x[:, :1001].contiguous(), x[:, :1001].contiguous())
        batched_dot(x[:, :1].contiguous(), x[:, :1].contiguous())
        torch.cuda.synchronize()

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        so = pool.submit(stale_agg.build)
        tri = pool.submit(warm_triton)
        lib_path = so.result()
        tri.result()
    print(f"built stale_agg_refresh ({lib_path.relative_to(ROOT)}) and "
          f"batched_dot (Triton) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print((lib_path.parent / "nvcc.log").read_text().strip(), flush=True)

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    bd_err, bd_shapes = kernel_batched_dot(torch, gen)
    sa_err, sa_shapes = kernel_stale_agg_refresh(torch, gen)
    print(f"kernels agree with their plain versions: batched_dot max abs "
          f"err {bd_err:.3g}, stale_agg_refresh {sa_err:.3g} (store "
          f"bitwise)", flush=True)
    for name, err, shapes in (("batched_dot", bd_err, bd_shapes),
                              ("stale_agg_refresh", sa_err, sa_shapes)):
        print(json.dumps({"kernel": name, "max_abs_err": err,
                          "shapes": shapes}), flush=True)

    # 4. the main path, 5. the reference's goldens
    out_dir = ROOT / args.out
    launches, report = main_path(torch, out_dir)
    golden_check(torch)

    kernels = []
    for name, route, source, replaces, err, shapes in (
            ("batched_dot", "triton",
             "src/repro_torch/kernels/batched_dot/batched_dot.py",
             "src/repro/kernels/batched_dot/batched_dot.py:40", bd_err,
             bd_shapes),
            ("stale_agg_refresh", "cuda",
             "src/repro_torch/kernels/stale_agg/stale_agg_refresh.cu",
             "src/repro/kernels/stale_agg/stale_agg.py:98", sa_err,
             sa_shapes)):
        main = shapes[0]           # the stalevre shape, C = 24
        in_situ = {m: report[m]["kernel_device_ms_per_launch"][name]
                   for m in report}
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shapes": shapes, "main_path_device_ms_per_launch": in_situ})
    (out_dir / "report.json").write_text(json.dumps(
        {"gpu": gpu_line(), "kernels": kernels, "main_path": report},
        indent=1))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
