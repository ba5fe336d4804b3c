"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order (any failure exits non-zero and prints no result):

1. build    — compile every CUDA source under src/repro_torch/csrc/, one
              nvcc per source, all started together; time the build.
2. kernels  — hold each kernel against its plain PyTorch version on the
              card, at the main path's shapes and at small shapes, and
              time kernel, plain version and one library call beside the
              kernel's bound (bytes over 3.35 TB/s or FLOPs over
              67 TFLOP/s f32, whichever is larger).
3. main     — repro_torch.Simulator(build_circuit("qft", 26),
              EngineConfig()).run() on cuda:0 (host codec, default
              planning), with every launch count set to 0 just before
              and read just after; fidelity against the port's dense
              oracle computed on the card, then sample(1024) and one
              expectation as readout.  With --profile the run is traced
              with torch.profiler (CUDA activity only) and a main_profile
              line gives device time by kernel and the device's idle
              share of the run's wall time.
4. report   — one JSON line of kernels, the card's name and power limit,
              and last the ok line.

It imports nothing of JAX and nothing of the JAX package.  Without CUDA,
or without the repository around it, it exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_QUBITS = 26
FIDELITY_MIN = 0.99
RTOL, ATOL = 1e-5, 1e-6          # f32 summation order differs from cuBLAS
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 2: gemm_planes_batch against its plain version ---------------------

def gemm_case(L: int, R: int, K: int, broadcast: bool, seed: int,
              timed: bool) -> dict:
    """One shape of gemm_planes_batch on the card: agreement with the
    plain version, and (when ``timed``) kernel / plain / library times
    beside the bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.gate_apply import gemm_planes_batch
    from repro_torch.kernels.ref import gemm_planes_batch_ref

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    planes = torch.randn((L, 2, R * K), generator=g, device=dev)
    ar = planes[:, 0].reshape(L, R, K)           # lane stride 2RK, as a wave
    ai = planes[:, 1].reshape(L, R, K)
    U = torch.randn((1 if broadcast else L, 2, K, K), generator=g,
                    device=dev) / np.sqrt(K)
    if broadcast:                                # one U, lane stride 0
        U = U.expand(L, 2, K, K)
    br, bi = U[:, 0].transpose(1, 2), U[:, 1].transpose(1, 2)   # U^T views
    cr, ci = gemm_planes_batch(ar, ai, br, bi)
    rr, ri = gemm_planes_batch_ref(ar, ai, br, bi)
    torch.cuda.synchronize()
    err = max(float((cr - rr).abs().max()), float((ci - ri).abs().max()))
    ok = (torch.allclose(cr, rr, rtol=RTOL, atol=ATOL)
          and torch.allclose(ci, ri, rtol=RTOL, atol=ATOL))
    out = {"L": L, "R": R, "K": K, "broadcast": broadcast,
           "max_abs_err": err, "ok": bool(ok)}
    if not timed:
        return out
    n_b = 1 if broadcast else L
    bytes_moved = 4 * (2 * L * R * K + 2 * n_b * K * K + 2 * L * R * K)
    flops = 8 * L * R * K * K
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOP_PER_S * 1e3
    ac = torch.complex(ar, ai)
    bc = torch.complex(br, bi)
    out.update(
        ms=cuda_ms(lambda: gemm_planes_batch(ar, ai, br, bi)),
        plain_ms=cuda_ms(lambda: gemm_planes_batch_ref(ar, ai, br, bi)),
        library_ms=cuda_ms(lambda: torch.matmul(ac, bc)),
        bound_ms=max(t_bytes, t_flops),
        bound_by="bytes" if t_bytes >= t_flops else "operations",
        bytes=bytes_moved, flops=flops)
    return out


def kernel_phase() -> dict:
    main_shapes = [(2, (1 << 22) // K, K) for K in (16, 32)]
    small = [(3, 5, 2, False), (1, 7, 4, True), (2, 64, 8, False),
             (3, 33, 16, True), (2, 100, 32, False), (2, 40, 64, True),
             (3, 9, 128, False)]
    cases = []
    for i, (L, R, K) in enumerate(main_shapes):
        cases.append(gemm_case(L, R, K, True, seed=i, timed=True))
    for i, (L, R, K, bc) in enumerate(small):
        cases.append(gemm_case(L, R, K, bc, seed=100 + i, timed=False))
    for c in cases:
        print("kernel_check gemm_planes_batch " + json.dumps(c), flush=True)
        if not c["ok"]:
            fail(f"gemm_planes_batch disagrees with its plain version at "
                 f"L={c['L']} R={c['R']} K={c['K']}: max abs err "
                 f"{c['max_abs_err']:.3e} (rtol {RTOL}, atol {ATOL})")
    return {"gemm_planes_batch": cases}


# -- phase 3: the main path ---------------------------------------------------

def device_profile(prof, wall_s: float) -> dict:
    """Device time by kernel name from a CUDA-activity trace, and the
    share of ``wall_s`` the device spent idle (one stream: the busy times
    do not overlap)."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    return {"device_busy_ms": busy_ms, "wall_s": wall_s,
            "idle_share": 1.0 - busy_ms / 1e3 / wall_s,
            "top": [{"name": k[:80], "ms": ms, "count": c}
                    for k, ms, c in rows[:12]]}


def main_phase(profile: bool) -> dict:
    import numpy as np
    import torch
    from repro_torch import (EngineConfig, Simulator, build_circuit,
                             fidelity, zsum_cost_fn)
    from repro_torch.core.dense_engine import simulate_dense
    from repro_torch.kernels import gate_apply

    circuit = build_circuit("qft", MAIN_QUBITS)
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(circuit, EngineConfig())
    plan = sim.compile()
    print(f"main_plan qft-{MAIN_QUBITS} local_bits={plan.local_bits} "
          f"stages={plan.n_stages} depth={plan.pipeline_depth} "
          f"device={sim._engine.device}", flush=True)
    trace = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        trace = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    gate_apply.reset_launch_counts()
    with trace as prof:
        t0 = time.perf_counter()
        result = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(gate_apply.launch_counts)
    st = sim.stats
    peak_dev = torch.cuda.max_memory_allocated()
    print("main_stats " + json.dumps({
        "wall_s": wall, "t_total": st.t_total, "t_compute": st.t_compute,
        "t_decompress": st.t_decompress, "t_compress": st.t_compress,
        "t_fetch": st.t_fetch, "h2d_bytes": st.h2d_bytes,
        "d2h_bytes": st.d2h_bytes, "peak_ram_bytes": st.peak_ram_bytes,
        "memory_reduction": st.memory_reduction,
        "max_memory_allocated": peak_dev, "launches": launches}),
        flush=True)
    if profile:
        print("main_profile " + json.dumps(device_profile(prof, wall)),
              flush=True)
    if launches["gemm_planes_batch"] <= 0:
        fail("the main path launched gemm_planes_batch no time")

    t0 = time.perf_counter()
    state = torch.from_numpy(result.statevector()).to("cuda:0")
    ideal = simulate_dense(circuit, device="cuda:0")
    fid = fidelity(ideal, state)
    t_oracle = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.view_as_real(state)).all())
    del state, ideal
    counts = result.sample(1024, seed=0)
    zsum = result.expectation(zsum_cost_fn(MAIN_QUBITS))
    print("main_check " + json.dumps({
        "fidelity": fid, "finite": finite, "oracle_s": t_oracle,
        "shots": int(sum(counts.values())), "distinct": len(counts),
        "zsum": zsum}), flush=True)
    sim.close()
    if not finite:
        fail("the final state holds non-finite amplitudes")
    if not fid >= FIDELITY_MIN:
        fail(f"fidelity {fid} < {FIDELITY_MIN} against the dense oracle")
    if sum(counts.values()) != 1024 or not np.isfinite(zsum):
        fail("readout returned a malformed sample or expectation")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main path's device time")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        import torch
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the repository root")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    try:
        log = build.build_all()
    except RuntimeError as e:
        fail(str(e))
    print(f"build_s {time.perf_counter() - t0:.3f}", flush=True)
    for name, (secs, text) in log.items():
        regs = [ln.strip() for ln in text.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"build {name} {secs:.3f}s " + " | ".join(regs[:14]),
              flush=True)

    checks = kernel_phase()
    launches = main_phase(args.profile)

    main_k32 = next(c for c in checks["gemm_planes_batch"] if c["K"] == 32)
    worst = max(c["max_abs_err"] for c in checks["gemm_planes_batch"])
    kernels = [{
        "name": "gemm_planes_batch", "route": "cuda",
        "source": "src/repro_torch/csrc/gate_apply.cu",
        "replaces": "src/repro/kernels/gate_apply.py:112",
        "launches": launches["gemm_planes_batch"],
        "max_abs_err": worst, "ms": main_k32["ms"],
        "plain_ms": main_k32["plain_ms"], "bound_ms": main_k32["bound_ms"],
        "bound_by": main_k32["bound_by"],
        "library_ms": main_k32["library_ms"]}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
