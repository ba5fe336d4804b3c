"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--device-qubits N]

Phases, in order (any failure exits non-zero and prints no result):

1. build       — compile every CUDA source under src/repro_torch/csrc/,
                 one nvcc per source, all started together; time the build.
2. kernels     — hold each kernel against its plain PyTorch version on the
                 card, at the main paths' shapes and at small (for the
                 codec: ragged) shapes, and time kernel, plain version and
                 (where one exists) one library call beside the kernel's
                 bound (bytes over 3.35 TB/s or operations over 67 TFLOP/s
                 f32, whichever is larger).
3. main        — repro_torch.Simulator(build_circuit("qft", 26),
                 EngineConfig()).run() on cuda:0 (host codec, default
                 planning).
4. main_device — repro_torch.Simulator(build_circuit("qft", 28),
                 EngineConfig(codec_backend="device")).run() on cuda:0
                 (--device-qubits sets another size, e.g. 26 to compare
                 the two codecs at one size):
                 the codec runs in the encode/decode kernels, and the
                 boundary bytes must equal the plan's wire bytes.
                 Each main path runs with every launch count set to 0 just
                 before and read just after; fidelity against the port's
                 dense oracle computed on the card, then sample(1024) and
                 one expectation as readout.  With --profile each run is
                 traced with torch.profiler (CUDA activity only) and a
                 *_profile line gives device time by kernel and the
                 device's idle share of the run's wall time.
5. report      — one JSON line of kernels, the card's name and power
                 limit, and last the ok line.

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
MAIN_QUBITS = 26                 # host codec path
DEVICE_QUBITS = 28               # device codec path
FIDELITY_MIN = 0.99
RTOL, ATOL = 1e-5, 1e-6          # f32 summation order differs from cuBLAS
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
# the codec kernels against their plain versions (ROADMAP "The pwrel
# tolerance"): log2f is accurate to 1 ulp, so a code may differ by 1 at a
# rounding tie, in at most 0.1% of elements; exp2f to 2 ulp
B_R = 1e-3
CODE_DIFF_SHARE = 1e-3
DECODE_RTOL = 1e-6
ROUNDTRIP_BOUND = 1.01 * B_R     # b_r + the f32 slack of ROADMAP C
CODEC_MAIN = (2, 4, 1 << 20)     # (rows, blocks per row, n): a qft-28 wave
CODEC_RAGGED = (77, 192, 1000, 4097)


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


# -- phase 2: the codec kernels against their plain versions -----------------

def codec_stack(R: int, nb: int, n: int, seed: int):
    """An (R, 2, nb*n) plane stack: its last plane all zeros, the one
    before state-like, the rest log-uniform over 60 octaves with random
    signs and 2% exact zeros."""
    import torch
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    P = 2 * R * nb
    x = torch.exp2(-60.0 * torch.rand((P, n), generator=g, device=dev))
    x = torch.where(torch.rand((P, n), generator=g, device=dev) < 0.5, -x, x)
    x[torch.rand((P, n), generator=g, device=dev) < 0.02] = 0.0
    z = torch.randn((2, n), generator=g, device=dev)
    x[P - 2] = z[0] / z.norm()
    x[P - 1] = 0.0
    return x.reshape(R, nb, 2, n).transpose(1, 2).reshape(R, 2, nb * n) \
        .contiguous()


def codec_case(R: int, nb: int, n: int, seed: int, timed: bool) -> dict:
    """The fused encode and decode kernels at one shape: encode against its
    plain version (sign words and flags equal, codes within one), decode
    against its plain version on identical codes, encode -> decode within
    b_r; with ``timed``, kernel / plain times beside the bytes bound."""
    import torch
    from repro_torch.compression.pwrel import log_step
    from repro_torch.kernels import codec as kc
    from repro_torch.kernels import ref

    step = log_step(B_R)
    planes = codec_stack(R, nb, n, seed)
    P = 2 * R * nb
    l_max = kc.plane_l_max(planes, n)
    ck, sk, fk = kc.encode_planes(planes, n, l_max, step, flags_tile_rows=8)
    cr, sr, fr = ref.encode_planes_ref(planes, n, l_max, step, 8)
    dcode = ((ck.to(torch.int32) & 0xFFFF) - (cr.to(torch.int32) & 0xFFFF)) \
        .abs()
    out_k = torch.empty_like(planes)
    out_r = torch.empty_like(planes)
    kc.decode_planes(ck, sk, l_max, step, out_k, n)
    ref.decode_planes_ref(ck, sk, l_max, step, out_r, n)
    # through a plane map: wire plane j lands on stack plane P-1-j
    rev = torch.arange(P - 1, -1, -1, dtype=torch.int32, device=planes.device)
    back = rev.long()
    map_k = torch.empty_like(planes)
    map_r = torch.empty_like(planes)
    kc.decode_planes(ck[back].contiguous(), sk[back].contiguous(),
                     l_max[back].contiguous(), step, map_k, n, rev)
    ref.decode_planes_ref(ck[back], sk[back], l_max[back], step, map_r, n,
                          rev)
    torch.cuda.synchronize()
    nz = out_r != 0
    dec_rel = float(((out_k - out_r).abs()[nz] / out_r.abs()[nz]).max()) \
        if bool(nz.any()) else 0.0
    xnz = planes != 0
    trip = float(((out_k - planes).abs()[xnz] / planes.abs()[xnz]).max())
    out = {
        "R": R, "blocks": nb, "n": n, "planes": P,
        "max_code_diff": int(dcode.max()),
        "code_diff_share": float((dcode != 0).sum()) / (P * n),
        "signs_equal": bool(torch.equal(sk, sr)),
        "flags_equal": bool(torch.equal(fk, fr)),
        "decode_max_rel": dec_rel,
        "decode_max_abs": float((out_k - out_r).abs().max()),
        "decode_zeros_equal": bool(torch.equal(out_k[~nz], out_r[~nz])),
        "plane_map_max_rel": float(
            ((map_k - map_r).abs()[nz] / map_r.abs()[nz]).max())
        if bool(nz.any()) else 0.0,
        "roundtrip_max_rel": trip,
        "roundtrip_zeros": bool((out_k[~xnz] == 0).all()),
    }
    out["ok"] = (out["max_code_diff"] <= 1
                 and out["code_diff_share"] <= CODE_DIFF_SHARE
                 and out["signs_equal"] and out["flags_equal"]
                 and dec_rel <= DECODE_RTOL and out["decode_zeros_equal"]
                 and out["plane_map_max_rel"] <= DECODE_RTOL
                 and trip <= ROUNDTRIP_BOUND and out["roundtrip_zeros"])
    if not timed:
        return out
    words = -(-n // 32)
    wire = P * (2 * n + 4 * words)           # u16 codes + sign words
    enc_bytes = P * 4 * n + P * 4 + wire     # planes and l_max in, wire out
    dec_bytes = wire + P * 4 + P * 4 * n     # wire and l_max in, planes out
    # f32 operations per element: encode abs, log2, sub, div, rint, sub,
    # two clips; decode sub, mul, sub, exp2 (the bytes bound is ~10x more)
    enc_ops, dec_ops = 8 * P * n, 4 * P * n

    def bound(nbytes, ops):
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        to = ops / F32_FLOP_PER_S * 1e3
        return max(tb, to), "bytes" if tb >= to else "operations"

    eb, eby = bound(enc_bytes, enc_ops)
    db, dby = bound(dec_bytes, dec_ops)
    out["encode"] = {
        "ms": cuda_ms(lambda: kc.encode_planes(planes, n, l_max, step)),
        "plain_ms": cuda_ms(
            lambda: ref.encode_planes_ref(planes, n, l_max, step)),
        "bound_ms": eb, "bound_by": eby, "bytes": enc_bytes}
    out["decode"] = {
        "ms": cuda_ms(
            lambda: kc.decode_planes(ck, sk, l_max, step, out_k, n)),
        "plain_ms": cuda_ms(
            lambda: ref.decode_planes_ref(ck, sk, l_max, step, out_r, n)),
        "bound_ms": db, "bound_by": dby, "bytes": dec_bytes}
    return out


def tiles_case(rows: int, tile_rows: int, seed: int) -> dict:
    """The TPU-layout wrappers quantize_tiles / dequantize_tiles (the same
    kernels with int32 codes) against their plain versions."""
    import torch
    from repro_torch.compression.pwrel import log_step
    from repro_torch.kernels import quantize as qz
    from repro_torch.kernels import ref

    step = log_step(B_R)
    x = codec_stack(1, 2, rows * 32, seed).reshape(rows, 128)
    l_max = torch.log2(x.abs().max()).reshape(1, 1)
    ck, pk, fk = qz.quantize_tiles(x, l_max, step, tile_rows=tile_rows)
    cr, pr, fr = ref.quantize_tiles_ref(x, l_max, step, tile_rows)
    dk = qz.dequantize_tiles(ck, pk, l_max, step)
    dr = ref.dequantize_tiles_ref(ck, pk, l_max, step)
    torch.cuda.synchronize()
    dcode = (ck - cr).abs()
    nz = dr != 0
    rel = float(((dk - dr).abs()[nz] / dr.abs()[nz]).max())
    out = {"rows": rows, "tile_rows": tile_rows,
           "max_code_diff": int(dcode.max()),
           "code_diff_share": float((dcode != 0).sum()) / x.numel(),
           "signs_equal": bool(torch.equal(pk, pr)),
           "flags_equal": bool(torch.equal(fk, fr)),
           "decode_max_rel": rel,
           "decode_zeros_equal": bool(torch.equal(dk[~nz], dr[~nz]))}
    out["ok"] = (out["max_code_diff"] <= 1
                 and out["code_diff_share"] <= CODE_DIFF_SHARE
                 and out["signs_equal"] and out["flags_equal"]
                 and rel <= DECODE_RTOL and out["decode_zeros_equal"])
    return out


def codec_phase() -> dict:
    cases = [codec_case(*CODEC_MAIN, seed=0, timed=True)]
    for i, n in enumerate(CODEC_RAGGED):
        cases.append(codec_case(1, 3, n, seed=10 + i, timed=False))
    for c in cases:
        print("kernel_check codec " + json.dumps(c), flush=True)
        if not c["ok"]:
            fail(f"the codec kernels disagree with their plain versions at "
                 f"n={c['n']}: {json.dumps(c)}")
    tiles = [tiles_case(r, 8, seed=20 + r) for r in (1, 8, 24, 33)]
    for c in tiles:
        print("kernel_check codec_tiles " + json.dumps(c), flush=True)
        if not c["ok"]:
            fail(f"quantize_tiles/dequantize_tiles disagree with their "
                 f"plain versions at rows={c['rows']}: {json.dumps(c)}")
    return {"codec": cases, "codec_tiles": tiles}


# -- phases 3 and 4: the main paths --------------------------------------------

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


def main_phase(label: str, qubits: int, backend: str,
               profile: bool) -> dict:
    """Drive Simulator(build_circuit("qft", qubits),
    EngineConfig(codec_backend=backend)).run() on cuda:0 with every launch
    count set to 0 just before and read just after; check the state
    against the dense oracle and read it out.  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch import (EngineConfig, Simulator, build_circuit,
                             fidelity, zsum_cost_fn)
    from repro_torch.core.dense_engine import simulate_dense
    from repro_torch.kernels import codec, gate_apply

    circuit = build_circuit("qft", qubits)
    torch.cuda.reset_peak_memory_stats()
    sim = Simulator(circuit, EngineConfig(codec_backend=backend))
    plan = sim.compile()
    print(f"{label}_plan qft-{qubits} codec={backend} "
          f"local_bits={plan.local_bits} stages={plan.n_stages} "
          f"depth={plan.pipeline_depth} device={sim._engine.device}",
          flush=True)
    trace = contextlib.nullcontext()
    if profile:
        from torch.profiler import ProfilerActivity
        trace = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
    gate_apply.reset_launch_counts()
    codec.reset_launch_counts()
    with trace as prof:
        t0 = time.perf_counter()
        result = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {**gate_apply.launch_counts, **codec.launch_counts}
    st = sim.stats
    peak_dev = torch.cuda.max_memory_allocated()
    print(f"{label}_stats " + json.dumps({
        "wall_s": wall, "t_total": st.t_total, "t_compute": st.t_compute,
        "t_decompress": st.t_decompress, "t_compress": st.t_compress,
        "t_fetch": st.t_fetch, "h2d_bytes": st.h2d_bytes,
        "d2h_bytes": st.d2h_bytes, "peak_ram_bytes": st.peak_ram_bytes,
        "memory_reduction": st.memory_reduction,
        "max_memory_allocated": peak_dev, "launches": launches}),
        flush=True)
    if profile:
        print(f"{label}_profile " + json.dumps(device_profile(prof, wall)),
              flush=True)
    want = ["gemm_planes_batch"] + (["encode", "decode"]
                                    if backend == "device" else [])
    for k in want:
        if launches[k] <= 0:
            fail(f"the {label} path launched {k} no time")
    # every block of every stage crosses once each way, as the plan prices
    # it (device codec: wire; a RAW-escape block would cross raw instead)
    wire = (sum(sp.est_h2d_bytes for sp in plan.stages if sp.plan),
            sum(sp.est_d2h_bytes for sp in plan.stages if sp.plan))
    if (st.h2d_bytes, st.d2h_bytes) != wire:
        fail(f"{label}: boundary bytes h2d {st.h2d_bytes} d2h "
             f"{st.d2h_bytes}, the plan's are {wire[0]} and {wire[1]}")

    t0 = time.perf_counter()
    state = torch.from_numpy(result.statevector(force=True)).to("cuda:0")
    ideal = simulate_dense(circuit, device="cuda:0")
    fid = fidelity(ideal, state)
    t_oracle = time.perf_counter() - t0
    finite = bool(torch.isfinite(torch.view_as_real(state)).all())
    del state, ideal
    counts = result.sample(1024, seed=0)
    zsum = result.expectation(zsum_cost_fn(qubits))
    print(f"{label}_check " + json.dumps({
        "fidelity": fid, "finite": finite, "oracle_s": t_oracle,
        "plan_boundary_bytes": wire,
        "shots": int(sum(counts.values())), "distinct": len(counts),
        "zsum": zsum}), flush=True)
    sim.close()
    if not finite:
        fail(f"{label}: the final state holds non-finite amplitudes")
    if not fid >= FIDELITY_MIN:
        fail(f"{label}: fidelity {fid} < {FIDELITY_MIN} against the dense "
             "oracle")
    if sum(counts.values()) != 1024 or not np.isfinite(zsum):
        fail(f"{label}: readout returned a malformed sample or expectation")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="trace the main paths' device time")
    ap.add_argument("--device-qubits", type=int, default=DEVICE_QUBITS,
                    help="qubits of the device-codec path (default 28)")
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
    checks.update(codec_phase())
    main_phase("main", MAIN_QUBITS, "host", args.profile)
    launches = main_phase("main_device", args.device_qubits, "device",
                          args.profile)

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
    codec_main = checks["codec"][0]
    errs = {"encode": max(c["max_code_diff"] for c in checks["codec"]),
            "decode": max(c["decode_max_abs"] for c in checks["codec"])}
    replaces = {"encode": "src/repro/kernels/quantize.py:75, "
                          "src/repro/kernels/pack.py:61",
                "decode": "src/repro/kernels/pack.py:85, "
                          "src/repro/kernels/quantize.py:123"}
    for k in ("encode", "decode"):
        t = codec_main[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "src/repro_torch/csrc/codec.cu",
            "replaces": replaces[k], "launches": launches[k],
            "max_abs_err": errs[k], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
