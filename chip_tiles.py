"""Time the redesigned kernels at other tile shapes on one NVIDIA GPU.

    python3 chip_tiles.py [--rounds N] [--kinds attention,gate,ring,probe,
                                              mid,mid_probe,kvdq,kvdq_probe]

Builds copies of src/repro_torch/csrc/attention.cu and gate_apply.cu with
other values of their tile constants (one nvcc per copy, all started
together, into a temporary directory), binds each copy's C entry points in
place of the built library's, checks it against the plain version and
times it with chip_smoke.py's helpers (CUDA events over cold inputs):

* flash attention (B10): f32 at (BH, S, hd) = (128, 2048, 128) causal and
  bf16 at the serve shape (B 8, S 2,048, Hq 32, G 8, hd 128), for m-tiles
  of 16 query rows a warp (MT) and key rows a tile (BK);
* gemm_planes (B6) at K = 64 and 128, R·K = 2^22, for warps sharing a row
  tile (NC) and warps a block;
* the ring body of gemm_planes_batch (B1, 2 lanes, B at lane stride 0, K =
  16 and 32) and gemm_planes (B6, K = 4, 16, 32), R·K = 2^22, for its tile
  size (elements of each plane), stages in the ring and the most blocks an
  SM (0: as many as fit); with ``--kinds probe`` also the source itself
  and two probes of it (not checked): the FMAs alone on what the ring
  holds, and the tile stream with 1/(K/4) of the FMAs, B1 and B6 run
  through gemm_planes_batch, with the SM clock and power nvidia-smi reads
  while each runs;
* the ring body of gemm_planes_mid (B7) at (O, K, I) = (1, 32, 2^17),
  (1, 16, 2^18) and (1, 4, 2^20), for output rows a thread, slabs in the
  ring and the most blocks an SM; ``mid_probe`` times the source and two
  probes of it (not checked): the FMAs alone on what the ring holds (no
  copies, no stores) and the slab stream with 1/K of the FMAs;
* kv_dequant_decode_attention (B11) at the serve shape with a bf16 and an
  f32 q, for tokens a tile, stages, blocks an SM and cached dims a lane in
  QK^T; ``kvdq_probe`` times the source and two probes of it (not
  checked), bf16 q: the dequantize and products alone on what the ring
  holds (no copies) and the stream alone (copies and barriers, no
  compute), with the SM clock and power under each.

Prints a kernel_ptxas line (registers, spills) per variant and one JSON
line per variant and round; the first variant of each kind is the
source's own constants.  It imports nothing of JAX and nothing of the JAX
package, and needs the repository around it and a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "src", "repro_torch", "csrc")

#: (bf16 MT, BK), (f32 MT, BK): each copy sets one of each (FLASH_TILING)
ATTN_VARIANTS = [((2, 64), (2, 16)), ((1, 64), (1, 32)), ((2, 48), (1, 64)),
                 ((2, 32), (2, 32))]
#: (NC, warps) at K = 128, then at K = 64 (TC_TILING)
GATE_VARIANTS = [((1, 8), (2, 16)), ((2, 8), (1, 8)), ((2, 16), (2, 8)),
                 ((4, 16), (1, 16))]
#: (tile, stages, blocks an SM) of the ring body (RING_TILING)
RING_VARIANTS = [(2048, 2, 0), (2048, 3, 0), (2048, 4, 0), (1024, 2, 0),
                 (1024, 4, 0), (4096, 2, 0), (2048, 2, 1)]
#: (output rows a thread, columns a thread, stages, blocks an SM) of B7's
#: ring body (MID_TILING, and blocks an SM by MID_CLAMP where not 0)
MID_VARIANTS = [(4, 2, 2, 0), (16, 1, 2, 0), (32, 1, 2, 0), (8, 1, 2, 0),
                (4, 1, 2, 0), (8, 2, 2, 0), (4, 2, 4, 0), (16, 2, 2, 0),
                (4, 2, 3, 0), (4, 2, 2, 2)]
#: B7's launch, where a variant caps the blocks an SM
MID_CLAMP = "  const long long lane_units = mid_units<K>(outer, inner);\n"
#: (tokens a tile, stages, blocks an SM, QK^T dims a lane) of B11
#: (KV_TILING)
KV_VARIANTS = [(128, 2, 2, 16), (128, 2, 2, 8), (64, 3, 2, 16),
               (64, 2, 2, 16), (64, 3, 3, 16), (64, 2, 3, 8),
               (128, 2, 1, 16)]
#: probes of B7's ring body (timed, not checked): "compute" drops the slab
#: copies and the stores (stores stay behind tests that do not hold);
#: "stream" keeps them and runs 1 of the K steps of the FMAs
MID_PROBE_EDITS = {
    "none": [],
    "compute": [
        ("          cp_async16(dr + k * TI + col, ar + g, bytes);\n"
         "          cp_async16(di + k * TI + col, ai + g, bytes);\n", ""),
        ("    if (CT == 2 && inner % 2 == 0 && c + 2 <= cnt) {\n",
         "    if (accr[0][0] == 1234.5f && acci[0][0] == 1234.5f) {\n"),
        ("          pr[j * inner + h] = accr[h][j];\n"
         "          pi[j * inner + h] = acci[h][j];\n",
         "          if (accr[h][j] == 1234.5f && acci[h][j] == 1234.5f)\n"
         "            pr[j * inner + h] = 0.f;\n")],
    "stream": [("    for (int k = 0; k < K; ++k) {\n"
                "      float x_r[CT], x_i[CT];",
                "    for (int k = 0; k < 1; ++k) {\n"
                "      float x_r[CT], x_i[CT];")],
}
#: probes of B11 (timed, not checked): "compute" drops every copy of the
#: ring (the tiles hold what shared memory held) and takes the fast exp2;
#: "stream" keeps the copies and barriers and drops each tile's compute
KV_PROBE_EDITS = {
    "none": [],
    "compute": [
        ("  auto copy_tile = [&](int i) {\n",
         "  auto copy_tile = [&](int i) {\n    if (i >= 0) return;\n"),
        ("      [&](int i) { return __syncthreads_and(fast_scales(i)); },\n",
         "      [&](int i) { return __syncthreads_and(1); },\n")],
    "stream": [("        if (fast)\n          tile(i, std::true_type{});\n"
                "        else\n          tile(i, std::false_type{});\n",
                "        (void)fast;\n")],
}
#: probes of the ring body at the source's constants (timed, not checked):
#: "none" is the source itself; "compute" drops the tile copies and the
#: stores (the FMAs run on what the ring holds; a store is kept behind a
#: test that does not hold, so the sums stay live); "stream" keeps copies and
#: stores but only the first of the K / 4 float4 steps of the FMAs
PROBE_EDITS = {
    "none": [],
    "compute": [
        ("        cp_async16(dr + e, lar + base + e, bytes);\n"
         "        cp_async16(di + e, lai + base + e, bytes);\n", ""),
        ("step(rowr[kk], rowi[kk], kk);\n      }\n"
         "      lcr[base + e] = rr - ii;\n      lci[base + e] = ri + ir;\n",
         "step(rowr[kk], rowi[kk], kk);\n      }\n"
         "      if (rr == 1234.5f && ri == 1234.5f)\n"
         "        lcr[base + e] = ii + ir;\n")],
    "stream": [("        for (int q = 0; q < K / 4; ++q) {\n"
                "          const float4 x = r4[q], y = i4[q];",
                "        for (int q = 0; q < 1; ++q) {\n"
                "          const float4 x = r4[q], y = i4[q];")],
}


def edited(src: str, edits) -> str:
    """``src`` with each (old, new) of ``edits`` made; old must occur once."""
    for a, b in edits:
        if src.count(a) != 1:
            sys.exit(f"chip_tiles: the sources no longer hold {a!r} once")
        src = src.replace(a, b)
    return src


def sources(tmp: str, kinds) -> dict[str, tuple[str, str, dict]]:
    """name -> (library kind, path of the copy, its constants), for the
    variant ``kinds`` asked for.  A copy sets its tile constants by
    defining the macro that the source's defaults stand under."""
    out = {}
    with open(os.path.join(CSRC, "attention.cu")) as f:
        attn = f.read()
    with open(os.path.join(CSRC, "gate_apply.cu")) as f:
        gate = f.read()

    def tiled(macro: str, *values: int) -> str:
        return f"#define {macro} {', '.join(map(str, values))}\n"

    for (mh, bh), (mf, bf) in ATTN_VARIANTS if "attention" in kinds else ():
        out[f"attn_h{mh}x{bh}_f{mf}x{bf}"] = (
            "attention", tiled("FLASH_TILING", mh, bh, mf, bf) + attn,
            {"bf16": [mh, bh], "f32": [mf, bf]})
    for (n1, w1), (n2, w2) in GATE_VARIANTS if "gate" in kinds else ():
        out[f"gate_k128_{n1}x{w1}_k64_{n2}x{w2}"] = (
            "gate_apply", tiled("TC_TILING", n1, w1, n2, w2) + gate,
            {"K128": [n1, w1], "K64": [n2, w2]})
    for tile, stages, per_sm in RING_VARIANTS if "ring" in kinds else ():
        out[f"ring_t{tile}_s{stages}_b{per_sm}"] = (
            "ring", tiled("RING_TILING", tile, stages, per_sm) + gate,
            {"tile": tile, "stages": stages, "blocks_sm": per_sm})
    for rows, cols, stages, per_sm in MID_VARIANTS if "mid" in kinds else ():
        clamp = [(MID_CLAMP, f"  if (per_sm > {per_sm}) per_sm = {per_sm};"
                  f"\n{MID_CLAMP}")] if per_sm else []
        out[f"mid_r{rows}_c{cols}_s{stages}_b{per_sm}"] = (
            "mid", tiled("MID_TILING", rows, cols, stages)
            + edited(gate, clamp),
            {"rows": rows, "cols": cols, "stages": stages,
             "blocks_sm": per_sm})
    for tile, stages, per_sm, kd in KV_VARIANTS if "kvdq" in kinds else ():
        out[f"kvdq_t{tile}_s{stages}_b{per_sm}_d{kd}"] = (
            "kvdq", tiled("KV_TILING", tile, stages, per_sm, kd) + attn,
            {"tile": tile, "stages": stages, "blocks_sm": per_sm,
             "kdims": kd})
    for kind, base, table in (("probe", gate, PROBE_EDITS),
                              ("mid_probe", gate, MID_PROBE_EDITS),
                              ("kvdq_probe", attn, KV_PROBE_EDITS)):
        for probe, edits in table.items() if kind in kinds else ():
            out[f"{kind}_{probe}"] = (kind, edited(base, edits),
                                      {"probe": probe})
    paths = {}
    for name, (kind, src, consts) in out.items():
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        paths[name] = (kind, path, consts)
    return paths


def build_all(build, cs, paths: dict) -> dict[str, str]:
    """Compile every copy at once; returns name -> library path."""
    procs = {}
    for name, (_, path, _) in paths.items():
        lib = path[:-3] + ".so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", CSRC, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for {name}:\n{log[-4000:]}")
        for fn, lines in cs.ptxas_lines(log).items():
            if (any(k in fn for k in ("tc_kernel", "flash_bf16", "flash_f32"))
                    and ("ILi128E" in fn or "ILi64E" in fn)) or \
                    (name.startswith("ring") and "ring_kernel" in fn) or \
                    (name.startswith("mid") and "mid_ring_kernel" in fn
                     and ("ILi32E" in fn or "ILi4E" in fn)) or \
                    (name.startswith("kvdq") and "kvdq_partial" in fn
                     and "ILi128E" in fn):
                print(f"kernel_ptxas {name} {fn} " + " | ".join(lines),
                      flush=True)
        libs[name] = lib
    return libs


def probe_times(cs, ga) -> dict:
    """Kernel times of a probe (its results are wrong by design) at the
    ring variants' shapes, with the SM clock and power nvidia-smi reads
    while the card runs each."""
    import torch
    row = {}
    for lanes, K in ((2, 16), (2, 32), (1, 4), (1, 16), (1, 32)):
        g = torch.Generator(device="cuda:0").manual_seed(K)
        planes = torch.randn((lanes, 2, cs.GROUP), generator=g,
                             device="cuda:0")
        u = torch.randn((1, 2, K, K), generator=g, device="cuda:0")
        b = u.expand(lanes, 2, K, K).transpose(2, 3)
        inputs = [(p[:, 0].reshape(lanes, -1, K), p[:, 1].reshape(
            lanes, -1, K), b[:, 0], b[:, 1])
            for (p,) in cs.cold_copies((planes,), (0,))]
        key = f"B{1 if lanes > 1 else 6}_K{K}"
        row[f"{key}_ms"] = cs.cuda_ms(ga.gemm_planes_batch, inputs)
        # the SM clock and power while the card runs a second of launches
        for i in range(int(1000 / row[f"{key}_ms"])):
            ga.gemm_planes_batch(*inputs[i % len(inputs)])
        row[f"{key}_clock_power"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        torch.cuda.synchronize()
    return row


def clock_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def mid_probe_times(cs, ga) -> dict:
    """Times of a B7 probe (its results are wrong by design) at the mid
    variants' shapes, with the SM clock and power under each."""
    import torch
    row = {}
    for O, K, I in MID_SHAPES:
        ar, ai = cs.unit_planes((O, K, I), K)
        ur, ui = cs.unit_planes((K, K), K + 1)
        inputs = cs.cold_copies((ar, ai, ur, ui), (0, 1))
        row[f"K{K}_ms"] = cs.cuda_ms(ga.gemm_planes_mid, inputs)
        for i in range(int(1000 / row[f"K{K}_ms"])):
            ga.gemm_planes_mid(*inputs[i % len(inputs)])
        row[f"K{K}_clock_power"] = clock_power()
        torch.cuda.synchronize()
    return row


def kvdq_probe_times(cs, kd) -> dict:
    """Times of a B11 probe (wrong by design) at the serve shape, bf16 q,
    with the SM clock and power under it."""
    import torch
    B, G, rep, T, hd = cs.SERVE_BATCH, 8, 4, cs.SERVE_MAX_LEN, 128
    g = torch.Generator(device="cuda:0").manual_seed(6)
    cache = cs.kv_cache_case((B, G), T, hd, 7)
    q = torch.randn((B, 1, G * rep, hd), generator=g, device="cuda:0") \
        .bfloat16()
    pos = torch.tensor(T - 1, dtype=torch.int32, device="cuda:0")
    inputs = cs.cold_copies((q, *cache, pos), (1, 2, 3, 4, 5, 6))
    ms = cs.cuda_ms(kd.kv_dequant_decode_attention_gqa, inputs)
    for i in range(int(1000 / ms)):
        kd.kv_dequant_decode_attention_gqa(*inputs[i % len(inputs)])
    out = {"bf16_ms": ms, "clock_power": clock_power()}
    torch.cuda.synchronize()
    return out


#: B7's shapes: the schedules' (1, 32, 2^17) and (1, 4, 2^20), and K = 16
MID_SHAPES = [(1, 32, 1 << 17), (1, 16, 1 << 18), (1, 4, 1 << 20)]


def rebind(mod, lib_path: str) -> None:
    """Point a kernel module's C entry points at another library."""
    fns = mod._kernels()
    lib = ctypes.CDLL(lib_path)
    new = {}
    for key, fn in fns.items():
        f = getattr(lib, fn.__name__)
        f.argtypes, f.restype = fn.argtypes, fn.restype
        new[key] = f
    mod._fns = new


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="times each variant is timed, in turns")
    ap.add_argument("--kinds", default="attention,gate,ring",
                    help="the variants to build and time (comma list of "
                    "attention, gate, ring, probe)")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a GPU")
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gate_apply as ga
    from repro_torch.kernels import kv_dequant_attention as kd
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        paths = sources(tmp, args.kinds.split(","))
        libs = build_all(build, cs, paths)
        for rnd in range(args.rounds):
            for name, (kind, _, consts) in paths.items():
                if kind == "attention":
                    rebind(fa, libs[name])
                    f32 = cs.flash_timed(128, 2048, 128)
                    bf = cs.flash_timed_bf16(cs.SERVE_BATCH, cs.SERVE_PROMPT,
                                             32, 8, 128)
                    row = {"f32_ms": f32["ms"], "bf16_ms": bf["ms"]}
                elif kind == "gate_apply":
                    rebind(ga, libs[name])
                    row = {f"K{K}_ms": cs.gemm_planes_case(
                        cs.GROUP // K, K, seed=10 + K, timed=True)["ms"]
                        for K in (64, 128)}
                elif kind == "probe":
                    rebind(ga, libs[name])
                    row = probe_times(cs, ga)
                elif kind == "mid":
                    rebind(ga, libs[name])
                    row = {f"K{K}_ms": cs.gemm_planes_mid_case(
                        O, K, I, seed=31, timed=True)["ms"]
                        for O, K, I in MID_SHAPES}
                elif kind == "mid_probe":
                    rebind(ga, libs[name])
                    row = mid_probe_times(cs, ga)
                elif kind == "kvdq":
                    rebind(kd, libs[name])
                    kd._grids.clear()
                    row = {f"{dt}_ms": cs.kvdq_timed(
                        cs.SERVE_BATCH, 8, 4, cs.SERVE_MAX_LEN, 128,
                        cs.SERVE_MAX_LEN - 1, dt)["ms"]
                        for dt in ("bfloat16", "float32")}
                elif kind == "kvdq_probe":
                    rebind(kd, libs[name])
                    kd._grids.clear()
                    row = kvdq_probe_times(cs, kd)
                else:
                    rebind(ga, libs[name])
                    row = {f"B1_K{K}_ms": cs.gemm_case(
                        2, cs.GROUP // K, K, True, seed=K, timed=True)["ms"]
                        for K in (16, 32)}
                    row.update({f"B6_K{K}_ms": cs.gemm_planes_case(
                        cs.GROUP // K, K, seed=10 + K, timed=True)["ms"]
                        for K in (4, 16, 32)})
                print("tile_variant " + json.dumps(
                    {"round": rnd, "variant": name, **consts, **row}),
                    flush=True)
    fa._fns = ga._fns = kd._fns = None
    kd._grids.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
