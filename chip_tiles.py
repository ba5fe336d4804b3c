"""Time the redesigned kernels at other tile shapes on one NVIDIA GPU.

    python3 chip_tiles.py [--rounds N] [--kinds attention,gate,ring,probe]

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
  while each runs.

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

ATTN_LINES = ("constexpr int kMTh = 2, kBKh = 64;  // bf16",
              "constexpr int kMTf = 2, kBKf = 16;  // f32")
#: (bf16 MT, BK), (f32 MT, BK): each copy sets one of each
ATTN_VARIANTS = [((2, 64), (2, 16)), ((1, 64), (1, 32)), ((2, 48), (1, 64)),
                 ((2, 32), (2, 32))]
GATE_LINES = ("constexpr int tc_nc(int K) { return K >= 128 ? 1 : 2; }",
              "constexpr int tc_warps(int K) { return K >= 128 ? 8 : 16; }")
#: (NC, warps) at K = 128, then at K = 64
GATE_VARIANTS = [((1, 8), (2, 16)), ((2, 8), (1, 8)), ((2, 16), (2, 8)),
                 ((4, 16), (1, 16))]
RING_LINE = ("constexpr int kRingTile = 2048, kRingStages = 2, "
             "kRingBlocksSM = 0;  // ring")
#: (tile, stages, blocks an SM) of the ring body
RING_VARIANTS = [(2048, 2, 0), (2048, 3, 0), (2048, 4, 0), (1024, 2, 0),
                 (1024, 4, 0), (4096, 2, 0), (2048, 2, 1)]
#: probes of the ring body at the source's constants (timed, not checked):
#: "none" is the source itself; "compute" drops the tile copies and the
#: stores (the FMAs run on what the ring holds; a store is kept behind a
#: test that does not hold, so the sums stay live); "stream" keeps copies and
#: stores but only the first of the K / 4 float4 steps of the FMAs
PROBE_EDITS = {
    "none": [],
    "compute": [
        ("          cp_async16(dr + e, lar + base + e, bytes);\n"
         "          cp_async16(di + e, lai + base + e, bytes);\n", ""),
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


def sources(tmp: str, kinds) -> dict[str, tuple[str, str, dict]]:
    """name -> (library kind, path of the copy, its constants), for the
    variant ``kinds`` asked for."""
    out = {}
    with open(os.path.join(CSRC, "attention.cu")) as f:
        attn = f.read()
    with open(os.path.join(CSRC, "gate_apply.cu")) as f:
        gate = f.read()
    for line in ATTN_LINES + GATE_LINES + (RING_LINE,):
        if line not in attn + gate:
            sys.exit(f"chip_tiles: the sources no longer hold {line!r}")
    for (mh, bh), (mf, bf) in ATTN_VARIANTS if "attention" in kinds else ():
        name = f"attn_h{mh}x{bh}_f{mf}x{bf}"
        src = attn.replace(ATTN_LINES[0], f"constexpr int kMTh = {mh}, "
                           f"kBKh = {bh};").replace(
            ATTN_LINES[1], f"constexpr int kMTf = {mf}, kBKf = {bf};")
        out[name] = ("attention", src, {"bf16": [mh, bh], "f32": [mf, bf]})
    for (n1, w1), (n2, w2) in GATE_VARIANTS if "gate" in kinds else ():
        name = f"gate_k128_{n1}x{w1}_k64_{n2}x{w2}"
        src = gate.replace(GATE_LINES[0], "constexpr int tc_nc(int K) { "
                           f"return K >= 128 ? {n1} : {n2}; }}").replace(
            GATE_LINES[1], "constexpr int tc_warps(int K) { "
            f"return K >= 128 ? {w1} : {w2}; }}")
        out[name] = ("gate_apply", src, {"K128": [n1, w1], "K64": [n2, w2]})
    for tile, stages, per_sm in RING_VARIANTS if "ring" in kinds else ():
        name = f"ring_t{tile}_s{stages}_b{per_sm}"
        src = gate.replace(RING_LINE, f"constexpr int kRingTile = {tile}, "
                           f"kRingStages = {stages}, kRingBlocksSM = "
                           f"{per_sm};")
        out[name] = ("ring", src, {"tile": tile, "stages": stages,
                                   "blocks_sm": per_sm})
    for probe, edits in PROBE_EDITS.items() if "probe" in kinds else ():
        src = gate
        for a, b in edits:
            if src.count(a) != 1:
                sys.exit(f"chip_tiles: the sources no longer hold {a!r} "
                         "once")
            src = src.replace(a, b)
        out[f"probe_{probe}"] = ("probe", src, {"probe": probe})
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
            [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            cs.fail(f"nvcc failed for {name}:\n{log[-4000:]}")
        for fn, lines in cs.ptxas_lines(log).items():
            if (any(k in fn for k in ("tc_kernel", "flash_bf16", "flash_f32"))
                    and ("ILi128E" in fn or "ILi64E" in fn)) or \
                    (name.startswith("ring") and "ring_kernel" in fn):
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
    fa._fns = ga._fns = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
