"""Time the tensor-core kernels at other tile shapes on one NVIDIA GPU.

    python3 chip_tiles.py [--rounds N]

Builds copies of src/repro_torch/csrc/attention.cu and gate_apply.cu with
other values of their tile constants (one nvcc per copy, all started
together, into a temporary directory), binds each copy's C entry points in
place of the built library's, checks it against the plain version and
times it with chip_smoke.py's helpers (CUDA events over cold inputs):

* flash attention (B10): f32 at (BH, S, hd) = (128, 2048, 128) causal and
  bf16 at the serve shape (B 8, S 2,048, Hq 32, G 8, hd 128), for m-tiles
  of 16 query rows a warp (MT) and key rows a tile (BK);
* gemm_planes (B6) at K = 64 and 128, R·K = 2^22, for warps sharing a row
  tile (NC) and warps a block.

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


def sources(tmp: str) -> dict[str, tuple[str, str, dict]]:
    """name -> (library kind, path of the copy, its constants)."""
    out = {}
    with open(os.path.join(CSRC, "attention.cu")) as f:
        attn = f.read()
    with open(os.path.join(CSRC, "gate_apply.cu")) as f:
        gate = f.read()
    for line in ATTN_LINES + GATE_LINES:
        if line not in attn + gate:
            sys.exit(f"chip_tiles: the sources no longer hold {line!r}")
    for (mh, bh), (mf, bf) in ATTN_VARIANTS:
        name = f"attn_h{mh}x{bh}_f{mf}x{bf}"
        src = attn.replace(ATTN_LINES[0], f"constexpr int kMTh = {mh}, "
                           f"kBKh = {bh};").replace(
            ATTN_LINES[1], f"constexpr int kMTf = {mf}, kBKf = {bf};")
        out[name] = ("attention", src, {"bf16": [mh, bh], "f32": [mf, bf]})
    for (n1, w1), (n2, w2) in GATE_VARIANTS:
        name = f"gate_k128_{n1}x{w1}_k64_{n2}x{w2}"
        src = gate.replace(GATE_LINES[0], "constexpr int tc_nc(int K) { "
                           f"return K >= 128 ? {n1} : {n2}; }}").replace(
            GATE_LINES[1], "constexpr int tc_warps(int K) { "
            f"return K >= 128 ? {w1} : {w2}; }}")
        out[name] = ("gate_apply", src, {"K128": [n1, w1], "K64": [n2, w2]})
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
            if any(k in fn for k in ("tc_kernel", "flash_bf16", "flash_f32")) \
                    and ("ILi128E" in fn or "ILi64E" in fn):
                print(f"kernel_ptxas {name} {fn} " + " | ".join(lines),
                      flush=True)
        libs[name] = lib
    return libs


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
        paths = sources(tmp)
        libs = build_all(build, cs, paths)
        for rnd in range(args.rounds):
            for name, (kind, _, consts) in paths.items():
                if kind == "attention":
                    rebind(fa, libs[name])
                    f32 = cs.flash_timed(128, 2048, 128)
                    bf = cs.flash_timed_bf16(cs.SERVE_BATCH, cs.SERVE_PROMPT,
                                             32, 8, 128)
                    row = {"f32_ms": f32["ms"], "bf16_ms": bf["ms"]}
                else:
                    rebind(ga, libs[name])
                    row = {f"K{K}_ms": cs.gemm_planes_case(
                        cs.GROUP // K, K, seed=10 + K, timed=True)["ms"]
                        for K in (64, 128)}
                print("tile_variant " + json.dumps(
                    {"round": rnd, "variant": name, **consts, **row}),
                    flush=True)
    fa._fns = ga._fns = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
