"""Checkpoint manager: atomic, resumable, restorable onto any device.

The port of ``repro/train/checkpoint.py``.  The container is a
framework-free artifact and equal to ``repro``'s: the same directory
names, the same ``manifest.json`` and byte-identical ``.bin`` files for
the same tree, so a checkpoint written by either package restores in the
other.  That takes ``repro``'s leaf keys — the tree's path as
``jax.tree_util.tree_flatten_with_path`` names it, dict keys sorted, list
and tuple indices, ``/``-joined — and its dtype names (``"bfloat16"``,
``"float32"``, ``"int32"``), raw C-order bytes, optionally zlib level 1.

* ``save`` writes every leaf under ``step_XXXXXXXX.tmp`` and renames it to
  ``step_XXXXXXXX``: a crash mid-save never corrupts the latest
  checkpoint.
* ``restore`` loads the newest complete step into the structure of a
  template and puts each leaf on ``device`` (default ``cuda:0``): a
  checkpoint written from one device restores onto another, where
  ``repro`` re-shards onto the current mesh.
* On a host mesh (``mesh``: a rank's view, ``specs``: the spec tree of the
  rank's blocks) every rank calls ``save``: each leaf is gathered whole
  and rank 0 writes the same files one device writes; ``restore`` hands
  each rank its block of every leaf read whole (``repro``'s elastic
  re-shard takes ``shardings=``): a checkpoint written on any mesh, or on
  one device, restores on any other.
* ``keep_last`` garbage-collects old steps.

bf16 leaves cross as their int16 bits; nothing here imports
``ml_dtypes``.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib

import numpy as np
import torch

from ..core.devices import resolve_device
from ..distributed.collectives import barrier
from ..distributed.sharding import gather_leaf, local_block, spec_leaves

__all__ = ["CheckpointManager", "flatten", "flatten_specs"]

_NP = {torch.float32: np.float32, torch.float64: np.float64,
       torch.int32: np.int32, torch.int64: np.int64, torch.int16: np.int16,
       torch.uint8: np.uint8, torch.int8: np.int8, torch.bool: np.bool_,
       torch.float16: np.float16}
_TORCH = {np.dtype(v).name: k for k, v in _NP.items()}


def flatten(tree, prefix: tuple = ()) -> dict:
    """``{key: leaf}`` in ``jax.tree_util.tree_flatten_with_path``'s order
    and with its names: dict keys sorted, list and tuple indices, the
    path joined by ``/``.  Empty containers hold no leaf."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flatten(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flatten(v, prefix + (i,)))
        return out
    return {"/".join(str(p) for p in prefix): tree}


def flatten_specs(tree, specs) -> dict:
    """``{key: spec}`` of a tree and its spec tree, keyed as
    :func:`flatten` keys the tree (both walks sort dict keys)."""
    return dict(zip(flatten(tree), (s for _, s in spec_leaves(tree, specs))))


def _unflatten(template, leaves: dict, prefix: tuple = ()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves, prefix + (i,))
                              for i, v in enumerate(template))
    return leaves["/".join(str(p) for p in prefix)]


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A leaf's host array and its dtype's name (bf16 as int16 bits)."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    if t.dtype not in _NP:
        raise TypeError(f"CheckpointManager: cannot store {t.dtype}")
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_bytes(blob: bytes, dtype: str, shape: list,
                device: torch.device) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(blob, dtype=np.int16).reshape(shape)
        t = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    elif dtype in _TORCH:
        t = torch.from_numpy(np.frombuffer(blob, dtype=dtype)
                             .reshape(shape).copy())
    else:
        raise TypeError(f"CheckpointManager: unknown dtype {dtype!r}")
    return t.to(device)


# repro.train.checkpoint has no injection point on these files (the
# simulator's checkpoint.* points cover the BlockStore's); training's
# failure hook is TrainRuntime's fail_at_step
def _write(path: str, blob: bytes) -> None:
    with open(path, "wb") as f:  # lint: disable=fault-coverage -- see above
        f.write(blob)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:  # lint: disable=fault-coverage -- see above
        return f.read()


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 compress: bool = False):
        self.dir = directory
        self.keep_last = keep_last
        self.compress = compress
        os.makedirs(directory, exist_ok=True)

    # -- paths -----------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree, mesh=None, specs=None) -> None:
        """Write ``tree`` as step ``step``.  On a mesh larger than 1x1
        every rank calls it with its blocks: rank 0 writes the gathered
        leaves, and each rank returns once the step is written."""
        sharded = mesh is not None and mesh.size > 1
        if sharded:
            leaf_specs = flatten_specs(tree, specs)
            if mesh.rank != 0:
                for key, leaf in flatten(tree).items():
                    gather_leaf(leaf, leaf_specs[key], mesh)
                barrier(mesh)
                return
        tmp = self._step_dir(step) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, leaf in flatten(tree).items():
            if sharded:
                leaf = gather_leaf(leaf, leaf_specs[key], mesh)
            arr, dtype = _to_numpy(leaf)
            fn = key.replace("/", "__") + ".bin"
            blob = arr.tobytes()
            codec = "raw"
            if self.compress:
                blob = zlib.compress(blob, 1)
                codec = "zlib"
            _write(os.path.join(tmp, fn), blob)
            manifest[key] = {"file": fn, "dtype": dtype,
                             "shape": list(arr.shape), "codec": codec}
        _write(os.path.join(tmp, "manifest.json"),
               json.dumps(manifest).encode())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)            # atomic commit
        self._gc()
        if sharded:
            barrier(mesh)

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------------
    def restore(self, template, step: int | None = None, device=None,
                mesh=None, specs=None):
        """Load into the structure of ``template`` (its leaves name the
        keys; their values are not read), each leaf on ``device``
        (default ``cuda:0``); returns ``(tree, step)``.  With ``mesh``
        (coordinates set: a rank's view) and the spec tree ``specs`` each
        leaf is that rank's block of the stored one."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = resolve_device(device)
        if mesh is not None:
            leaf_specs = flatten_specs(template, specs)
        d = self._step_dir(step)
        manifest = json.loads(_read(os.path.join(d, "manifest.json")))
        leaves = {}
        for key in flatten(template):
            ent = manifest[key]
            blob = _read(os.path.join(d, ent["file"]))
            if ent["codec"] == "zlib":
                blob = zlib.decompress(blob)
            if mesh is None:
                leaves[key] = _from_bytes(blob, ent["dtype"], ent["shape"],
                                          dev)
            else:
                leaves[key] = local_block(
                    _from_bytes(blob, ent["dtype"], ent["shape"], "cpu"),
                    leaf_specs[key], mesh).to(dev)
        return _unflatten(template, leaves), step
