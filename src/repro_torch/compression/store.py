"""Two-level block store (paper §4.4).

Compressed SV block sizes are unpredictable (variable-ratio compression),
so the simulation needs a memory manager that (1) tracks the actual bytes
held in the primary tier and (2) spills overflow to a secondary tier so a
run never aborts mid-circuit.  On the paper's machines the tiers are
CPU-RAM -> SSD via GPUDirect Storage; here they are a RAM dict -> disk
files (the data plane stays framework-agnostic bytes).

Extras matching the paper:
* ``put_alias`` — the §4.2 initialization trick: all-zero blocks are stored
  once and aliased (refcounted), so initial compression is O(1) not O(2^c).
* peak statistics for the memory benchmarks (Fig. 9).
* structured blocks — ``put_block`` / ``get_block`` store a
  :class:`~repro_torch.compression.segments.BlockSegments` *as an object* in the
  RAM tier (no serialize/parse on the hot path; the pipeline reaches its
  ``codes`` / ``bitmap`` / ``l_max`` segments directly) and serialize it
  only when it spills to disk.

Keys map to refcounted internal blobs, so overwriting a key never disturbs
other keys aliased to the same blob.

Resilience (the paper's "dedicated error control" / stable-execution
claim, §4.4):

* **Integrity** — every blob that takes serialized form gets a crc32
  content checksum: opaque ``bytes`` at ``put`` time, structured blocks
  when they serialize to spill.  Every disk-tier read and every snapshot
  restore verifies it; a mismatch raises
  :class:`~repro_torch.errors.BlockCorruptionError` — corrupted data is
  *detected*, never silently decoded.  (RAM-resident structured blocks
  are never serialized, so the hot path pays nothing.)
* **Transient-fault tolerance** — spill and snapshot I/O retries with
  exponential backoff (``io_retries`` / ``io_backoff_s``); exhausted
  retries raise a typed :class:`~repro_torch.errors.StoreIOError` naming the
  operation, key/blob and path instead of leaking a raw ``OSError`` out
  of a worker thread.
* **Durable snapshots** — :meth:`snapshot` fsyncs the temp file (and its
  parent directory) before the atomic rename, stamps per-blob digests in
  the header, and :meth:`restore` validates the total file length against
  ``blob_sizes`` so a truncated/torn checkpoint raises a clear
  :class:`~repro_torch.errors.CheckpointError` instead of failing deep in
  decode.
* **Pressure relief** — :meth:`spill` proactively moves RAM-tier blobs
  to disk (the degradation ladder's third rung), and
  :meth:`load_snapshot` reloads a snapshot *into* an existing store
  in place (the engine's replay-from-checkpoint path).
"""
from __future__ import annotations

import itertools
import json
import os
import struct
import tempfile
import threading
import time
import zlib
from dataclasses import dataclass

from ..errors import BlockCorruptionError, CheckpointError, StoreIOError
from ..faults import fault_point
from .segments import BlockSegments

_SNAP_MAGIC = b"BMQSNAP1"
_SNAP_HEAD = struct.Struct("<Q")   # header JSON length


@dataclass
class StoreStats:
    ram_bytes: int = 0
    disk_bytes: int = 0
    peak_ram_bytes: int = 0
    peak_total_bytes: int = 0
    n_spills: int = 0
    n_disk_reads: int = 0
    puts: int = 0
    gets: int = 0
    #: transient I/O errors absorbed by retry-with-backoff
    n_io_retries: int = 0
    #: blobs moved RAM -> disk by an explicit spill() call (pressure rung)
    n_proactive_spills: int = 0
    #: checksum mismatches detected (each raised a BlockCorruptionError)
    n_corruptions_detected: int = 0

    def observe(self) -> None:
        self.peak_ram_bytes = max(self.peak_ram_bytes, self.ram_bytes)
        self.peak_total_bytes = max(self.peak_total_bytes,
                                    self.ram_bytes + self.disk_bytes)


def _blob_nbytes(blob) -> int:
    return len(blob) if isinstance(blob, (bytes, bytearray)) else blob.nbytes


def _blob_bytes(blob) -> bytes:
    return blob if isinstance(blob, (bytes, bytearray)) else blob.to_bytes()


class BlockStore:
    """Key -> block store with a RAM budget and a disk spill tier.

    Values are either opaque ``bytes`` (``put`` / ``get``) or structured
    :class:`BlockSegments` (``put_block`` / ``get_block``); the two views
    are interchangeable — a spilled structured block deserializes on read,
    and ``get_block`` on a byte blob parses the self-describing layout.

    Args:
        ram_budget_bytes: primary-tier byte budget (None = unbounded).
        spill_dir: secondary-tier directory (default: a temp dir).
        checksums: stamp/verify crc32 content checksums on serialized
            blobs (disk tier + snapshots).  Default on; the guardrail
            overhead is benchmarked in ``bench_pipeline``.
        io_retries: bounded retries of a failed spill/snapshot I/O op.
        io_backoff_s: initial backoff between retries (doubles per try).
    """

    def __init__(self, ram_budget_bytes: int | None = None,
                 spill_dir: str | None = None, *,
                 checksums: bool = True, io_retries: int = 3,
                 io_backoff_s: float = 0.01):
        self.ram_budget = ram_budget_bytes
        self.checksums = checksums
        self.io_retries = io_retries
        self.io_backoff_s = io_backoff_s
        # blob maps (_refs: id->refcount, _ram: id->blob, _disk:
        # id->path, _crc: id->crc32 of serialized bytes).  The pipeline
        # worker pools hit the store from several threads at once, so
        # every field marked guarded-by below may only be touched inside
        # 'with self._lock:' (enforced by the lock-discipline checker).
        self._key2blob: dict[int, int] = {}    # guarded-by: _lock
        self._refs: dict[int, int] = {}        # guarded-by: _lock
        self._ram: dict[int, bytes] = {}       # guarded-by: _lock
        self._disk: dict[int, str] = {}        # guarded-by: _lock
        self._crc: dict[int, int] = {}         # guarded-by: _lock
        self._ids = itertools.count()          # guarded-by: _lock
        self._spill_dir = spill_dir
        self._tmp: tempfile.TemporaryDirectory | None = None
        self._lock = threading.RLock()
        self.stats = StoreStats()              # guarded-by: _lock

    # -- tier plumbing ---------------------------------------------------------
    def _spill_path(self, blob_id: int) -> str:
        if self._spill_dir is None:
            if self._tmp is None:
                self._tmp = tempfile.TemporaryDirectory(prefix="bmqsim_spill_")
            self._spill_dir = self._tmp.name
        return os.path.join(self._spill_dir, f"blob_{blob_id}.bin")

    def _fits_ram(self, nbytes: int) -> bool:  # holds-lock: _lock
        if self.ram_budget is None:
            return True
        return self.stats.ram_bytes + nbytes <= self.ram_budget

    def _with_retries(self, op, opname: str, *, key=None, bid=None,
                      path=None, fnf_is_signal: bool = False):
        """Run ``op`` with bounded exponential-backoff retries on
        ``OSError``; exhausted retries raise a typed
        :class:`StoreIOError` naming the operation and blob.

        ``fnf_is_signal`` passes ``FileNotFoundError`` through untouched
        — on the read path it means the key was rebound mid-read (a
        normal race the caller resolves under the lock), not a fault.
        """
        delay = self.io_backoff_s
        last: OSError | None = None
        for attempt in range(self.io_retries + 1):
            try:
                return op()
            except FileNotFoundError:
                if fnf_is_signal:
                    raise
                raise StoreIOError(opname, key=key, blob_id=bid, path=path,
                                   retries=attempt) from None
            except StoreIOError:
                raise
            except OSError as e:
                last = e
                if attempt < self.io_retries:
                    with self._lock:
                        self.stats.n_io_retries += 1
                    time.sleep(delay)
                    delay *= 2
        raise StoreIOError(opname, key=key, blob_id=bid, path=path,
                           retries=self.io_retries) from last

    def _write_spill(self, path: str, data: bytes, *, key=None,
                     bid=None) -> None:
        """One spill-tier file write: fault-injectable, retried, typed."""
        def op():
            payload = fault_point("store.spill_write", data)
            with open(path, "wb") as f:
                f.write(payload)
        self._with_retries(op, "spill write", key=key, bid=bid, path=path)

    def _read_spill(self, path: str, *, key=None, bid=None) -> bytes:
        """One spill-tier file read: fault-injectable, retried, verified."""
        def op():
            with open(path, "rb") as f:
                raw = f.read()
            return fault_point("store.spill_read", raw)
        data = self._with_retries(op, "spill read", key=key, bid=bid,
                                  path=path, fnf_is_signal=True)
        self._verify(data, bid, key=key, path=path, where="spill read")
        return data

    def _verify(self, data: bytes, bid, *, key=None, path=None,
                where: str) -> None:
        if not self.checksums or bid is None:
            return
        with self._lock:
            expected = self._crc.get(bid)
        if expected is None:
            return
        actual = zlib.crc32(data)
        if actual != expected:
            with self._lock:
                self.stats.n_corruptions_detected += 1
            raise BlockCorruptionError(where, key=key, blob_id=bid,
                                       path=path, expected_crc=expected,
                                       actual_crc=actual)

    def _put(self, key: int, blob) -> None:
        """Bind ``key`` to a fresh blob; disk writes happen outside the
        lock (the new blob id is invisible to readers until ``_bind``)."""
        nbytes = _blob_nbytes(blob)
        # opaque bytes are checksummed at put time; structured blocks
        # only when they serialize (spill/snapshot) — the RAM tier keeps
        # the object, so there is nothing byte-stable to stamp yet
        crc = (zlib.crc32(blob) if self.checksums
               and isinstance(blob, (bytes, bytearray)) else None)
        with self._lock:
            self.stats.puts += 1
            bid = next(self._ids)
            self._refs[bid] = 0
            if crc is not None:
                self._crc[bid] = crc
            if self._fits_ram(nbytes):
                self._ram[bid] = blob
                self.stats.ram_bytes += nbytes
                self.stats.observe()
                self._bind(key, bid)
                return
            path = self._spill_path(bid)
        data = _blob_bytes(blob)
        if self.checksums and crc is None:
            crc = zlib.crc32(data)
        self._write_spill(path, data, key=key, bid=bid)
        with self._lock:
            if crc is not None:
                self._crc[bid] = crc
            self._disk[bid] = path
            self.stats.disk_bytes += nbytes
            self.stats.n_spills += 1
            self.stats.observe()
            self._bind(key, bid)

    def _release_blob(self, bid: int) -> None:  # holds-lock: _lock
        self._refs[bid] -= 1
        if self._refs[bid] > 0:
            return
        del self._refs[bid]
        self._crc.pop(bid, None)
        if bid in self._ram:
            self.stats.ram_bytes -= _blob_nbytes(self._ram.pop(bid))
        else:
            path = self._disk.pop(bid)
            self.stats.disk_bytes -= os.path.getsize(path)
            os.unlink(path)

    def _bind(self, key: int, bid: int) -> None:  # holds-lock: _lock
        old = self._key2blob.get(key)
        self._key2blob[key] = bid
        self._refs[bid] += 1
        if old is not None:
            self._release_blob(old)

    # -- public API ------------------------------------------------------------
    def put(self, key: int, blob: bytes) -> None:
        """Store opaque bytes under ``key`` (raw/uncompressed block path)."""
        self._put(key, blob)

    def put_block(self, key: int, seg: BlockSegments) -> None:
        """Store a structured compressed block under ``key``.

        The RAM tier keeps the :class:`BlockSegments` object itself;
        serialization happens only if the block spills to disk.
        """
        self._put(key, seg)

    def put_alias(self, key: int, existing_key: int) -> None:
        """Point ``key`` at the blob of ``existing_key`` (zero-copy)."""
        with self._lock:
            self._bind(key, self._key2blob[existing_key])

    def _fetch(self, key: int):
        with self._lock:
            self.stats.gets += 1
            bid = self._key2blob[key]
            blob = self._ram.get(bid)
            if blob is not None:
                return blob
            self.stats.n_disk_reads += 1
            path = self._disk[bid]
        try:
            # disk read outside the lock so concurrent workers overlap I/O
            return self._read_spill(path, key=key, bid=bid)
        except FileNotFoundError:
            # the key was rebound and its old blob released mid-read —
            # retry under the lock for a consistent snapshot
            with self._lock:
                bid = self._key2blob[key]
                blob = self._ram.get(bid)
                if blob is not None:
                    return blob
                path = self._disk[bid]
                try:
                    return self._read_spill(path, key=key, bid=bid)
                except FileNotFoundError as e:
                    # still bound to this blob and still missing: the
                    # file is genuinely gone, not a rebind race
                    raise StoreIOError("spill read", key=key, blob_id=bid,
                                       path=path,
                                       detail="blob file missing") from e

    def get(self, key: int) -> bytes:
        """Fetch ``key`` as flat bytes (serializing a structured block)."""
        return _blob_bytes(self._fetch(key))

    def get_block(self, key: int) -> BlockSegments:
        """Fetch ``key`` as structured segments (parsing a byte blob)."""
        blob = self._fetch(key)
        if isinstance(blob, BlockSegments):
            return blob
        return BlockSegments.from_bytes(blob)

    def __contains__(self, key: int) -> bool:
        with self._lock:
            return key in self._key2blob

    def nbytes_of(self, key: int) -> int:
        with self._lock:
            bid = self._key2blob[key]
            if bid in self._ram:
                return _blob_nbytes(self._ram[bid])
            return os.path.getsize(self._disk[bid])

    def delete(self, key: int) -> None:
        with self._lock:
            bid = self._key2blob.pop(key, None)
            if bid is not None:
                self._release_blob(bid)

    @property
    def total_bytes(self) -> int:
        with self._lock:
            return self.stats.ram_bytes + self.stats.disk_bytes

    def keys(self):
        with self._lock:
            return sorted(self._key2blob)

    # -- pressure relief -------------------------------------------------------
    def spill(self, target_ram_bytes: int) -> int:
        """Proactively move RAM-tier blobs to disk (largest first) until
        ``ram_bytes <= target_ram_bytes``; returns blobs moved.

        The degradation ladder's third rung
        (:class:`~repro_torch.core.pressure.PressureMonitor`): called between
        stages, when no pipeline workers are mid-flight, so the move
        happens under the lock without racing readers.
        """
        moved = 0
        with self._lock:
            if self.stats.ram_bytes <= target_ram_bytes:
                return 0
            order = sorted(self._ram.items(),
                           key=lambda kv: -_blob_nbytes(kv[1]))
            for bid, blob in order:
                if self.stats.ram_bytes <= target_ram_bytes:
                    break
                data = _blob_bytes(blob)
                path = self._spill_path(bid)
                self._write_spill(path, data, bid=bid)
                if self.checksums:
                    self._crc[bid] = zlib.crc32(data)
                nbytes = _blob_nbytes(blob)
                del self._ram[bid]
                self._disk[bid] = path
                self.stats.ram_bytes -= nbytes
                self.stats.disk_bytes += len(data)
                self.stats.n_spills += 1
                self.stats.n_proactive_spills += 1
                moved += 1
            self.stats.observe()
        return moved

    # -- checkpointing ---------------------------------------------------------
    def snapshot(self, path: str, meta: dict | None = None) -> None:
        """Serialize every key to one checkpoint file (atomic + durable).

        Alias structure is preserved: keys sharing a blob (the §4.2
        zero-block trick) serialize the blob once and restore shared.
        ``meta`` is an opaque caller dict (the engine's layout/codec
        manifest) stored alongside and handed back by :meth:`restore`.

        Durability: the temp file is flushed + fsynced, atomically
        renamed over ``path``, and the parent directory fsynced — a
        crash mid-checkpoint leaves either the old complete file or the
        new complete file, never a torn one.  The header carries
        per-blob crc32 digests (``blob_crc``) that :meth:`restore`
        verifies.
        """
        with self._lock:
            key2blob = dict(self._key2blob)
        blob_order: list[int] = []
        blob_pos: dict[int, int] = {}
        keys = []
        for key in sorted(key2blob):
            bid = key2blob[key]
            if bid not in blob_pos:
                blob_pos[bid] = len(blob_order)
                blob_order.append(bid)
            keys.append([key, blob_pos[bid]])
        blobs: list[bytes] = []
        for bid in blob_order:
            with self._lock:
                blob = self._ram.get(bid)
                disk_path = None if blob is not None else self._disk[bid]
            if blob is not None:
                blobs.append(_blob_bytes(blob))
            else:
                blobs.append(self._read_spill(disk_path, bid=bid))
        header = json.dumps({
            "meta": meta or {},
            "keys": keys,
            "blob_sizes": [len(b) for b in blobs],
            "blob_crc": [zlib.crc32(b) for b in blobs],
        }).encode()
        tmp = path + ".tmp"

        def op():
            fault_point("checkpoint.write")
            with open(tmp, "wb") as f:
                f.write(_SNAP_MAGIC)
                f.write(_SNAP_HEAD.pack(len(header)))
                f.write(header)
                for b in blobs:
                    f.write(b)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            # fsync the parent directory so the rename itself is durable
            dfd = os.open(os.path.dirname(os.path.abspath(path)),
                          os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        try:
            self._with_retries(op, "snapshot", path=path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    @staticmethod
    def _read_snapshot(path: str) -> tuple[dict, list[bytes]]:
        """Parse + validate a snapshot file -> (header, blobs).

        Structural validation happens BEFORE any blob is decoded: bad
        magic or a file length inconsistent with ``blob_sizes`` raises
        :class:`CheckpointError`; a per-blob digest mismatch raises
        :class:`BlockCorruptionError` naming the blob index.  The raw
        read is the ``checkpoint.read`` injection point; I/O failures
        other than a missing file (the caller's "no checkpoint yet"
        signal) surface as :class:`StoreIOError`.
        """
        try:
            fault_point("checkpoint.read")
            file_len = os.path.getsize(path)
            with open(path, "rb") as f:
                magic = f.read(len(_SNAP_MAGIC))
                if magic != _SNAP_MAGIC:
                    raise CheckpointError(f"{path}: not a BMQSIM checkpoint "
                                          f"(bad magic {magic!r})")
                (hlen,) = _SNAP_HEAD.unpack(f.read(_SNAP_HEAD.size))
                head_raw = f.read(hlen)
                if len(head_raw) < hlen:
                    raise CheckpointError(
                        f"{path}: truncated checkpoint (header cut short: "
                        f"{len(head_raw)}/{hlen} bytes)")
                try:
                    header = json.loads(head_raw.decode())
                except (UnicodeDecodeError, json.JSONDecodeError) as e:
                    raise CheckpointError(
                        f"{path}: corrupt checkpoint header ({e})") from e
                sizes = header["blob_sizes"]
                expected_len = (len(_SNAP_MAGIC) + _SNAP_HEAD.size + hlen
                                + sum(sizes))
                if file_len != expected_len:
                    raise CheckpointError(
                        f"{path}: truncated/torn checkpoint — file is "
                        f"{file_len} bytes but header promises "
                        f"{expected_len} ({len(sizes)} blobs totaling "
                        f"{sum(sizes)} bytes)")
                blobs = [f.read(sz) for sz in sizes]
        except FileNotFoundError:
            raise
        except OSError as e:
            raise StoreIOError("checkpoint read", path=path) from e
        for i, (blob, sz) in enumerate(zip(blobs, sizes)):
            if len(blob) != sz:
                raise CheckpointError(
                    f"{path}: truncated checkpoint (blob {i}: "
                    f"{len(blob)}/{sz} bytes)")
        crcs = header.get("blob_crc")
        if crcs is not None:      # pre-resilience snapshots lack digests
            for i, (blob, crc) in enumerate(zip(blobs, crcs)):
                actual = zlib.crc32(blob)
                if actual != crc:
                    raise BlockCorruptionError(
                        f"snapshot restore ({path}, blob {i})",
                        blob_id=i, path=path, expected_crc=crc,
                        actual_crc=actual)
        return header, blobs

    @classmethod
    def restore(cls, path: str, ram_budget_bytes: int | None = None,
                spill_dir: str | None = None) -> tuple["BlockStore", dict]:
        """Rebuild a store from a :meth:`snapshot` file -> (store, meta).

        Blobs land in the RAM tier as serialized bytes (``get_block``
        re-parses structured blocks lazily); the usual budget/spill rules
        apply, so a snapshot larger than ``ram_budget_bytes`` restores
        with overflow on the disk tier.  Every blob's stored digest is
        verified first.
        """
        header, blobs = cls._read_snapshot(path)
        store = cls(ram_budget_bytes=ram_budget_bytes, spill_dir=spill_dir)
        store._load_keys(header, blobs)
        return store, header["meta"]

    def load_snapshot(self, path: str) -> dict:
        """Reload a snapshot *into this store*, replacing every current
        key -> the snapshot's meta dict.

        The engine's replay-from-checkpoint path: on a detected
        corruption mid-run, the simulator rewinds the live store to the
        last checkpoint without rebuilding the session (backend/engine
        references to this store stay valid).
        """
        header, blobs = self._read_snapshot(path)
        with self._lock:
            for key in list(self._key2blob):
                self.delete(key)
            self._load_keys(header, blobs)
        return header["meta"]

    def _load_keys(self, header: dict, blobs: list[bytes]) -> None:
        first_key: dict[int, int] = {}
        for key, blob_idx in header["keys"]:
            if blob_idx in first_key:
                self.put_alias(key, first_key[blob_idx])
            else:
                self.put(key, blobs[blob_idx])
                first_key[blob_idx] = key

    def close(self) -> None:
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None
