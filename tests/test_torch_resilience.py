"""Resilience in the port: tests/test_resilience.py's scenarios on
repro_torch (sessions on the CPU, the kernels' plain versions), with the
same assertions — deterministic fault injection, end-to-end block
integrity, crash/resume equivalence at every stage boundary, the
memory-pressure degradation ladder — then artifacts across the two
packages (checkpoints and BlockStore snapshots written by either restore
in the other; the same injection points) and, on a card, a fault-injected
device-codec run resumed bit for bit.

The fault matrix this file pins down: every injected fault is either
(a) retried/degraded away and the run completes with the correct state,
or (b) surfaced as a typed error carrying a resumable checkpoint that
reproduces the uninterrupted result — and corrupted blobs/snapshots are
ALWAYS detected, never silently decoded.
"""
import os
import random

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import (BlockCorruptionError, CheckpointError, EngineConfig,
                         MemoryPressureError, ResumableError, Simulator,
                         StoreIOError, build_circuit, inject_faults)
from repro_torch.compression.store import BlockStore
from repro_torch.core.fidelity import fidelity, norm
from repro_torch.core.pressure import RUNGS, PressureMonitor
from repro_torch.faults import (INJECTION_POINTS, FaultInjector, FaultSpec,
                                InjectedCrash, fault_point)

try:
    import repro
except ImportError:             # the card's machine has no JAX
    repro = None

CPU = torch.device("cpu")

# small enough to be fast, big enough to spill + multi-stage
QC9 = build_circuit("qft", 9)


def _cfg(**kw):
    kw.setdefault("local_bits", 4)
    kw.setdefault("ram_budget_bytes", 1000)   # forces the disk tier
    kw.setdefault("devices", [CPU])
    return EngineConfig(**kw)


def _amps(sim_result):
    return sim_result.amplitudes(range(32))


@pytest.fixture(scope="module")
def ref9():
    with Simulator(QC9, _cfg()) as sim:
        yield _amps(sim.run()), sim.stats.n_stages


# -- fault-injection framework ----------------------------------------------

def test_fault_spec_parse_roundtrip():
    s = FaultSpec.parse("store.spill_read:ioerror:hit=3,7:times=2")
    assert s.point == "store.spill_read" and s.kind == "ioerror"
    assert s.hits == (3, 7) and s.times == 2 and s.p == 0.0
    s2 = FaultSpec.parse("pipeline.fetch:crash:p=0.25")
    assert s2.p == 0.25 and s2.hits is None


@pytest.mark.parametrize("bad", [
    "nonsense.point:ioerror",          # unknown point
    "store.spill_read:meltdown",       # unknown kind
    "pipeline.fetch:corrupt",          # corrupt needs a byte-carrying point
    "store.spill_read:ioerror:hit=x",  # unparsable hit
])
def test_fault_spec_rejects(bad):
    with pytest.raises(ValueError):
        FaultSpec.parse(bad)


def test_injector_hit_determinism():
    """hit= specs fire on exactly the named per-point hits."""
    inj = FaultInjector([FaultSpec.parse("codec.encode:ioerror:hit=2,4")])
    fired = []
    for i in range(1, 6):
        try:
            inj.fire("codec.encode", None)
        except OSError:
            fired.append(i)
    assert fired == [2, 4]
    assert inj.fired["codec.encode:ioerror"] == 2


def test_injector_probabilistic_seed_determinism():
    """Same seed -> identical firing pattern; p=1 always fires."""
    def pattern(seed):
        inj = FaultInjector([FaultSpec.parse("pipeline.fetch:ioerror:p=0.5")],
                            seed=seed)
        out = []
        for i in range(20):
            try:
                inj.fire("pipeline.fetch", None)
                out.append(0)
            except OSError:
                out.append(1)
        return out

    assert pattern(3) == pattern(3)
    assert 0 < sum(pattern(3)) < 20


def test_injector_corrupt_flips_one_byte_and_times_cap():
    inj = FaultInjector(
        [FaultSpec.parse("store.spill_write:corrupt:p=1:times=1")], seed=1)
    data = bytes(range(64))
    out = inj.fire("store.spill_write", data)
    assert len(out) == len(data)
    assert sum(a != b for a, b in zip(out, data)) == 1
    # times=1 exhausted: passes through untouched now
    assert inj.fire("store.spill_write", data) == data


def test_fault_point_is_noop_without_injector():
    payload = b"abc"
    assert fault_point("store.spill_read", payload) is payload
    assert fault_point("pipeline.fetch") is None


def test_injection_points_frozen():
    assert "checkpoint.write" in INJECTION_POINTS
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultInjector([FaultSpec.parse("store.spill_read:ioerror")]) \
            .fire("not.a.point", None)


# -- store integrity & typed I/O errors -------------------------------------

def test_spill_write_transient_ioerror_retried(ref9, tmp_path):
    ref, _ = ref9
    with inject_faults(["store.spill_write:ioerror:hit=1"]) as inj:
        with Simulator(QC9, _cfg(spill_dir=str(tmp_path))) as sim:
            amps = _amps(sim.run())
            assert sim.stats.n_io_retries >= 1
    assert inj.fired["store.spill_write:ioerror"] == 1
    assert np.array_equal(amps, ref)


def test_spill_io_exhaustion_is_typed(tmp_path):
    """Retries exhausted -> StoreIOError naming the key, not a raw
    OSError escaping a worker thread."""
    with inject_faults(["store.spill_write:ioerror"]):
        with pytest.raises(StoreIOError) as ei:
            with Simulator(QC9, _cfg(spill_dir=str(tmp_path))) as sim:
                sim.run()
    assert ei.value.key is not None
    assert ei.value.retries == 3
    assert "spill write" in str(ei.value)


def test_direct_disk_byte_flip_detected(tmp_path):
    """Flip one byte of a spilled blob on disk: the next read must raise
    BlockCorruptionError, never return wrong bytes."""
    store = BlockStore(ram_budget_bytes=64, spill_dir=str(tmp_path))
    try:
        store.put(0, b"A" * 256)
        store.put(1, b"B" * 256)          # pushes key 0 to disk
        spilled = [f for f in os.listdir(tmp_path)
                   if f.startswith("blob_")]
        assert spilled
        victim = os.path.join(str(tmp_path), spilled[0])
        raw = bytearray(open(victim, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        with open(victim, "wb") as f:
            f.write(bytes(raw))
        with pytest.raises(BlockCorruptionError) as ei:
            store.get(0)
        assert ei.value.expected_crc != ei.value.actual_crc
        assert store.stats.n_corruptions_detected == 1
    finally:
        store.close()


def test_checksums_off_skips_verification(tmp_path):
    store = BlockStore(ram_budget_bytes=64, spill_dir=str(tmp_path),
                       checksums=False)
    try:
        store.put(0, b"A" * 256)
        store.put(1, b"B" * 256)
        assert store.get(0) == b"A" * 256   # round-trips fine
        assert store.stats.n_corruptions_detected == 0
    finally:
        store.close()


def test_injected_corruption_detected_midrun(tmp_path):
    with inject_faults(["store.spill_write:corrupt:hit=1"]):
        with pytest.raises(BlockCorruptionError):
            with Simulator(QC9, _cfg(spill_dir=str(tmp_path))) as sim:
                _amps(sim.run())


def test_proactive_spill_moves_blobs(tmp_path):
    store = BlockStore(ram_budget_bytes=None, spill_dir=str(tmp_path))
    try:
        for k in range(8):
            store.put(k, bytes([k]) * 128)
        assert store.stats.disk_bytes == 0
        moved = store.spill(256)
        assert moved >= 6
        assert store.stats.ram_bytes <= 256
        assert store.stats.n_proactive_spills == moved
        for k in range(8):
            assert store.get(k) == bytes([k]) * 128
    finally:
        store.close()


# -- snapshot durability & validation ---------------------------------------

def _snapshot_of_run(tmp_path, name="snap.bmq"):
    path = str(tmp_path / name)
    with Simulator(QC9, _cfg()) as sim:
        sim.run().save(path)
    return path


def test_snapshot_truncation_detected(tmp_path):
    path = _snapshot_of_run(tmp_path)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(size - 7)
    with pytest.raises(CheckpointError, match="truncated|length"):
        BlockStore.restore(path)


def test_snapshot_blob_tamper_detected(tmp_path):
    path = _snapshot_of_run(tmp_path)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 9)                  # inside the last blob
        b = f.read(1)
        f.seek(size - 9)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(BlockCorruptionError, match="snapshot"):
        BlockStore.restore(path)


def test_snapshot_bad_magic_is_valueerror(tmp_path):
    path = str(tmp_path / "junk.bmq")
    with open(path, "wb") as f:
        f.write(b"not a checkpoint at all")
    with pytest.raises(ValueError):      # CheckpointError subclasses it
        BlockStore.restore(path)


def test_snapshot_leaves_no_temp_files(tmp_path):
    _snapshot_of_run(tmp_path)
    names = os.listdir(tmp_path)
    assert not [n for n in names if "tmp" in n]


def test_snapshot_write_ioerror_retried_then_typed(tmp_path):
    path = str(tmp_path / "ck.bmq")
    with Simulator(QC9, _cfg()) as sim:
        r = sim.run()
        with inject_faults(["checkpoint.write:ioerror:hit=1"]):
            r.save(path)                 # transient: retried
        store2, _ = BlockStore.restore(path)
        store2.close()
        with inject_faults(["checkpoint.write:ioerror"]):
            with pytest.raises(StoreIOError, match="snapshot"):
                r.save(str(tmp_path / "ck2.bmq"))
    assert not os.path.exists(str(tmp_path / "ck2.bmq"))


# -- simulator-level recovery contracts -------------------------------------

def test_auto_replay_from_checkpoint(ref9, tmp_path):
    """Corruption detected after a checkpoint exists -> the run replays
    from it in-process and still produces the correct state."""
    ref, _ = ref9
    ck = str(tmp_path / "ck.bmq")
    with inject_faults(["store.spill_write:corrupt:hit=40"]):
        with Simulator(QC9, _cfg()) as sim:
            amps = _amps(sim.run(checkpoint_path=ck, checkpoint_every=1))
            assert sim.stats.n_replays == 1
    assert np.array_equal(amps, ref)


def test_corruption_without_checkpoint_propagates(tmp_path):
    with inject_faults(["store.spill_write:corrupt:hit=40"]):
        with pytest.raises(BlockCorruptionError):
            with Simulator(QC9, _cfg(spill_dir=str(tmp_path))) as sim:
                _amps(sim.run())


def test_io_exhaustion_becomes_resumable(ref9, tmp_path):
    """checkpoint 2's write dies persistently -> ResumableError naming
    checkpoint 1, which reproduces the uninterrupted run."""
    ref, _ = ref9
    ck = str(tmp_path / "ck.bmq")
    with inject_faults(["checkpoint.write:ioerror:hit=2,3,4,5"]):
        with pytest.raises(ResumableError) as ei:
            with Simulator(QC9, _cfg()) as sim:
                sim.run(checkpoint_path=ck, checkpoint_every=1)
    assert ei.value.resume_path == ck and ei.value.stages_done == 1
    assert isinstance(ei.value.__cause__, StoreIOError)
    resumed = Simulator.resume(ck, circuit=QC9, config=_cfg())
    try:
        assert resumed._start_stage == 1
        assert np.array_equal(_amps(resumed.run()), ref)
    finally:
        resumed.close()


def test_midstage_fetch_crash_then_resume(ref9, tmp_path):
    """A hard crash inside a pipeline fetch (mid-stage!) leaves the last
    stage-boundary checkpoint on disk; resuming it is exact."""
    ref, n_stages = ref9
    assert n_stages > 3
    ck = str(tmp_path / "ck.bmq")
    with inject_faults(["pipeline.fetch:crash:hit=30"]):
        with pytest.raises(InjectedCrash):
            with Simulator(QC9, _cfg()) as sim:
                sim.run(checkpoint_path=ck, checkpoint_every=1)
    resumed = Simulator.resume(ck, circuit=QC9, config=_cfg())
    try:
        assert 0 < resumed._start_stage < n_stages
        assert np.array_equal(_amps(resumed.run()), ref)
    finally:
        resumed.close()


@pytest.mark.parametrize("backend", ["host", "device"])
def test_crash_resume_equivalence_every_boundary(backend, tmp_path):
    """Kill the run at EVERY stage boundary in turn (crash while writing
    checkpoint k+1, so checkpoint k is the last good one); resuming must
    reproduce the uninterrupted state — bitwise on the host codec,
    TV-bound on the lossy device codec (same compressed blocks, so in
    practice bitwise there too)."""
    qc = build_circuit("qft", 7)
    mk = lambda: EngineConfig(local_bits=4, codec_backend=backend,  # noqa: E731
                              devices=[CPU])
    with Simulator(qc, mk()) as sim:
        ref = _amps(sim.run())
        n_stages = sim.stats.n_stages
    assert n_stages >= 3
    for k in range(1, n_stages):
        ck = str(tmp_path / f"{backend}-{k}.bmq")
        with inject_faults([f"checkpoint.write:crash:hit={k + 1}"]):
            with pytest.raises(InjectedCrash):
                with Simulator(qc, mk()) as sim:
                    sim.run(checkpoint_path=ck, checkpoint_every=1)
        resumed = Simulator.resume(ck, circuit=qc, config=mk())
        try:
            assert resumed._start_stage == k
            amps = _amps(resumed.run())
        finally:
            resumed.close()
        assert np.array_equal(amps, ref), f"boundary {k} diverged"


@pytest.mark.parametrize("point,hit", [
    ("store.spill_write", 60),
    ("store.spill_read", 120),
    ("codec.encode", 60),
    ("codec.decode", 60),
    ("pipeline.fetch", 30),
    ("pipeline.store", 30),
    ("checkpoint.write", 3),
])
def test_every_point_crash_is_resumable(point, hit, ref9, tmp_path):
    """The fault matrix, crash row: a hard crash at EVERY registered
    injection point (at a hit deep enough that a checkpoint exists)
    leaves a checkpoint that reproduces the uninterrupted state."""
    ref, n_stages = ref9
    ck = str(tmp_path / f"{point}.bmq")
    with inject_faults([f"{point}:crash:hit={hit}"]) as inj:
        with pytest.raises(InjectedCrash):
            with Simulator(QC9, _cfg()) as sim:
                sim.run(checkpoint_path=ck, checkpoint_every=1)
    assert inj.fired[f"{point}:crash"] == 1
    assert os.path.exists(ck), f"no checkpoint survived {point} crash"
    resumed = Simulator.resume(ck, circuit=QC9, config=_cfg())
    try:
        assert 0 < resumed._start_stage < n_stages
        assert np.array_equal(_amps(resumed.run()), ref)
    finally:
        resumed.close()


# -- memory-pressure degradation ladder -------------------------------------

def test_pressure_ladder_escalates_in_order(ref9):
    """An (artificially) hopeless headroom walks shrink_window ->
    wave_depth_1 -> proactive_spill, one rung per boundary, and the run
    still completes correctly."""
    ref, _ = ref9
    with Simulator(QC9, _cfg(pipeline_depth=2,
                             pressure_headroom=1e-6)) as sim:
        amps = _amps(sim.run())
        rungs = [r.split(":")[1] for r in sim.stats.pressure_rungs]
        assert rungs == list(RUNGS)
        assert sim.stats.n_pressure_events == len(RUNGS)
        assert sim.stats.n_proactive_spills > 0
    assert np.array_equal(amps, ref)


def test_no_pressure_no_rungs(ref9):
    with Simulator(QC9, _cfg()) as sim:
        sim.run()
        assert sim.stats.pressure_rungs == []
        assert sim.stats.n_pressure_events == 0


def test_disk_budget_abort_is_resumable(ref9):
    """Disk-tier overflow aborts at a stage boundary with an emergency
    checkpoint; resuming it (without the budget) completes correctly."""
    ref, _ = ref9
    with pytest.raises(MemoryPressureError) as ei:
        with Simulator(QC9, _cfg(disk_budget_bytes=500)) as sim:
            sim.run()
    err = ei.value
    assert err.resume_path and os.path.exists(err.resume_path)
    assert err.stages_done >= 1
    assert any("abort" in r for r in sim.stats.pressure_rungs)
    try:
        resumed = Simulator.resume(err.resume_path, circuit=QC9,
                                   config=_cfg())
        try:
            assert resumed._start_stage == err.stages_done
            assert np.array_equal(_amps(resumed.run()), ref)
        finally:
            resumed.close()
    finally:
        os.unlink(err.resume_path)


def test_pressure_monitor_unit():
    class _Stats:
        disk_bytes = 0
        ram_bytes = 0

    class _Store:
        total_bytes = 10_000
        stats = _Stats()

    class _Pipe:
        depth = 4
        inflight_window = 2

    mon = PressureMonitor(predicted_bpa=1e-9, n_qubits=4, headroom=1.5)
    pipe = _Pipe()
    mon.check(_Store(), pipe, None, 1)
    assert pipe.inflight_window == 1 and pipe.depth == 4
    mon.check(_Store(), pipe, None, 2)
    assert pipe.depth == 1
    mon2 = PressureMonitor(predicted_bpa=1e9, n_qubits=4)
    mon2.check(_Store(), pipe, None, 1)
    assert mon2.rung == 0                 # no pressure, no escalation


# -- batched runs are checkpoint-free by contract ----------------------------

def test_run_batch_rejects_checkpointing(tmp_path):
    with Simulator(QC9, _cfg()) as sim:
        with pytest.raises(ValueError, match="run_batch does not support"):
            sim.run_batch([None, None],
                          checkpoint_path=str(tmp_path / "x.bmq"),
                          checkpoint_every=1)
        with pytest.raises(ValueError, match="run_batch does not support"):
            sim.run_batch([None], checkpoint_every=2)


# -- chaos: seeded random fault sweep ----------------------------------------

_CHAOS_MENU = [
    "store.spill_write:ioerror:p=0.02",
    "store.spill_read:ioerror:p=0.02",
    "store.spill_write:corrupt:hit=17",
    "pipeline.fetch:ioerror:hit=9",
    "pipeline.store:crash:hit=11",
    "codec.decode:crash:hit=25",
    "checkpoint.write:ioerror:hit=3",
    "checkpoint.write:crash:hit=4",
]


def test_chaos_typed_or_correct(ref9, tmp_path):
    """Under ANY injected fault mix the run either completes with the
    correct state or fails with a typed, attributable error — and when
    it names a resume path, that path reproduces the reference.  Seeded
    from BMQSIM_CHAOS_SEED so CI can sweep."""
    ref, _ = ref9
    seed = int(os.environ.get("BMQSIM_CHAOS_SEED", "0"))
    rng = random.Random(seed)
    specs = rng.sample(_CHAOS_MENU, k=2)
    ck = str(tmp_path / "chaos.bmq")
    try:
        with inject_faults(specs, seed=seed):
            with Simulator(QC9, _cfg()) as sim:
                amps = _amps(sim.run(checkpoint_path=ck,
                                     checkpoint_every=1))
        assert np.array_equal(amps, ref), f"specs={specs} seed={seed}"
    except (StoreIOError, BlockCorruptionError, InjectedCrash) as e:
        # typed + attributable; chaos may legitimately kill the run
        assert type(e).__module__.startswith("repro") or \
            isinstance(e, (OSError, RuntimeError))
    except ResumableError as e:
        assert e.resume_path
        resumed = Simulator.resume(e.resume_path, circuit=QC9,
                                   config=_cfg())
        try:
            assert np.array_equal(_amps(resumed.run()), ref), \
                f"resume diverged: specs={specs} seed={seed}"
        finally:
            resumed.close()


# -- spill path raises typed errors, not raw OSError -------------------------

def test_missing_spill_file_is_typed(tmp_path):
    """Deleting a spilled blob behind the store's back surfaces as a
    typed StoreIOError naming the path (FileNotFoundError is a rebind
    signal internally, but a truly missing blob must not leak raw)."""
    store = BlockStore(ram_budget_bytes=64, spill_dir=str(tmp_path))
    try:
        store.put(0, b"A" * 256)
        store.put(1, b"B" * 256)
        for f in os.listdir(tmp_path):
            if f.startswith("blob_"):
                os.unlink(os.path.join(str(tmp_path), f))
        with pytest.raises(StoreIOError, match="missing"):
            store.get(0)
    finally:
        store.close()


def test_segments_nbytes_matches_serialization():
    """The spill byte-ledger depends on nbytes == len(to_bytes())."""
    from repro_torch.compression.codec import encode_block_host
    from repro_torch.compression.pwrel import PwRelParams
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)) \
        .astype(np.complex64)
    seg = encode_block_host(x, PwRelParams(b_r=1e-3))
    assert seg.nbytes == len(seg.to_bytes())


# -- artifacts across the two packages ----------------------------------------

@pytest.fixture
def pkgs(request):
    """(writer, reader) package pair, by the test's ``direction``."""
    if repro is None:
        pytest.skip("needs JAX (the reference package)")
    return ((repro, repro_torch) if request.param == "repro_to_torch"
            else (repro_torch, repro))


def _pkg_cfg(pkg, codec, n):
    kw = {"local_bits": n - 4, "codec_backend": codec}
    if pkg is repro_torch:
        kw["devices"] = [CPU]
    return pkg.EngineConfig(**kw)


def _module(pkg, name):
    import importlib
    return importlib.import_module(f"{pkg.__name__}.{name}")


def test_injection_points_equal_repros():
    if repro is None:
        pytest.skip("needs JAX (the reference package)")
    assert INJECTION_POINTS == _module(repro, "faults").INJECTION_POINTS


@pytest.mark.parametrize("pkgs", ["repro_to_torch", "torch_to_repro"],
                         indirect=True)
@pytest.mark.parametrize("codec", ["host", "device"])
@pytest.mark.parametrize("name,n", [("ising", 10), ("qft", 9)])
def test_checkpoint_resumes_in_the_other_package(pkgs, codec, name, n,
                                                 tmp_path):
    """A mid-run checkpoint of one package (the run killed while writing
    the next one) resumes in the other: its blocks restore byte for byte,
    and the resumed run reproduces the reading package's uninterrupted
    run — bit for bit on qft from |0...0> (one code a plane, so the two
    packages' blocks agree), within 1e-6 in direction on ising, whose
    codes take many values (pwrel codes are not byte-equal between the
    packages: XLA's log2 is not correctly rounded)."""
    writer, reader = pkgs
    wc, rc = writer.build_circuit(name, n), reader.build_circuit(name, n)
    with reader.Simulator(rc, _pkg_cfg(reader, codec, n)) as sim:
        want = sim.run().statevector()
        n_stages = sim.stats.n_stages
    k = n_stages // 2
    assert 0 < k < n_stages - 1
    ck = str(tmp_path / "ck.bmq")
    crash = _module(writer, "faults").InjectedCrash
    with writer.inject_faults([f"checkpoint.write:crash:hit={k + 1}"]):
        with pytest.raises(crash):
            with writer.Simulator(wc, _pkg_cfg(writer, codec, n)) as sim:
                sim.run(checkpoint_path=ck, checkpoint_every=1)
    wstore, wmeta = _module(writer, "compression.store").BlockStore \
        .restore(ck)
    rstore, rmeta = _module(reader, "compression.store").BlockStore \
        .restore(ck)
    try:
        assert rmeta == wmeta and rmeta["stages_done"] == k
        assert sorted(rstore.keys()) == sorted(wstore.keys())
        assert all(rstore.get(key) == wstore.get(key)
                   for key in wstore.keys())
    finally:
        wstore.close()
        rstore.close()
    resumed = reader.Simulator.resume(ck, circuit=rc,
                                      config=_pkg_cfg(reader, codec, n))
    try:
        assert resumed._start_stage == k
        got = resumed.run().statevector()
    finally:
        resumed.close()
    if name == "qft":
        assert np.array_equal(got, want)
    else:
        assert not np.array_equal(got, want)      # the codes took over
        assert fidelity(got, want) / (norm(got) * norm(want)) >= 1 - 1e-6


@pytest.mark.parametrize("pkgs", ["repro_to_torch", "torch_to_repro"],
                         indirect=True)
def test_block_store_snapshot_restores_in_the_other_package(pkgs,
                                                             tmp_path):
    """A BlockStore snapshot (raw blobs, an alias, a structured block, a
    spilled blob) written by one package restores in the other, meta and
    bytes equal; a flipped byte is detected there too."""
    writer, reader = pkgs
    WStore = _module(writer, "compression.store").BlockStore
    RStore = _module(reader, "compression.store").BlockStore
    codec = _module(writer, "compression.codec")
    params = _module(writer, "compression.pwrel").PwRelParams(b_r=1e-3)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)) \
        .astype(np.complex64)
    seg = codec.encode_block_host(x, params)
    path = str(tmp_path / "snap.bmq")
    meta = {"kind": "test", "n": 4}
    store = WStore(ram_budget_bytes=600, spill_dir=str(tmp_path))
    try:
        store.put(0, b"A" * 256)
        store.put(1, bytes(range(256)))
        store.put_alias(2, 0)
        store.put_block(3, seg)
        assert store.stats.disk_bytes > 0          # one blob spilled
        store.snapshot(path, meta)
        blobs = {k: store.get(k) for k in store.keys()}
    finally:
        store.close()
    back, got_meta = RStore.restore(path)
    try:
        assert got_meta == meta
        assert {k: back.get(k) for k in back.keys()} == blobs
        assert back.get_block(3).to_bytes() == seg.to_bytes()
    finally:
        back.close()
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - 9)
        b = f.read(1)
        f.seek(size - 9)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(_module(reader, "errors").BlockCorruptionError):
        RStore.restore(path)


# -- on a card: a fault-injected device-codec run -----------------------------

@pytest.mark.cuda
def test_cuda_device_codec_crash_resume_and_replay(tmp_path):
    """On the card, device codec, the disk tier forced: a codec.decode
    crash two thirds into a checkpointed run leaves a checkpoint whose
    resume equals the uninterrupted card run bit for bit; a corrupted
    spill read is detected and replayed from the last checkpoint, with
    the same result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    qc = build_circuit("ising", 14)

    def mk():
        return EngineConfig(local_bits=8, codec_backend="device",
                            ram_budget_bytes=1 << 12)
    ck = str(tmp_path / "ck.bmq")
    never = 1 << 40
    with inject_faults([f"codec.decode:ioerror:hit={never}",
                        f"store.spill_read:ioerror:hit={never}"]) as inj:
        with Simulator(qc, mk()) as sim:
            result = sim.run(checkpoint_path=ck, checkpoint_every=1)
            hits = dict(inj._hits)          # the run's, not the readout's
            want = result.statevector()
            n_stages = sim.stats.n_stages
            assert sim.stats.n_spills > 0
    assert n_stages >= 3 and hits["store.spill_read"] >= 3
    os.unlink(ck)
    with inject_faults(
            [f"codec.decode:crash:hit={2 * hits['codec.decode'] // 3}"]):
        with pytest.raises(InjectedCrash):
            with Simulator(qc, mk()) as sim:
                sim.run(checkpoint_path=ck, checkpoint_every=1)
    resumed = Simulator.resume(ck, circuit=qc, config=mk())
    try:
        assert 0 < resumed._start_stage < n_stages
        assert np.array_equal(resumed.run().statevector(), want)
    finally:
        resumed.close()
    hit = 2 * hits["store.spill_read"] // 3
    with inject_faults([f"store.spill_read:corrupt:hit={hit}"]) as inj:
        with Simulator(qc, mk()) as sim:
            got = sim.run(checkpoint_path=str(tmp_path / "ck2.bmq"),
                          checkpoint_every=1).statevector()
            assert sim.stats.n_replays >= 1
    assert inj.fired["store.spill_read:corrupt"] == 1
    assert np.array_equal(got, want)
