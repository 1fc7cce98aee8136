"""The port's shard container and native shard I/O, against the JAX
package's on the same numpy inputs.

Every format case runs twice, through the native reader / writer
(``storage/native``, built by g++) and through the numpy path, switched by
monkeypatching the port's ``shard_format._native``:

* the bytes the port writes equal the reference's, and each package reads
  the other's shards (whole-shard loads, selective reads, headers);
* the counterparts of tests/test_shards.py: the selective read, missing
  centroid, shard-id mismatch, corrupt header, truncation, the corruption
  fuzz (50 + 20 trials, where both packages must agree), 4-thread
  concurrent reads and the mmap view;
* the library builds from the port's own source into build/torch_shardio/,
  also when two processes build it at once.
"""

import concurrent.futures
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import vector_indexer_tpu.storage.shard_format as jsf
from vector_indexer_tpu_torch.storage import shard_format as sf
from vector_indexer_tpu_torch.storage.native import shardio

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(params=["native", "numpy"])
def io_path(request, monkeypatch):
    """Run the test through the native library or the numpy path."""
    if request.param == "native":
        assert shardio.available(), "g++ could not build the native shard library"
        monkeypatch.setattr(sf, "_native", lambda: shardio)
    else:
        monkeypatch.setattr(sf, "_native", lambda: None)
    return request.param


def _cluster(mod, cid, dim, m, seed=0, id_offset=0):
    g = np.random.default_rng(seed)
    return mod.ClusterData(
        centroid_id=cid,
        centroid=g.normal(size=dim).astype(np.float32),
        internal_ids=np.arange(id_offset, id_offset + m, dtype=np.uint64),
        external_ids=np.arange(1000 + id_offset, 1000 + id_offset + m, dtype=np.uint64),
        timestamps=np.full(m, 77, dtype=np.uint64),
        vectors=g.normal(size=(m, dim)).astype(np.float32),
    )


def _shard(mod, sid=2, dim=12, ids=(0, 7, 42, 2**64 - 1000), m=(9, 0, 5, 3)):
    clusters = [_cluster(mod, cid, dim, mm, seed=i, id_offset=100 * i)
                for i, (cid, mm) in enumerate(zip(ids, m))]
    return mod.Shard(id=sid, dimension=dim, clusters=clusters)


def _assert_cluster_equal(a, b):
    assert int(a.centroid_id) == int(b.centroid_id)
    for f in ("centroid", "internal_ids", "external_ids", "timestamps", "vectors"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y)


def _assert_shard_equal(a, b):
    assert (a.id, a.dimension, len(a.clusters)) == (b.id, b.dimension, len(b.clusters))
    for x, y in zip(a.clusters, b.clusters):
        _assert_cluster_equal(x, y)


@pytest.mark.parametrize("dim", [5, 12])
def test_written_bytes_equal_reference(io_path, tmp_path, dim):
    p = sf.save_shard(_shard(sf, dim=dim), tmp_path / "port")
    q = jsf.save_shard(_shard(jsf, dim=dim), tmp_path / "ref")
    assert p.name == q.name == "shard_2.bin"
    assert p.read_bytes() == q.read_bytes()


def test_reference_reads_port_shard(io_path, tmp_path):
    shard = _shard(sf)
    p = sf.save_shard(shard, tmp_path)
    _assert_shard_equal(jsf.load_shard_from_disk(p), shard)
    h = jsf.read_shard_header(p)
    assert (h.shard_id, h.dimensions, h.num_centroids) == (2, 12, 4)
    got = jsf.read_centroid_vectors(p, 2, [42, 2**64 - 1000])
    _assert_cluster_equal(got[42], shard.clusters[2])
    _assert_cluster_equal(got[2**64 - 1000], shard.clusters[3])


def test_port_reads_reference_shard(io_path, tmp_path):
    shard = _shard(jsf)
    p = jsf.save_shard(shard, tmp_path)
    _assert_shard_equal(sf.load_shard_from_disk(p), shard)
    assert sf.read_shard_header(p) == sf.ShardHeader(**vars(jsf.read_shard_header(p)))
    got = sf.read_centroid_vectors(p, 2, [7, 0])
    assert list(got) == [7, 0]
    _assert_cluster_equal(got[7], shard.clusters[1])  # an empty posting list
    _assert_cluster_equal(got[0], shard.clusters[0])


def test_selective_centroid_read(io_path, tmp_path):
    clusters = [_cluster(sf, i, 8, 6, seed=i) for i in range(5)]
    sf.save_shard(sf.Shard(id=1, dimension=8, clusters=clusters), tmp_path)
    out = sf.read_centroid_vectors(sf.shard_path(tmp_path, 1), 1, [2, 4])
    assert set(out) == {2, 4}
    _assert_cluster_equal(out[2], clusters[2])
    _assert_cluster_equal(out[4], clusters[4])


def test_missing_shard_errors(io_path, tmp_path):
    for read in (sf.load_shard_from_disk, sf.read_shard_header,
                 lambda p: sf.read_centroid_vectors(p, 5, [0])):
        with pytest.raises(sf.ShardFormatError, match="not found"):
            read(sf.shard_path(tmp_path, 5))


def test_missing_centroid_errors(io_path, tmp_path):
    sf.save_shard(sf.Shard(id=0, dimension=4, clusters=[_cluster(sf, 0, 4, 2)]), tmp_path)
    with pytest.raises(sf.ShardFormatError, match="centroid 99 not in shard 0"):
        sf.read_centroid_vectors(sf.shard_path(tmp_path, 0), 0, [99])


def test_shard_id_mismatch_errors(io_path, tmp_path):
    sf.save_shard(sf.Shard(id=0, dimension=4, clusters=[_cluster(sf, 0, 4, 2)]), tmp_path)
    with pytest.raises(sf.ShardFormatError, match="mismatch: expected 123, found 0"):
        sf.read_centroid_vectors(sf.shard_path(tmp_path, 0), 123, [0])


def test_corrupt_header_errors_not_crashes(io_path, tmp_path):
    sf.save_shard(sf.Shard(id=0, dimension=4, clusters=[_cluster(sf, 0, 4, 2)]), tmp_path)
    p = sf.shard_path(tmp_path, 0)
    raw = bytearray(p.read_bytes())
    raw[5] ^= 0xFF
    raw[20] ^= 0xAA
    p.write_bytes(bytes(raw))
    for read in (sf.load_shard_from_disk, sf.read_shard_header,
                 lambda p: sf.read_centroid_vectors(p, 0, [0])):
        with pytest.raises(sf.ShardFormatError):
            read(p)


def test_truncated_file_errors(io_path, tmp_path):
    sf.save_shard(sf.Shard(id=0, dimension=4, clusters=[_cluster(sf, 0, 4, 50)]), tmp_path)
    p = sf.shard_path(tmp_path, 0)
    raw = p.read_bytes()
    p.write_bytes(raw[: len(raw) // 2])
    with pytest.raises(sf.ShardFormatError, match="truncated"):
        sf.load_shard_from_disk(p)
    with pytest.raises(sf.ShardFormatError, match="truncated"):
        sf.read_centroid_vectors(p, 0, [0])


def _outcome(mod, p):
    try:
        return mod.load_shard_from_disk(p)
    except mod.ShardFormatError as e:
        return str(e)


def test_corruption_fuzz_agrees_with_reference(io_path, tmp_path, rng):
    # Any byte-level corruption surfaces as ShardFormatError, or parses
    # cleanly when it misses the validated fields; never a crash. Both
    # packages reach the same outcome on every corrupted file.
    clusters = [_cluster(sf, i, 8, 12, seed=i) for i in range(3)]
    sf.save_shard(sf.Shard(id=2, dimension=8, clusters=clusters), tmp_path)
    p = sf.shard_path(tmp_path, 2)
    raw = bytearray(p.read_bytes())
    files = []
    for _ in range(50):
        bad = bytearray(raw)
        for _ in range(rng.integers(1, 4)):
            pos = int(rng.integers(0, len(bad)))
            bad[pos] ^= int(rng.integers(1, 256))
        files.append(bytes(bad))
    files += [bytes(raw[: int(rng.integers(0, len(raw)))]) for _ in range(20)]
    errors = 0
    for data in files:
        p.write_bytes(data)
        got, ref = _outcome(sf, p), _outcome(jsf, p)
        if isinstance(ref, str):
            assert got == ref
            errors += 1
        else:
            _assert_shard_equal(got, ref)
    assert errors >= 20  # every cut file that loses a byte of a block errs


def test_concurrent_reads(io_path, tmp_path):
    # parity: shards_tests.rs:729-767 (4-thread concurrent reads)
    clusters = [_cluster(sf, i, 8, 20, seed=i) for i in range(4)]
    sf.save_shard(sf.Shard(id=0, dimension=8, clusters=clusters), tmp_path)
    p = sf.shard_path(tmp_path, 0)

    def work(i):
        out = sf.read_centroid_vectors(p, 0, [i])
        whole = sf.load_shard_from_disk(p)
        return (np.array_equal(out[i].vectors, clusters[i].vectors)
                and np.array_equal(whole.clusters[i].vectors, clusters[i].vectors))

    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        assert all(ex.map(work, list(range(4)) * 8))


def test_native_path_is_taken(tmp_path, monkeypatch):
    """With the library present, writes, whole loads, selective reads and
    header reads all go through it (mmap for the loads)."""
    assert shardio.available()
    calls = []
    for name in ("write_file", "read_file", "mmap_view"):
        fn = getattr(shardio, name)
        monkeypatch.setattr(shardio, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    shard = _shard(sf)
    p = sf.save_shard(shard, tmp_path)
    _assert_shard_equal(sf.load_shard_from_disk(p), shard)
    sf.read_centroid_vectors(p, 2, [0])
    sf.read_shard_header(p)
    assert calls == ["write_file", "mmap_view", "mmap_view", "read_file"]


def test_native_mmap_view_matches_read(tmp_path):
    """The zero-copy mmap view sees exactly the file's bytes and is
    read-only; loads through it equal loads through the numpy path; an
    empty file is refused by the mapping and the read that follows raises
    ShardFormatError (reference: tests/test_shards.py)."""
    assert shardio.available()
    shard = sf.Shard(id=5, dimension=12,
                     clusters=[_cluster(sf, 0, 12, 9), _cluster(sf, 1, 12, 4, seed=1)])
    p = sf.save_shard(shard, tmp_path)
    raw = p.read_bytes()
    with shardio.mmap_view(str(p)) as mv:
        assert bytes(mv) == raw
        assert mv.readonly
    assert shardio.read_file(str(p)) == raw
    assert shardio.read_file(str(p), 40, 16) == raw[40:56]
    assert shardio.read_file(str(p), len(raw) - 3, 16) == raw[-3:]
    got = sf.load_shard_from_disk(p)
    assert got.num_vectors == 13
    _assert_shard_equal(got, shard)
    empty = tmp_path / "shard_9.bin"
    empty.write_bytes(b"")
    with pytest.raises(OSError):
        with shardio.mmap_view(str(empty)):
            pass
    with pytest.raises(sf.ShardFormatError, match="truncated header"):
        sf.load_shard_from_disk(empty)
    with pytest.raises(OSError):
        shardio.read_file(str(tmp_path / "absent.bin"))


def test_library_builds_from_source_into_build_dir():
    assert shardio.available()
    lib = shardio.library_path()
    assert lib.parent == ROOT / "build" / "torch_shardio"
    assert lib.is_file() and shardio.build_library() == lib
    assert shardio.SRC == ROOT / "vector_indexer_tpu_torch/storage/native/shardio.cpp"
    # The file name carries the source's hash; nothing is built into the package.
    assert lib.name.startswith("libvitorch_shardio_") and len(lib.stem.split("_")[-1]) == 16
    assert not list(shardio.SRC.parent.glob("*.so"))


_BUILD_CHILD = """
import ctypes, sys, time
from pathlib import Path
sys.path.insert(0, {root!r})
from vector_indexer_tpu_torch.storage.native import shardio
out, me = Path({out!r}), sys.argv[1]
(out / ("ready_" + me)).touch()
t_end = time.time() + 60
while not (out / "go").exists() and time.time() < t_end:
    time.sleep(0.001)
lib = ctypes.CDLL(str(shardio.build_library(out)))
lib.vix_file_size.argtypes = [ctypes.c_char_p]
lib.vix_file_size.restype = ctypes.c_int64
print(lib.vix_file_size({src!r}.encode()))
"""


def test_two_processes_build_at_once(tmp_path):
    code = _BUILD_CHILD.format(root=str(ROOT), out=str(tmp_path), src=str(shardio.SRC))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        t_end = time.time() + 60
        while not all((tmp_path / f"ready_{i}").exists() for i in range(2)):
            assert time.time() < t_end and all(p.poll() is None for p in procs)
            time.sleep(0.01)
        (tmp_path / "go").touch()
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    size = shardio.SRC.stat().st_size
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert int(out.strip()) == size
    libs = sorted(tmp_path.glob("*.so"))
    assert [x.name for x in libs] == [shardio.library_path(tmp_path).name]
    assert not list(tmp_path.glob("*.tmp"))
    assert ctypes.CDLL(str(libs[0])).vix_mmap_close(None, 0) == 0
