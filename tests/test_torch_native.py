"""The port's build of the repo's C++ runtime (``bigdl_tpu_torch/native``)
held against the JAX package's codec, reader and augment.

Exact comparisons: the CRC32C values, TFRecord frames and parsed
payloads equal the JAX codec's (its Python path and, where it is built,
its C++ one); ``PrefetchReader`` returns reads in submission order on
the C++ pool and on the Python pool, raises ``OSError`` on a failed read
and ``IndexError`` with nothing outstanding; ``RecordFileDataSet`` walks
the JAX reader's records through the C++ pool; ``fused_augment`` and
the fused transform give the numpy path's and the JAX transformer's
float32 bytes, and the transform is shown to call the kernel. The
build: concurrent builds of one library, a new name for an edited
source, a compile error raised with the compiler's output, the library
under ``build/bigdl_tpu_torch/`` and never the JAX package's, and the
Python paths where there is no compiler.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bigdl_tpu.native as jnative
from bigdl_tpu.dataset.records import RecordFileDataSet as JaxRecords
from bigdl_tpu.transform import vision as jvision
from bigdl_tpu_torch import native
from bigdl_tpu_torch.dataset.records import (RecordFileDataSet,
                                             write_record_shards)
from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.transform import vision

REPO = Path(__file__).resolve().parents[1]
PAYLOADS = [b"", b"a", b"123456789", b"\x00\xff" * 300,
            bytes(range(256)) * 41]
MEANS, STDS = [123.68, 116.779, 103.939], [58.393, 57.12, 57.375]


class _python_codec:
    """The port's (or the JAX package's) module with its library set
    aside, so its Python path runs."""

    def __init__(self, mod):
        self.mod = mod

    def __enter__(self):
        self.mod.get_lib()
        self.saved = self.mod._lib, self.mod._tried
        self.mod._lib, self.mod._tried = None, True
        return self.mod

    def __exit__(self, *exc):
        self.mod._lib, self.mod._tried = self.saved


# ------------------------------------------------------------- codec
def test_crc_and_frames_equal_the_jax_codec():
    assert native.crc32c(b"123456789") == 0xE3069283
    ours = [(native.crc32c(p), native.masked_crc32c(p),
             native.tfrecord_frame(p)) for p in PAYLOADS]
    with _python_codec(native):
        py = [(native.crc32c(p), native.masked_crc32c(p),
               native.tfrecord_frame(p)) for p in PAYLOADS]
    with _python_codec(jnative):
        jax_py = [(jnative.crc32c(p), jnative.masked_crc32c(p),
                   jnative.tfrecord_frame(p)) for p in PAYLOADS]
    assert ours == py == jax_py
    if jnative.native_available():
        assert ours == [(jnative.crc32c(p), jnative.masked_crc32c(p),
                         jnative.tfrecord_frame(p)) for p in PAYLOADS]
    blob = b"".join(f for _, _, f in ours)
    assert list(native.tfrecord_iter(blob)) == PAYLOADS
    assert list(jnative.tfrecord_iter(blob)) == PAYLOADS


@pytest.mark.parametrize("flip,err", [(3, "length crc"), (14, "data crc")])
def test_tfrecord_iter_detects_corruption(flip, err):
    blob = bytearray(native.tfrecord_frame(b"hello world"))
    blob[flip] ^= 0xFF
    with pytest.raises(ValueError, match=err):
        list(native.tfrecord_iter(bytes(blob)))
    with pytest.raises(ValueError, match="truncated"):
        list(native.tfrecord_iter(native.tfrecord_frame(b"hello")[:-3]))


# ------------------------------------------------------------ reader
def _files(tmp_path, n=6):
    rs = np.random.RandomState(0)
    paths = []
    for i in range(n):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(rs.bytes(1000 + 37 * i))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("use_native", [True, False])
def test_prefetch_reader_order_errors_and_eof(tmp_path, use_native):
    paths = _files(tmp_path)
    jobs = [(p, off, ln) for p in paths
            for off, ln in ((0, 0), (5, 10), (999, 1), (17, 0))]
    with native.PrefetchReader(n_threads=4, capacity=64,
                               use_native=use_native) as r:
        assert r.native is use_native
        ids = [r.submit(*j) for j in jobs]
        assert ids == list(range(len(jobs)))
        got = [r.next() for _ in jobs]
        with pytest.raises(IndexError):
            r.next()
    want = []
    for p, off, ln in jobs:
        data = Path(p).read_bytes()[off:]
        want.append(data[:ln] if ln else data)
    assert got == want
    with jnative.PrefetchReader(n_threads=4, capacity=64) as jr:
        for j in jobs:
            jr.submit(*j)
        assert [jr.next() for _ in jobs] == got
    with native.PrefetchReader(use_native=use_native) as r:
        r.submit(paths[0], 0, 4)
        r.submit(str(tmp_path / "missing.bin"))
        r.submit(paths[1], 0, 4)
        assert r.next() == want[0][:4]
        with pytest.raises(OSError):
            r.next()
        assert r.next() == Path(paths[1]).read_bytes()[:4]


def test_prefetch_reader_backpressure_keeps_order(tmp_path):
    """More reads than the C++ pool's capacity, drained as they go."""
    paths = _files(tmp_path, 3)
    with native.PrefetchReader(n_threads=2, capacity=4) as r:
        got, pending = [], 0
        for i in range(40):
            r.submit(paths[i % 3], i, 3)
            pending += 1
            if pending == 4:
                got.append(r.next())
                pending -= 1
        got += [r.next() for _ in range(pending)]
    assert got == [Path(paths[i % 3]).read_bytes()[i:i + 3]
                   for i in range(40)]


def _shards(tmp_path):
    rs = np.random.RandomState(1)
    samples = [Sample(rs.randint(0, 255, (6, 5, 3), np.uint8),
                      np.array([float(i)], np.float32)) for i in range(23)]
    write_record_shards(samples, str(tmp_path), num_shards=4)
    return str(tmp_path)


def _take(it, n):
    return [(s.feature().tobytes(), s.label().tobytes())
            for s, _ in zip(it, range(n))]


def test_record_reader_walks_the_jax_records_through_the_cpp_pool(tmp_path):
    d = _shards(tmp_path)
    for shard in (0, 1):
        ours = RecordFileDataSet(d, shard_id=shard, num_shards=2, seed=3,
                                 lookahead=5)
        pool = RecordFileDataSet(d, shard_id=shard, num_shards=2, seed=3,
                                 lookahead=5, native_reader=False)
        theirs = JaxRecords(d, shard_id=shard, num_shards=2, seed=3,
                            lookahead=5)
        assert ours.local_size() == theirs.local_size()
        for train, n in ((False, ours.local_size()), (True, 40)):
            walk = _take(ours.data(train=train), n)
            assert ours.reader_pool == "native"
            assert walk == _take(pool.data(train=train), n)
            assert pool.reader_pool == "python"
            assert walk == _take(theirs.data(train=train), n)
        ours.shuffle()
        theirs.shuffle()
        assert _take(ours.data(), 30) == _take(theirs.data(), 30)


# ----------------------------------------------------- fused augment
def test_fused_augment_checks_its_arguments():
    img = np.random.RandomState(2).randint(0, 255, (10, 12, 3), np.uint8)
    inv = 1.0 / np.asarray(STDS, np.float32)
    ok = native.fused_augment(img, 1, 2, 8, 9, True, MEANS, inv)
    assert ok.shape == (8, 9, 3) and ok.dtype == np.float32
    for args in ((img, 3, 0, 8, 9), (img, 0, 4, 8, 9), (img, -1, 0, 8, 9),
                 (img, 0, 0, 0, 9), (img.astype(np.float32), 0, 0, 8, 9),
                 (img[:, ::-1], 0, 0, 8, 9), (img[..., :2], 0, 0, 8, 9),
                 (img[..., 0], 0, 0, 8, 9)):
        assert native.fused_augment(*args, False, MEANS, inv) is None, args
    assert native.fused_augment(img, 0, 0, 8, 9, False, MEANS[:2],
                                inv[:2]) is None


def test_fused_transform_calls_the_kernel_bit_for_bit():
    rs = np.random.RandomState(3)
    imgs = [rs.randint(0, 255, (40, 48, 3), np.uint8) for _ in range(6)]

    def run(pkg, flip_prob, **kw):
        t = pkg.FusedCropFlipNormalize(32, 32, MEANS, STDS,
                                       flip_prob=flip_prob, seed=11, **kw)
        return t, [np.asarray(t.transform(pkg.ImageFeature(
            img.copy(), label=None, preserve_dtype=True)).image())
            for img in imgs]

    calls = []
    orig = native.fused_augment

    def counting(*a, **k):
        out = orig(*a, **k)
        calls.append(out is not None)
        return out

    for flip_prob in (0.0, 0.5, 1.0):
        native.fused_augment = counting
        try:
            t, fast = run(vision, flip_prob)
        finally:
            native.fused_augment = orig
        assert calls and all(calls) and len(calls) == len(imgs)
        assert t.native_images == len(imgs) and t.numpy_images == 0
        calls.clear()
        t, slow = run(vision, flip_prob, use_native=False)
        assert t.native_images == 0 and t.numpy_images == len(imgs)
        _, theirs = run(jvision, flip_prob)
        for a, b, c in zip(fast, slow, theirs):
            assert a.shape == (32, 32, 3) and a.dtype == np.float32
            assert a.tobytes() == b.tobytes() == c.tobytes()


def test_fused_transform_on_workers_keeps_the_serial_stream():
    rs = np.random.RandomState(4)
    imgs = [rs.randint(0, 255, (36, 30, 3), np.uint8) for _ in range(20)]

    def stream(workers):
        t = vision.FusedCropFlipNormalize(24, 24, MEANS, STDS, flip_prob=0.5,
                                          seed=7, workers=workers)
        feats = (vision.ImageFeature(img.copy(), label=None,
                                     preserve_dtype=True) for img in imgs)
        return t, [np.asarray(f.image()).tobytes() for f in t(feats)]

    (t1, serial), (t3, threaded) = stream(1), stream(3)
    assert serial == threaded and t3.native_images == len(imgs)


# ------------------------------------------------------------- build
def _sources(tmp_path):
    d = tmp_path / "native"
    d.mkdir()
    for s in native.SOURCES:
        shutil.copy(s, d / s.name)
    return [d / s.name for s in native.SOURCES]


_BUILD = """
import sys
from pathlib import Path
from bigdl_tpu_torch import native
srcs = [Path(p) for p in sys.argv[2:]]
print(native.build(srcs, Path(sys.argv[1])))
"""


def test_concurrent_builds_give_one_library(tmp_path):
    srcs = _sources(tmp_path)
    out = tmp_path / "build"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(out),
                               *map(str, srcs)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    results = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), results
    paths = {r[0].strip() for r in results}
    assert paths == {str(native.library_path(srcs, out))}
    assert [f.name for f in out.iterdir()] == [Path(paths.pop()).name]
    import ctypes

    lib = ctypes.CDLL(str(native.library_path(srcs, out)))
    lib.bigdl_crc32c.restype = ctypes.c_uint32
    lib.bigdl_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    assert lib.bigdl_crc32c(b"123456789", 9) == 0xE3069283


def test_an_edited_source_gets_a_new_library_and_errors_raise(tmp_path):
    srcs = _sources(tmp_path)
    out = tmp_path / "build"
    before = native.library_path(srcs, out)
    assert before == native.library_path(srcs, out)
    with open(srcs[2], "a") as f:
        f.write("\n// edited\n")
    assert native.library_path(srcs, out) != before
    with open(srcs[2], "a") as f:
        f.write("this is not C++;\n")
    with pytest.raises(RuntimeError, match="build failed") as e:
        native.build(srcs, out)
    assert "error" in str(e.value)
    assert not list(out.glob("*"))          # no library, no temp file left


def test_the_library_is_the_ports_own_and_built_without_make(
        tmp_path, monkeypatch):
    lib_path = native.library_path()
    assert lib_path.parent == REPO / "build" / "bigdl_tpu_torch"
    assert lib_path.exists()
    calls = []
    real_run = subprocess.run

    def recording(cmd, *a, **k):
        calls.append(list(cmd))
        return real_run(cmd, *a, **k)

    monkeypatch.setattr(subprocess, "run", recording)
    native.build(_sources(tmp_path), tmp_path / "build")
    assert len(calls) == 1 and Path(calls[0][0]).name != "make"
    assert "-shared" in calls[0] and "-lpthread" in calls[0]
    # each process links to its own temporary file, renamed into place
    tmp = calls[0][calls[0].index("-o") + 1]
    assert tmp.endswith(f".{os.getpid()}.tmp"), tmp
    drive = ("from bigdl_tpu_torch import native\n"
             "from bigdl_tpu_torch.utils import tfrecord\n"
             "assert native.native_available()\n"
             "assert tfrecord.crc32c(b'123456789') == 0xE3069283\n"
             "import sys\n"
             "assert not [m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'bigdl_tpu')]\n"
             "print(open('/proc/self/maps').read())\n")
    proc = real_run([sys.executable, "-c", drive], cwd=REPO,
                    env=dict(os.environ, PYTHONPATH=""), capture_output=True,
                    text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert str(lib_path) in proc.stdout
    assert "bigdl_tpu/native/libbigdl_native" not in proc.stdout


def test_without_a_compiler_the_python_paths_run(tmp_path):
    drive = ("import numpy as np\n"
             "from bigdl_tpu_torch import native\n"
             "assert not native.native_available()\n"
             "print(native.unavailable_reason())\n"
             "assert native.crc32c(b'123456789') == 0xE3069283\n"
             "img = np.zeros((4, 4, 3), np.uint8)\n"
             "assert native.fused_augment(img, 0, 0, 2, 2, False, [0] * 3, "
             "[1] * 3) is None\n"
             "r = native.PrefetchReader()\n"
             "assert not r.native\n"
             f"r.submit({str(REPO / 'native' / 'augment.cc')!r}, 0, 6)\n"
             "assert r.next() == b'// Fus'\n")
    env = {k: v for k, v in os.environ.items() if k != "CXX"}
    env.update(PATH=str(tmp_path), PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", drive], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "no C++ compiler" in proc.stdout
