"""The port's data pipeline (data/tfrecord.py, data/native.py,
data/nsynth.py) against the JAX package's: the same bytes, records and
batches, bit for bit, and the behaviour commit 6526b1c fixed (int64 sign
fold, short examples padded, a mid-stream reader error propagates,
zero-length records kept)."""

import ctypes
import os

import numpy as np
import pytest

from audio_style_transfer_tpu.data import NSynthDataset as JNSynthDataset
from audio_style_transfer_tpu.data import tfrecord as jtfrecord
from audio_style_transfer_tpu_torch.data import (
    NSynthDataset,
    build_example,
    native,
    parse_example,
    read_tfrecord,
    write_tfrecord,
)
from audio_style_transfer_tpu_torch.data.tfrecord import crc32c, masked_crc32c


def example(i, n=64000, seed=0, family=None):
    rng = np.random.RandomState(seed + i)
    return {
        "note_str": f"note-{i}".encode(),
        "pitch": np.array([40 + i], np.int64),
        "velocity": np.array([100], np.int64),
        "audio": rng.randn(n).astype(np.float32) * 0.1,
        "qualities": np.zeros(10, np.int64),
        "instrument_source": np.array([0], np.int64),
        "instrument_family": np.array([i % 3 if family is None else family], np.int64),
    }


@pytest.fixture(scope="module")
def nsynth_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("nsynth") / "nsynth.tfrecord")
    write_tfrecord(path, [build_example(example(i, n=8000)) for i in range(12)])
    return path


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library()
    if lib is None:
        pytest.skip("the native reader does not build here (no g++)")
    return lib


def test_crc32c_known_vectors_and_jax_agreement():
    # RFC 3720 test vectors
    assert crc32c(b"") == 0
    assert crc32c(b"\x00" * 32) == 0x8A9136AA
    assert crc32c(b"123456789") == 0xE3069283
    data = np.random.RandomState(0).bytes(4099)
    assert crc32c(data) == jtfrecord.crc32c(data)
    assert masked_crc32c(data) == jtfrecord.masked_crc32c(data)


def test_build_example_bytes_equal_jax():
    feats = dict(example(3, n=100), neg=np.array([-1, -(2**63), 2**62, 0, 7], np.int64),
                 names=[b"a", "b"], floats=[0.5, -0.25])
    ours = build_example(feats)
    assert ours == jtfrecord.build_example(feats)
    assert jtfrecord.parse_example(ours).keys() == parse_example(ours).keys()


def test_int64_sign_fold_and_round_trip():
    vals = np.array([-1, -(2**63), 2**62, 0, 7], np.int64)
    out = parse_example(build_example({"x": vals}))
    np.testing.assert_array_equal(out["x"], vals)
    assert out["x"].dtype == np.int64


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_written_by_either_package_read_by_the_other(tmp_path, writer):
    records = [build_example(example(i, n=300)) for i in range(3)] + [b"", b"tail" * 50]
    path = str(tmp_path / "x.tfrecord")
    (write_tfrecord if writer == "port" else jtfrecord.write_tfrecord)(path, records)
    assert list(read_tfrecord(path, verify_crc=True)) == records
    assert list(jtfrecord.read_tfrecord(path, verify_crc=True)) == records
    other = str(tmp_path / "y.tfrecord")
    (jtfrecord.write_tfrecord if writer == "port" else write_tfrecord)(other, records)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def test_read_tfrecord_detects_corruption(tmp_path):
    path = str(tmp_path / "c.tfrecord")
    write_tfrecord(path, [b"hello world"])
    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        list(read_tfrecord(path, verify_crc=True))


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("use_native", [False, True])
def test_nsynth_batches_equal_jax_for_the_same_seed(nsynth_file, training, use_native, request):
    """Random crops and the shuffle buffer (training) or the center crop
    (eval) from np.random.RandomState(seed) in both packages. The native
    reader runs one thread: with more, workers repeating the file
    interleave records in no fixed order."""
    if use_native:
        request.getfixturevalue("lib")
    kw = dict(is_training=training, seed=3, use_native=use_native, reader_threads=1)
    ours = NSynthDataset(nsynth_file, **kw).get_wavenet_batch(4, length=2048, shuffle_buffer=6)
    theirs = JNSynthDataset(nsynth_file, **kw).get_wavenet_batch(4, length=2048,
                                                                  shuffle_buffer=6)
    for _ in range(5 if training else 3):
        a, b = next(ours), next(theirs)
        np.testing.assert_array_equal(a["wav"], b["wav"])
        np.testing.assert_array_equal(a["pitch"], b["pitch"])
        assert a["key"] == b["key"]
        assert a["wav"].shape == (4, 2048) and a["wav"].dtype == np.float32


def test_nsynth_reports_its_reader(nsynth_file, lib):
    for use_native, want in ((True, "native"), (False, "python")):
        ds = NSynthDataset(nsynth_file, is_training=False, use_native=use_native)
        next(ds.get_wavenet_batch(2, length=1024))
        assert ds.reader_used == want


def test_nsynth_short_audio_padded(tmp_path):
    short = np.random.RandomState(0).randn(3000).astype(np.float32) * 0.1
    rec = build_example(dict(example(0, n=10), audio=short))
    path = str(tmp_path / "short.tfrecord")
    write_tfrecord(path, [rec] * 4)
    train = next(NSynthDataset(path, is_training=True, use_native=False)
                 .get_wavenet_batch(2, length=6144, shuffle_buffer=0))
    assert train["wav"].shape == (2, 6144)
    np.testing.assert_array_equal(train["wav"][0][:3000], short)
    assert np.all(train["wav"][0][3000:] == 0.0)
    ev = next(NSynthDataset(path, is_training=False, use_native=False)
              .get_wavenet_batch(2, length=2000))
    np.testing.assert_array_equal(ev["wav"][0], short[500:2500])  # centered on 3000


def test_native_midstream_error_propagates(tmp_path, monkeypatch):
    """A native-reader failure after records were yielded raises; no silent
    restart from record 0 through the Python reader."""

    class Boom:
        def __init__(self, *a, **k):
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.n >= 2:
                raise IOError("simulated mid-stream failure")
            self.n += 1
            return b"rec%d" % self.n

        def close(self):
            pass

    monkeypatch.setattr(native, "NativeTFRecordReader", Boom)
    monkeypatch.setattr(native, "native_available", lambda: True)
    it = NSynthDataset(str(tmp_path / "x.tfrecord"), use_native=True)._raw_records(False)
    assert next(it) == b"rec1" and next(it) == b"rec2"
    with pytest.raises(IOError, match="mid-stream"):
        next(it)


def test_baseline_batch_raises_naming_m9(nsynth_file):
    """The call raised NotImplementedError naming M9 until the spectrogram
    chain was ported; now it yields the baseline AE's batches (their parity
    with JAX: tests/test_torch_specgram.py)."""
    from audio_style_transfer_tpu_torch.models.baseline_ae import BaselineHParams

    batch = next(NSynthDataset(nsynth_file, is_training=False).get_baseline_batch(
        BaselineHParams(batch_size=2), device="cpu"))
    assert batch["spectrogram"].shape == (2, 512, 256, 1)
    assert np.isfinite(batch["spectrogram"]).all()


def _records(n=20, payload=1000, seed=0):
    rng = np.random.RandomState(seed)
    return [build_example({"pitch": np.array([i], np.int64),
                           "audio": rng.rand(payload).astype(np.float32)}) for i in range(n)]


def test_native_library_builds_into_build_not_csrc(lib):
    path = native.library_path()
    assert path.exists() and path.parent.name == "tfrecord" and path.parent.parent.name == "build"
    assert not str(path).startswith(str(native.SOURCE.parent))


def test_native_reads_all_records_as_python_does(tmp_path, lib):
    path = str(tmp_path / "t.tfrecord")
    recs = _records()
    write_tfrecord(path, recs)
    got = list(native.NativeTFRecordReader(path, num_threads=2, verify_crc=True))
    assert got == list(read_tfrecord(path)) == recs  # one file: one worker, file order


def test_native_multi_file(tmp_path, lib):
    p1, p2 = str(tmp_path / "a.tfrecord"), str(tmp_path / "b.tfrecord")
    r1, r2 = _records(5, seed=1), _records(7, seed=2)
    write_tfrecord(p1, r1)
    write_tfrecord(p2, r2)
    got = list(native.NativeTFRecordReader([p1, p2], num_threads=2))
    assert sorted(got) == sorted(r1 + r2)


def test_native_empty_record_mid_file(tmp_path, lib):
    path = str(tmp_path / "e.tfrecord")
    write_tfrecord(path, [b"a", b"", b"cc"])
    assert list(native.NativeTFRecordReader(path)) == [b"a", b"", b"cc"] == list(
        read_tfrecord(path))


def test_native_record_larger_than_the_buffer(tmp_path, lib):
    path = str(tmp_path / "big.tfrecord")
    big = build_example({"audio": np.zeros(2_000_000, np.float32)})  # about 8 MB
    write_tfrecord(path, [b"x", big, b"y"])
    assert list(native.NativeTFRecordReader(path)) == [b"x", big, b"y"]


def test_native_crc_matches_python(lib):
    for data in [b"", b"123456789", b"\x00" * 32, os.urandom(257)]:
        buf = (ctypes.c_uint8 * max(len(data), 1))(*data)
        assert lib.tfrec_masked_crc32c(buf, len(data)) == masked_crc32c(data)


def test_native_error_on_a_truncated_file(tmp_path, lib):
    path = str(tmp_path / "t.tfrecord")
    write_tfrecord(path, [b"abc", b"defgh"])
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-3])
    reader = native.NativeTFRecordReader(path)
    assert next(reader) == b"abc"
    with pytest.raises(IOError, match="native TFRecord reader error"):
        next(reader)
