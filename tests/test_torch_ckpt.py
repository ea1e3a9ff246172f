"""The port's TF1 checkpoint path against the JAX package's and TensorFlow's.

A full-size TF V2 bundle written by TensorFlow's own ``Saver`` (reference
variable names: ``<layer>/W`` as [1, F, Cin, Cout], ``<layer>/biases``),
with the extra variables a training checkpoint carries and enough long
names that the index spans several blocks: the port's reader equals JAX's
and TF's on every entry, and the port's ``convert_tf1_checkpoint`` equals
JAX's bit for bit. The port's bundle writer (tools/tf1_bundle.py) is read
back by all three readers. Skipped where TensorFlow is absent.
"""

import contextlib
import io
import os
import re
import wave

import ml_dtypes
import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from audio_style_transfer_tpu.ckpt import bundle_reader as jbr  # noqa: E402
from audio_style_transfer_tpu.ckpt import convert as jconvert  # noqa: E402
from audio_style_transfer_tpu_torch.ckpt import bundle_reader, convert  # noqa: E402
from audio_style_transfer_tpu_torch.models import wavenet_ae as tw  # noqa: E402
from audio_style_transfer_tpu_torch.tools.tf1_bundle import (  # noqa: E402
    BLOCK_SIZE,
    nsynth_variables,
    write_bundle,
)

PREFIX = "model.ckpt-200000"
# Non-model variables a training checkpoint also carries; the converter skips them.
EXTRA_LAYERS = ("ae_startconv", "ae_res_1")
N_LONG = 300  # names of 900 characters: about 280 KB of keys, beyond one 256 KiB block


def _extras(rng) -> dict:
    values = {"global_step": np.array(200000, np.int64),
              "bf16_var": rng.randn(3, 5).astype(ml_dtypes.bfloat16)}
    for name in EXTRA_LAYERS:
        f, cin, cout = tw._conv_shapes(tw.WaveNetAEConfig())[name]
        for slot in ("Adam", "ExponentialMovingAverage"):
            values[f"{name}/W/{slot}"] = rng.randn(1, f, cin, cout).astype(np.float32)
    for i in range(N_LONG):
        values[f"long_{i:03d}/" + "x" * 900] = rng.randn(i % 3 + 1).astype(np.float32)
    return values


@pytest.fixture(scope="module")
def tf1_bundle(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / PREFIX)
    rng = np.random.RandomState(0)
    values = {}
    for name, (f, cin, cout) in tw._conv_shapes(tw.WaveNetAEConfig()).items():
        values[f"{name}/W"] = rng.randn(1, f, cin, cout).astype(np.float32)
        values[f"{name}/biases"] = rng.randn(cout).astype(np.float32)
    values.update(_extras(rng))
    tf1 = tf.compat.v1
    graph = tf1.Graph()
    with graph.as_default():
        for name, value in values.items():
            tf1.get_variable(name, initializer=tf.constant(value))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, path, write_meta_graph=False)
    return path, values


def _data_blocks(prefix: str) -> int:
    with open(prefix + ".index", "rb") as f:
        raw = f.read()
    footer = raw[-48:]
    _, pos = bundle_reader._read_block_handle(footer, 0)
    index, _ = bundle_reader._read_block_handle(footer, pos)
    return sum(1 for _ in bundle_reader._read_block(raw, index).items())


def test_reader_matches_jax_and_tf_on_every_entry(tf1_bundle):
    path, values = tf1_bundle
    assert _data_blocks(path) >= 2
    mine = bundle_reader.BundleReader(path)
    jax_reader = jbr.BundleReader(path)
    tf_reader = tf.train.load_checkpoint(path)
    tf_shapes = tf_reader.get_variable_to_shape_map()
    shapes = mine.get_variable_to_shape_map()
    assert set(shapes) == set(tf_shapes) == set(jax_reader.get_variable_to_shape_map())
    assert set(shapes) == set(values)
    for name, shape in shapes.items():
        assert shape == jax_reader.get_variable_to_shape_map()[name] == tuple(tf_shapes[name])
        got, want = mine.get_tensor(name), jax_reader.get_tensor(name)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes() == tf_reader.get_tensor(name).tobytes(), name
    step = mine.get_tensor("global_step")
    assert step.dtype == np.int64 and step.shape == () and int(step) == 200000
    bf = mine.get_tensor("bf16_var")  # raw bits, as JAX's reader gives them
    assert bf.dtype == np.uint16
    np.testing.assert_array_equal(bf, values["bf16_var"].view(np.uint16))


def test_convert_matches_jax_bit_for_bit(tf1_bundle):
    path, values = tf1_bundle
    got = convert.convert_tf1_checkpoint(path)
    want = jconvert.convert_tf1_checkpoint(path)
    shapes = tw._conv_shapes(tw.WaveNetAEConfig())
    assert got.keys() == want.keys() == shapes.keys()
    for name, (f, cin, cout) in shapes.items():
        assert got[name].keys() == {"w", "b"}
        for k in ("w", "b"):
            g = got[name][k]
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            assert g.numpy().tobytes() == np.asarray(want[name][k]).tobytes(), (name, k)
            assert tuple(g.shape) == ((f, cin, cout) if k == "w" else (cout,))
        np.testing.assert_array_equal(got[name]["w"].numpy(), values[f"{name}/W"][0])
        np.testing.assert_array_equal(got[name]["b"].numpy(), values[f"{name}/biases"])


def test_strict_raises_on_missing_layers_and_non_strict_keeps_the_rest(tmp_path):
    path = str(tmp_path / "part.ckpt")
    rng = np.random.RandomState(1)
    shapes = tw._conv_shapes(tw.WaveNetAEConfig())
    present = ("ae_startconv", "ae_res_3", "dilatedconv_7")
    values = {}
    for name in present:
        f, cin, cout = shapes[name]
        values[f"{name}/W"] = rng.randn(1, f, cin, cout).astype(np.float32)
        values[f"{name}/biases"] = rng.randn(cout).astype(np.float32)
    values["global_step"] = np.array(5, np.int64)
    write_bundle(path, values)
    with pytest.raises(KeyError, match="missing variables for layers"):
        convert.convert_tf1_checkpoint(path)
    got = convert.convert_tf1_checkpoint(path, strict=False)
    want = jconvert.convert_tf1_checkpoint(path, strict=False)
    assert set(got) == set(want) == set(present)
    for name in present:
        np.testing.assert_array_equal(got[name]["w"].numpy(), values[f"{name}/W"][0])
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(want[name]["b"]))


def _link_bundle(src: str, dst_dir) -> str:
    """The bundle ``src`` under ``dst_dir`` (symlinks), so a cache written
    beside it stays out of the module's fixture."""
    dst = str(dst_dir / PREFIX)
    for suffix in (".index", ".data-00000-of-00001"):
        os.symlink(src + suffix, dst + suffix)
    return dst


def test_load_pretrained_converts_caches_and_reloads(tf1_bundle, tmp_path, monkeypatch):
    path = _link_bundle(tf1_bundle[0], tmp_path)
    first = convert.load_pretrained(path)
    assert os.path.exists(path + ".npz")
    want = convert.convert_tf1_checkpoint(path)

    def no_conversion(*args, **kwargs):
        raise AssertionError("the second load converted the bundle again")

    monkeypatch.setattr(convert, "convert_tf1_checkpoint", no_conversion)
    second = convert.load_pretrained(path)
    assert first.keys() == second.keys() == want.keys()
    for name in want:
        for k in ("w", "b"):
            assert torch.equal(first[name][k], want[name][k])
            assert torch.equal(second[name][k], want[name][k])
    # The JAX package reads the port's cache as its own.
    jax_w = np.asarray(jconvert.load_params(path + ".npz")["ae_res_1"]["w"])
    assert jax_w.tobytes() == want["ae_res_1"]["w"].numpy().tobytes()


def test_load_pretrained_skips_the_cache_where_it_cannot_write(tf1_bundle, tmp_path, monkeypatch):
    path = _link_bundle(tf1_bundle[0], tmp_path)

    def read_only(*args, **kwargs):
        raise PermissionError("read-only checkpoint directory")

    monkeypatch.setattr(convert, "save_params", read_only)
    got = convert.load_pretrained(path)
    assert not os.path.exists(path + ".npz")
    assert len(got) == len(tw._conv_shapes(tw.WaveNetAEConfig()))


def test_missing_index_raises_file_not_found(tmp_path):
    prefix = str(tmp_path / PREFIX)
    with pytest.raises(FileNotFoundError, match=re.escape(prefix + ".index")):
        bundle_reader.BundleReader(prefix)
    with pytest.raises(FileNotFoundError):
        convert.convert_tf1_checkpoint(prefix)
    with pytest.raises(FileNotFoundError):
        convert.load_pretrained(prefix)


@pytest.mark.parametrize("block_size", [BLOCK_SIZE, 64])
def test_writer_round_trips_through_tf_jax_and_port(tmp_path, block_size):
    """Small tensors of every kind the checkpoints hold, the crc on; at 64
    bytes a block the index has many blocks, each a few keys."""
    rng = np.random.RandomState(2)
    values = _extras(rng)
    for i in range(N_LONG):  # the long names belong to the Saver fixture
        del values[f"long_{i:03d}/" + "x" * 900]
    values.update({
        "ae_startconv/W": rng.randn(1, 32, 1, 16).astype(np.float32),
        "ae_startconv/biases": rng.randn(16).astype(np.float32),
        "f64": rng.randn(2, 3).astype(np.float64),
        "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
        "flags": np.array([True, False, True]),
        "bytes/u8": np.arange(7, dtype=np.uint8),
        "scalar_f32": np.array(1.5, np.float32),
    })
    path = str(tmp_path / "w.ckpt")
    write_bundle(path, values, block_size=block_size)
    assert (_data_blocks(path) > 4) == (block_size == 64)
    tf_reader = tf.train.load_checkpoint(path)
    tf_shapes = tf_reader.get_variable_to_shape_map()
    mine, jax_reader = bundle_reader.BundleReader(path), jbr.BundleReader(path)
    assert set(tf_shapes) == set(mine.get_variable_to_shape_map()) == set(values)
    for name, v in values.items():
        assert tuple(tf_shapes[name]) == v.shape
        assert tf_reader.get_tensor(name).tobytes() == v.tobytes(), name
        for reader in (mine, jax_reader):
            got = reader.get_tensor(name)
            assert got.shape == v.shape and got.tobytes() == v.tobytes(), name
    assert tf_reader.get_variable_to_dtype_map()["bf16_var"] == tf.bfloat16


def _transfer_losses(argv) -> list[float]:
    from audio_style_transfer_tpu_torch.cli.transfer import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    rows = re.findall(r"Ep \d+/\d+ - evals \d+ - loss (\S+)", buf.getvalue())
    assert rows, buf.getvalue()
    return [float(r) for r in rows]


def test_transfer_cli_from_a_bundle_equals_random_init(tmp_path):
    """The transfer CLI with ``--ckpt_path`` on a bundle of ``init_params(0)``
    converts it on first use and runs the same losses as ``--random_init``."""
    prefix = str(tmp_path / PREFIX)
    write_bundle(prefix, nsynth_variables(tw.init_params(0)), crc=False)
    for name, f in (("tone", 220.0), ("square", 330.0)):
        x = 0.5 * np.sin(2 * np.pi * f * np.arange(9600) / 16000.0)
        with wave.open(str(tmp_path / f"{name}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((x * 32767.0).astype("<i2").tobytes())
    common = ["tone", "square", "--dir", str(tmp_path), "--outdir", str(tmp_path / "out"),
              "--logdir", str(tmp_path / "log"), "--device", "cpu", "--no_artifacts",
              "--stack", "0", "--batch_size", "4096", "--epochs", "1", "--maxiter", "2",
              "--start", "0.1"]
    from_bundle = _transfer_losses([*common, "--ckpt_path", prefix])
    assert os.path.exists(prefix + ".npz")
    assert from_bundle == _transfer_losses([*common, "--random_init"])
    assert all(np.isfinite(from_bundle))
