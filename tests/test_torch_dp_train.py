"""Data-parallel training in the port (``Trainer(mesh=)``, parallel/mesh.py)
against the JAX package's ``Trainer(make_mesh(2))`` and the port's single
process, on the CPU in float32.

The port runs as 2 processes over gloo (``parallel.mesh.spawn``, a
``file://`` store), every case in one process group
(tests/torch_dist_workers.py::dp_worker); JAX runs in this process on 2 of
the 8 virtual CPU devices of tests/conftest.py. Geometry and oracle are
those of ``dp_train`` in __graft_entry__.py::dryrun_multichip: the TINY
model, a global batch of 4 x 256, JAX's PRNGKey(7) weights carried across.

Tolerances (the dry run's): losses rtol 1e-4; weights rtol 1e-4, atol 1e-6.
Across the two ranks, and between a checkpoint and its restore: bit for bit.
"""

import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from torch.multiprocessing import ProcessRaisedException
from torch_helpers import jax_params_np, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from audio_style_transfer_tpu.train import TrainConfig as JTrainConfig
from audio_style_transfer_tpu.train import Trainer as JTrainer
from audio_style_transfer_tpu_torch.data import NSynthDataset, build_example, write_tfrecord
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.parallel.mesh import spawn
from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer

RTOL, ATOL = 1e-4, 1e-6
# Each collective and the whole spawned run are bounded: a hang fails the test.
TIMEOUT_S, DEADLINE_S = 60.0, 150.0


def _wav(seed, rows):
    return np.random.RandomState(seed).uniform(-0.5, 0.5, (rows, 256)).astype(np.float32)


def _tree(flat: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _flat(tree) -> dict:
    return {f"{layer}/{k}": np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for layer, e in tree.items() for k, v in e.items()}


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.fixture(scope="module")
def pnp():
    return jax_params_np(7, **workers.DRY)


@pytest.fixture(scope="module")
def inputs(pnp):
    return dict(wav0=_wav(0, 4), wav1=_wav(1, 4), wav2=_wav(2, 4), wav_mb=_wav(3, 8),
                **{f"{layer}/{k}": v for layer, e in pnp.items() for k, v in e.items()})


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(4)
    write_tfrecord(str(tmp / "train.tfrecord"), [build_example({
        "note_str": f"n{i}".encode(), "pitch": np.array([60 + i], np.int64),
        "audio": rng.uniform(-0.5, 0.5, 512).astype(np.float32)}) for i in range(6)])
    return tmp


@pytest.fixture(scope="module")
def ranks(inputs, records):
    """The two ranks' outputs of dp_worker (one spawned group)."""
    np.savez(records / "in.npz", **inputs)
    spawn(workers.dp_worker, 2, args=(str(records),), device="cpu", timeout_s=TIMEOUT_S,
          deadline_s=DEADLINE_S)
    return [dict(np.load(records / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def jax_runs(pnp, inputs):
    """JAX's Trainer on a 2-device mesh: the losses of 3 steps, the params
    after steps 1 and 3; one step with microbatch=2 on 8 rows."""
    cfg = JCfg(**workers.DRY)
    params = jax.tree.map(jnp.asarray, pnp)
    tr = JTrainer(JTrainConfig(**workers.DP_CFG), cfg, jmake_mesh(2))
    st, out = tr.init_state(params), {}
    for i in range(3):
        st, loss = tr.step(st, inputs[f"wav{i}"])
        out[f"loss{i}"] = float(loss)
        if i == 0:
            out["step1"] = _flat(st["params"])
    out["step3"] = _flat(st["params"])
    mb = JTrainer(JTrainConfig(**dict(workers.DP_CFG, total_batch_size=8, microbatch=2)),
                  cfg, jmake_mesh(2))
    st, loss = mb.step(mb.init_state(params), inputs["wav_mb"])
    out["mb_loss"], out["mb"] = float(loss), _flat(st["params"])
    return out


def _single(pnp, **cfg) -> Trainer:
    return Trainer(TrainConfig(**dict(workers.DP_CFG, **cfg)), TCfg(**workers.DRY), device="cpu")


def test_dp_step_matches_the_jax_mesh_and_the_single_process(ranks, jax_runs, pnp, inputs):
    """One step on the global batch: the mean loss and the updated weights
    of every layer, against JAX's 2-device step and the port's one process
    on the whole batch."""
    tr = _single(pnp)
    st, loss = tr.step(tr.init_state(torch_params(pnp)), inputs["wav0"])
    for r in ranks:
        np.testing.assert_allclose(r["loss0"], jax_runs["loss0"], rtol=RTOL)
        np.testing.assert_allclose(r["loss0"], float(loss), rtol=RTOL)
        _close(_tree(r, "step1/"), jax_runs["step1"])
        _close(_tree(r, "step1/"), _flat(st["params"]))


def test_dp_three_steps_match_jax_and_stay_equal_on_both_ranks(ranks, jax_runs):
    """After 3 steps the losses and weights agree with JAX's; params, EMA and
    Adam's moments are bit for bit the same on both ranks."""
    for i in (1, 2):
        np.testing.assert_allclose(ranks[0][f"loss{i}"], jax_runs[f"loss{i}"], rtol=RTOL)
    _close(_tree(ranks[0], "step3/"), jax_runs["step3"])
    shared = [k for k in ranks[0] if k.split("/")[0] in ("step1", "step3", "ema3", "m3", "v3")]
    assert len(shared) > 4 * len(jax_runs["step3"])
    for k in shared + ["loss0", "loss1", "loss2"]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_dp_microbatches_match_jax(ranks, jax_runs):
    """microbatch=2 on a global batch of 8: each rank splits its own 4 rows
    in two, as JAX's step does inside shard_map."""
    for r in ranks:
        np.testing.assert_allclose(r["mb_loss"], jax_runs["mb_loss"], rtol=RTOL)
        _close(_tree(r, "mb/"), jax_runs["mb"])


def test_dp_fit_checkpoints_on_rank_0_and_restores_on_every_rank(ranks, records):
    """fit (3 steps, groups of 2, a checkpoint every 2) then save: rank 0
    alone wrote ckpt-2 and ckpt-3 and logged; restore gives both ranks the
    saved params, EMA, Adam's moments and step, bit for bit."""
    assert ranks[0]["fit_writes"].tolist() == ["ckpt-2", "ckpt-3"]
    assert ranks[1]["fit_writes"].tolist() == []
    assert int(ranks[0]["fit_logged"]) > 0 and int(ranks[1]["fit_logged"]) == 0
    assert sorted(os.listdir(records / "fit")) == ["ckpt-2", "ckpt-3"]
    for r in ranks:
        assert int(r["restored_step"]) == 3
        for k, v in _tree(r, "fit/").items():
            np.testing.assert_array_equal(r["restored/" + k], v, err_msg=k)
        assert all(bool(v) for k, v in r.items() if k.startswith("restored_m_equal/"))
    for k in ranks[0]:
        if k.startswith(("fit/", "restored/", "restored_ema/")):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_dp_fit_equals_the_single_process_fit(ranks, records, pnp):
    """Every rank reads the same seeded stream and trains on its rows: the
    result is the one-process fit on the same batches."""
    tr = _single(pnp, logdir=str(records / "single"), steps_per_call=2)
    ds = NSynthDataset(str(records / "train.tfrecord"), is_training=True, use_native=False)
    st = tr.fit(tr.init_state(torch_params(pnp)), ds.get_wavenet_batch(4, length=256),
                num_steps=3, log=lambda *a: None)
    _close(_tree(ranks[0], "fit/"), _flat(st["params"]))


@pytest.mark.parametrize("key,match", [
    ("err_total_batch", "total_batch_size 3 does not split over the 2 ranks"),
    ("err_batch_rows", "a batch of 3 does not split over the 2 ranks"),
    ("err_n_devices", r"make_mesh\(3\): the world has 2 rank"),
])
def test_dp_refuses_what_does_not_split(ranks, key, match):
    for r in ranks:
        assert re.search(match, str(r[key])), r[key]


def test_data_parallel_specs_and_the_hybrid_mesh(ranks):
    """replicate broadcasts rank 0's tensors; shard takes contiguous row
    blocks in rank order (along any dim); one node makes a 1 x 2 mesh."""
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["replicated"], np.ones((2, 3), np.float32))
        np.testing.assert_array_equal(r["shard_rows"], np.arange(12).reshape(6, 2)[3 * rank:][:3])
        np.testing.assert_array_equal(r["shard_dim1"],
                                      np.arange(12).reshape(2, 6)[:, 3 * rank:3 * rank + 3])
        assert r["hybrid_shape"].tolist() == [1, 2]
        assert r["hybrid_names"].tolist() == ["slice", "data"]


@pytest.mark.parametrize("worker,deadline_s,error,match", [
    ("sleeper", 5.0, TimeoutError, "still running after 5 s"),
    ("raiser", 60.0, ProcessRaisedException, "rank 1 fails"),
])
def test_spawn_ends_hung_and_failed_workers(worker, deadline_s, error, match):
    """Workers that never end are terminated at the deadline; a worker that
    raises fails the call at once, and its peer is terminated."""
    t0 = time.monotonic()
    with pytest.raises(error, match=match):
        spawn(getattr(workers, worker), 2, device="cpu", timeout_s=30.0, deadline_s=deadline_s)
    assert time.monotonic() - t0 < 30.0
