"""Clip-sharded transfer in the port (``optimize_batch(mesh=)``,
``transfer_longform(mesh=)``) against the JAX package's mesh forms and the
port's ``mesh=None``, on the CPU in float32.

The port runs as 2 processes over gloo (``parallel.mesh.spawn``), every case
in one process group (tests/torch_dist_workers.py::clip_worker); JAX runs in
this process on 2 of the 8 virtual CPU devices of tests/conftest.py, with
its XLA encoder. Geometry and oracles are those of ``clip_sharded``,
``fused_batched`` and ``fused_batched_grad`` in
__graft_entry__.py::dryrun_multichip (the TINY encoder, JAX's PRNGKey(1)
weights carried across, 4 clips of 4096 samples, one epoch of 2
iterations), and of tests/test_longform.py's sharded long-form test (8
windows of 4096; here also 5 windows in groups of 4, the trailing group
padded).

Tolerances:
- clip-sharded results against JAX's: rtol 1e-3, atol 1e-3 x max (the dry
  run's); against the port's ``mesh=None``: bit for bit (the same code on
  the same CPU, each clip on its own);
- each clip's loss against its neighbour's targets: rtol 5e-4; its waveform
  gradient at T=512: rtol 1e-3, atol 1e-4 x max (the dry run's);
- long-form audio: rtol 2e-4, atol 1e-4 (tests/test_longform.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_dist_workers as workers
from torch_helpers import jax_params_np, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import longform as jlong
from audio_style_transfer_tpu.transfer.losses import transfer_embeds as jembeds
from audio_style_transfer_tpu.transfer.losses import transfer_loss as jloss
from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig as TCfg
from audio_style_transfer_tpu_torch.parallel.mesh import spawn
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import longform as tlong

K = 4  # clips
TIMEOUT_S, DEADLINE_S = 60.0, 150.0
JAX_SPEC = {k: v for k, v in workers.CLIP_SPEC.items() if k != "device"}
LF = dict(lf8=(8, 8), lf5=(5, 2))  # case: (windows, windows_per_device)


@pytest.fixture(scope="module")
def pnp():
    return jax_params_np(1, **workers.DRY)


@pytest.fixture(scope="module")
def jeng(pnp):
    return jengine.StyleTransfer(jengine.TransferSpec(**JAX_SPEC),
                                 jax.tree.map(jnp.asarray, pnp), model_cfg=JCfg(**workers.DRY))


@pytest.fixture(scope="module")
def inputs(pnp, jeng):
    """The clips' targets (JAX's, fed to both), the neighbour-target loss
    and gradient inputs, the long-form clips."""
    rng = np.random.RandomState(4)
    auds = rng.uniform(-0.5, 0.5, (K, 4096)).astype(np.float32)
    phi_cs = np.stack([jeng.get_embeds(a) for a in auds])
    phi_ss = np.stack([jeng.get_embeds(a, is_content=False) for a in auds])
    xs = np.roll(mu_law_numpy(auds).astype(np.float32)[:, None, :], 1, axis=0)
    auds_g = rng.uniform(-0.5, 0.5, (K, 512)).astype(np.float32)
    xq_g = mu_law_numpy(auds_g).astype(np.float32)[:, None, :]
    embeds = [jembeds(jeng.params, jnp.asarray(x), jeng.cfg, jeng.loss_spec) for x in xq_g]
    lf = np.random.RandomState(2)
    return dict(phi_cs=phi_cs, phi_ss=phi_ss, xs=xs, pcs=phi_cs, pss=phi_ss,
                xs_g=np.roll(xq_g, 1, axis=0),
                pcs_g=np.stack([np.asarray(c) for c, _ in embeds]),
                pss_g=np.stack([np.asarray(s) for _, s in embeds]),
                content=lf.uniform(-0.5, 0.5, 4096 * 8).astype(np.float32),
                style=lf.uniform(-0.5, 0.5, 4096 * 2).astype(np.float32),
                **{f"{layer}/{k}": v for layer, e in pnp.items() for k, v in e.items()})


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The two ranks' outputs of clip_worker (one spawned group)."""
    tmp = tmp_path_factory.mktemp("clips")
    np.savez(tmp / "in.npz", **inputs)
    spawn(workers.clip_worker, 2, args=(str(tmp),), device="cpu", timeout_s=TIMEOUT_S,
          deadline_s=DEADLINE_S)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def teng(pnp):
    return tengine.StyleTransfer(tengine.TransferSpec(**workers.CLIP_SPEC), torch_params(pnp),
                                 model_cfg=TCfg(**workers.DRY))


def _lf_engines(pnp, jeng, teng):
    spec = dict(maxiter=workers.LONGFORM_MAXITER)
    return (jengine.StyleTransfer(jengine.TransferSpec(**dict(JAX_SPEC, **spec)), jeng.params,
                                  model_cfg=JCfg(**workers.DRY)),
            tengine.StyleTransfer(tengine.TransferSpec(**dict(workers.CLIP_SPEC, **spec)),
                                  torch_params(pnp), model_cfg=TCfg(**workers.DRY)))


@pytest.fixture(scope="module")
def batches(inputs, jeng, teng):
    """optimize_batch of the 4 clips: JAX's on a 2-device mesh, the port's
    with mesh=None."""
    return (jeng.optimize_batch(inputs["phi_cs"], inputs["phi_ss"], epochs=1,
                                mesh=jmake_mesh(2, axis_name="clips")),
            teng.optimize_batch(inputs["phi_cs"], inputs["phi_ss"], epochs=1))


@pytest.mark.parametrize("key", ["x", "snapshots", "metrics"])
def test_clip_sharded_matches_jax_and_mesh_none(ranks, batches, key):
    """optimize_batch over 2 ranks: every rank returns all 4 clips, equal to
    the port's mesh=None bit for bit and to JAX's 2-device mesh at the dry
    run's tolerance."""
    want, local = batches
    for r in ranks:
        got = r[f"batch/{key}"]
        assert got.shape == np.asarray(want[key]).shape
        assert r["batch/evals"].tolist() == np.asarray(want["evals"]).tolist()
        assert r["batch/epochs_done"].tolist() == [1] * K
        scale = float(np.max(np.abs(want[key])))
        np.testing.assert_allclose(got, want[key], rtol=1e-3, atol=1e-3 * scale)
        d = float(np.max(np.abs(got - local[key])))
        assert d == 0.0, f"port sharded against mesh=None: max|d| {d}"


def test_sharded_losses_against_neighbour_targets_match_jax(ranks, inputs, jeng):
    """fused_batched: each rank's clips through the port's chained trunk
    (its plain K1/K2 versions here), gathered, against JAX's XLA loss per clip."""
    want = [float(jloss(jeng.params, jnp.asarray(inputs["xs"][i]), jnp.asarray(inputs["pcs"][i]),
                        jnp.asarray(inputs["pss"][i]), jeng.cfg, jeng.loss_spec)[0])
            for i in range(K)]
    assert np.std(want) > 0
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want, rtol=5e-4)


def test_sharded_gradients_against_neighbour_targets_match_jax(ranks, inputs, jeng):
    """fused_batched_grad: each clip's waveform gradient at T=512."""
    def one(x, pc, ps):
        return jloss(jeng.params, x, pc, ps, jeng.cfg, jeng.loss_spec)[0]

    want = np.stack([np.asarray(jax.grad(one)(*(jnp.asarray(inputs[k][i])
                                                 for k in ("xs_g", "pcs_g", "pss_g"))))
                     for i in range(K)])
    for r in ranks:
        assert r["grads"].shape == want.shape
        np.testing.assert_allclose(r["grads"], want, rtol=1e-3,
                                   atol=1e-4 * float(np.max(np.abs(want))))


@pytest.mark.parametrize("case", sorted(LF))
def test_sharded_longform_matches_jax_and_mesh_none(ranks, inputs, pnp, jeng, teng, case):
    """transfer_longform over 2 ranks (lf5: groups of 4 windows, the second
    padded from 1 to 4 by repeats and trimmed) against JAX's on a 2-device
    mesh and the port's mesh=None."""
    wins, wpd = LF[case]
    jlf, tlf = _lf_engines(pnp, jeng, teng)
    content = inputs["content"][: wins * 4096]
    want = jlong.transfer_longform(jlf, content, inputs["style"], epochs=1, crossfade=0,
                                   mesh=jmake_mesh(2), windows_per_device=wpd)
    local = tlong.transfer_longform(tlf, content, inputs["style"], epochs=1, crossfade=0)
    for r in ranks:
        got = r[f"{case}/audio"]
        assert got.shape == want.audio.shape == (wins * 4096,)
        assert r[f"{case}/evals"].tolist() == np.asarray(want.per_window["evals"]).tolist()
        np.testing.assert_allclose(got, want.audio, rtol=2e-4, atol=1e-4)
        np.testing.assert_allclose(got, local.audio, rtol=2e-4, atol=1e-4)


def test_clip_count_must_split_over_the_ranks(ranks):
    for r in ranks:
        assert "3 clips do not split over the 2 ranks" in str(r["err_clips"])
