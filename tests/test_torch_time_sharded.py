"""Time-sharded exact transfer and the tensor-parallel decoder in the port
(``parallel/halo.py``'s sharded half, ``transfer_exact(mesh=)``,
``parallel/tensor.py``) against the JAX package's mesh forms and the port's
unsharded functions, on the CPU in float32.

The port runs as 4 processes over gloo (``parallel.mesh.spawn``), every case
in one process group (tests/torch_dist_workers.py::time_sharded_worker): with
4 ranks there is a middle rank, whose chunk runs the trunk unwindowed. JAX
runs in this process on 4 of the 8 virtual CPU devices of tests/conftest.py.
Geometry: tests/test_halo.py's SMALL encoder and 2048-sample clips (chunks
of 512, one 512-sample halo); tests/test_tensor_parallel.py's TINY decoder
(2 x 128 samples); ``transfer_exact`` at dryrun_multichip's toy geometry
(__graft_entry__.py) on an 8192-sample clip, which all three forms trim
alike (4 x 512, 4096).

Tolerances (__graft_entry__.py::dryrun_multichip, tests/test_halo.py,
tests/test_tensor_parallel.py, tests/test_torch_exact.py):
- trunk taps: rtol 1e-4, atol 1e-5; STFT L1: value rtol 1e-6, gradient
  rtol 1e-5, atol 1e-8;
- sharded loss: rtol 2e-4; its gradient rtol 1e-4, atol 1e-5 x max; embeds
  as the taps;
- ``transfer_exact``: losses rtol 1e-3 with equal evaluation counts (the
  ill-conditioned 1e-6 start, ROADMAP.md queue 3 item 3); the gathered audio
  equal on every rank;
- TP logits rtol 1e-5, atol 1e-5; NLL rtol 1e-6; parameter gradients rtol
  2e-4, atol 1e-6, equal on every rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_workers as workers
from jax import shard_map
from jax.sharding import PartitionSpec as P
from torch_helpers import jax_params_np, torch_params

from audio_style_transfer_tpu.models.wavenet_ae import WaveNetAEConfig as JCfg
from audio_style_transfer_tpu.models.wavenet_ae import decode_logits as jdecode
from audio_style_transfer_tpu.models.wavenet_ae import encoder_extracts as jextracts
from audio_style_transfer_tpu.models.wavenet_ae import nll_loss as jnll
from audio_style_transfer_tpu.parallel import make_mesh as jmake_mesh
from audio_style_transfer_tpu.parallel import halo as jhalo
from audio_style_transfer_tpu.parallel import tensor as jtensor
from audio_style_transfer_tpu.signal.mu_law import mu_law_numpy
from audio_style_transfer_tpu.transfer import engine as jengine
from audio_style_transfer_tpu.transfer import longform as jlong
from audio_style_transfer_tpu.transfer.grams import content_embeds, style_gram
from audio_style_transfer_tpu.transfer.losses import LossSpec as JSpec
from audio_style_transfer_tpu_torch.models import wavenet_ae as tw
from audio_style_transfer_tpu_torch.parallel import tensor as ttensor
from audio_style_transfer_tpu_torch.parallel.mesh import spawn
from audio_style_transfer_tpu_torch.signal.stft import stft_l1
from audio_style_transfer_tpu_torch.transfer import engine as tengine
from audio_style_transfer_tpu_torch.transfer import longform as tlong
from audio_style_transfer_tpu_torch.transfer.losses import LossSpec as TSpec
from audio_style_transfer_tpu_torch.transfer.losses import transfer_loss

N = workers.TIME_RANKS
TIMEOUT_S, DEADLINE_S = 60.0, 150.0
T = 2048  # SMALL clips: chunks of 512
FLAVOURS = ("cw", "gatys")
JAX_EXACT_SPEC = {k: v for k, v in workers.EXACT_SPEC.items() if k != "device"}


def _prefixed(prefix, pnp):
    return {f"{prefix}{layer}/{k}": v for layer, e in pnp.items() for k, v in e.items()}


def _jtree(pnp):
    return jax.tree.map(jnp.asarray, pnp)


@pytest.fixture(scope="module")
def weights():
    return dict(small=jax_params_np(1, **workers.HALO_SMALL), dry=jax_params_np(1, **workers.DRY),
                tiny=jax_params_np(9, **workers.TP_TINY))


def _quantized(seed, t):
    return mu_law_numpy(np.random.RandomState(seed).uniform(-0.9, 0.9, (1, t))).astype(np.float32)


@pytest.fixture(scope="module")
def inputs(weights):
    """The ranks' inputs; the loss targets come from JAX's encoder on a
    second clip (tests/test_halo.py's recipe)."""
    small = JCfg(**workers.HALO_SMALL)
    ref, _ = jextracts(_jtree(weights["small"]), jnp.asarray(_quantized(2, T)), small)
    targets = {}
    for flavour in FLAVOURS:
        spec = JSpec(**workers.HALO_SPEC, gatys=flavour == "gatys")
        targets[f"{flavour}_phi_c"] = np.asarray(
            content_embeds(ref, spec.cont_lyr_ids, spec.cnt_channels))
        targets[f"{flavour}_phi_s"] = np.asarray(
            style_gram(ref, spec.style_layer_ids, gatys=spec.gatys, nb_channels=spec.nb_channels))
    tiny = JCfg(**workers.TP_TINY)
    rng = np.random.RandomState(9)
    tp_xq = mu_law_numpy(rng.uniform(-0.9, 0.9, (2, 128))).astype(np.float32)
    _, tp_enc = jextracts(_jtree(weights["tiny"]), jnp.asarray(tp_xq), tiny)
    clips = np.random.RandomState(3)
    return dict(trunk_x=_quantized(0, T), loss_x=_quantized(1, T),
                stft_a=np.random.RandomState(5).uniform(-0.9, 0.9, 4096).astype(np.float32),
                content=clips.uniform(-0.5, 0.5, 8192).astype(np.float32),
                style=clips.uniform(-0.5, 0.5, 8192).astype(np.float32),
                tp_xq=tp_xq, tp_enc=np.asarray(tp_enc), **targets,
                **{k: v for name, p in weights.items()
                   for k, v in _prefixed(f"{name}/", p).items()})


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The 4 ranks' outputs of time_sharded_worker (one spawned group)."""
    tmp = tmp_path_factory.mktemp("time")
    np.savez(tmp / "in.npz", **inputs)
    spawn(workers.time_sharded_worker, N, args=(str(tmp),), device="cpu", timeout_s=TIMEOUT_S,
          deadline_s=DEADLINE_S)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(N)]


def _shard_map(fn, in_specs, out_specs, axis="time"):
    return shard_map(fn, mesh=jmake_mesh(N, axis_name=axis), in_specs=in_specs,
                     out_specs=out_specs, check_vma=False)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("tap", ["first", "last"])
def test_time_sharded_trunk_matches_jax_and_the_unsharded_trunk(ranks, inputs, weights, tap):
    """Taps 0 and 31 (the bottleneck) gathered over the ranks, against JAX's
    shard_map recipe (tests/test_halo.py) and the port's encoder_trunk on the
    whole clip."""
    idx = 0 if tap == "first" else -1
    small = JCfg(**workers.HALO_SMALL)

    def fn(params, x_local):
        return jhalo.time_sharded_trunk(params, x_local, small, "time")[idx]

    want = jax.jit(_shard_map(fn, (P(), P(None, "time")), P(None, "time")))(
        _jtree(weights["small"]), jnp.asarray(inputs["trunk_x"]))[0]
    local = tw.encoder_trunk(torch_params(weights["small"]), torch.from_numpy(inputs["trunk_x"]),
                             tw.WaveNetAEConfig(**workers.HALO_SMALL))[idx][0]
    for r in ranks:
        _close(r[f"trunk_{tap}"], want, 1e-4, 1e-5)
        _close(r[f"trunk_{tap}"], local.numpy(), 1e-4, 1e-5)


def test_sharded_stft_l1_matches_stft_l1(ranks, inputs):
    """Value and gradient against the port's stft_l1 on the whole signal
    (frames straddle every chunk border); a chunk that is no multiple of the
    frame step is refused."""
    a = torch.from_numpy(inputs["stft_a"]).requires_grad_(True)
    v = stft_l1(a)
    (g,) = torch.autograd.grad(v, a)
    for r in ranks:
        _close(r["stft_v"], float(v.detach()), 1e-6)
        _close(r["stft_g"], g.numpy(), 1e-5, 1e-8)
        assert "chunk % frame_step == 0, got 1000 % 512" in str(r["err_stft"])


@pytest.mark.parametrize("flavour", FLAVOURS)
def test_sharded_loss_and_gradient_match_jax_and_transfer_loss(ranks, inputs, weights, flavour):
    """make_sharded_loss at gamma 0.01, channel-wise and Gatys: against JAX's
    on a 4-device mesh and the port's transfer_loss on the whole clip (the
    dry run's bounds); the loss equal on every rank."""
    phi_c, phi_s = inputs[f"{flavour}_phi_c"], inputs[f"{flavour}_phi_s"]
    jspec = JSpec(**workers.HALO_SPEC, gatys=flavour == "gatys")
    loss_fn = jhalo.make_sharded_loss(_jtree(weights["small"]), jnp.asarray(phi_c),
                                      jnp.asarray(phi_s), JCfg(**workers.HALO_SMALL), jspec,
                                      jmake_mesh(N, axis_name="time"), "time")
    jv, jg = jax.jit(jax.value_and_grad(loss_fn))(jnp.asarray(inputs["loss_x"]))
    x = torch.from_numpy(inputs["loss_x"]).requires_grad_(True)
    tv = transfer_loss(torch_params(weights["small"]), x, torch.tensor(phi_c),
                       torch.tensor(phi_s), tw.WaveNetAEConfig(**workers.HALO_SMALL),
                       TSpec(**workers.HALO_SPEC, gatys=flavour == "gatys"))[0]
    (tg,) = torch.autograd.grad(tv, x)
    assert len({float(r[f"{flavour}_loss"]) for r in ranks}) == 1
    for want_v, want_g in ((float(jv), np.asarray(jg)[0]), (float(tv.detach()), tg.numpy()[0])):
        scale = float(np.max(np.abs(want_g)))
        assert scale > 0
        for r in ranks:
            _close(r[f"{flavour}_loss"], want_v, 2e-4)
            _close(r[f"{flavour}_grad"], want_g, 1e-4, 1e-5 * scale)


def test_sharded_embeds_match_jax(ranks, inputs, weights):
    """make_sharded_embeds: the content embed gathered over the ranks and the
    gram (equal on every rank) against JAX's."""
    embeds = jhalo.make_sharded_embeds(_jtree(weights["small"]), JCfg(**workers.HALO_SMALL),
                                       JSpec(**workers.HALO_SPEC), jmake_mesh(N, axis_name="time"),
                                       "time")
    c, gram = jax.jit(embeds)(jnp.asarray(inputs["loss_x"]))
    assert all(np.array_equal(r["emb_gram"], ranks[0]["emb_gram"]) for r in ranks)
    for r in ranks:
        _close(r["emb_c"], c, 1e-4, 1e-5)
        _close(r["emb_gram"], gram, 1e-4, 1e-5)


def test_transfer_exact_mesh_matches_jax_and_mesh_none(ranks, inputs, weights):
    """transfer_exact over 4 ranks against JAX's over make_mesh(4) and the
    port's mesh=None (one window): equal evaluation counts, losses within
    rtol 1e-3, the audio gathered alike on every rank."""
    jeng = jengine.StyleTransfer(jengine.TransferSpec(**JAX_EXACT_SPEC), _jtree(weights["dry"]),
                                 model_cfg=JCfg(**workers.DRY))
    teng = tengine.StyleTransfer(tengine.TransferSpec(**workers.EXACT_SPEC),
                                 torch_params(weights["dry"]),
                                 model_cfg=tw.WaveNetAEConfig(**workers.DRY))
    want = jlong.transfer_exact(jeng, inputs["content"], inputs["style"], jmake_mesh(N))
    local = tlong.transfer_exact(teng, inputs["content"], inputs["style"])
    for other in (want, local):
        assert other.per_window["t_optimized"] == 8192
    for r in ranks:
        assert r["ex_audio"].shape == (8192,) and r["ex_x"].shape == (1, 8192)
        assert int(r["ex_t_optimized"]) == 8192 and int(r["ex_epochs_done"]) == 2
        np.testing.assert_array_equal(r["ex_audio"], ranks[0]["ex_audio"])
        np.testing.assert_array_equal(r["ex_x"], ranks[0]["ex_x"])
        for other in (want, local):
            assert r["ex_evals"].tolist() == np.asarray(other.per_window["evals"]).tolist()
            _close(r["ex_metrics"], other.per_window["metrics"], 1e-3)
    assert ranks[0]["ex_metrics"][-1] < ranks[0]["ex_metrics"][0]


def test_tp_prepare_decoder_params_matches_jax(weights):
    """The re-layout for 4 ranks, value for value (gate halves interleaved
    by shard, res + skip fused)."""
    cfg = workers.TP_TINY
    want = jtensor.tp_prepare_decoder_params(_jtree(weights["tiny"]), N, JCfg(**cfg))
    got = ttensor.tp_prepare_decoder_params(torch_params(weights["tiny"]), N,
                                            tw.WaveNetAEConfig(**cfg))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k].numpy(), np.asarray(want[name][k]))


def _grads_close(r, key, want):
    for name, g in want.items():
        np.testing.assert_allclose(r[f"{key}_g/{name}"], g, rtol=2e-4, atol=1e-6, err_msg=name)


def _flat(tree):
    return {f"{layer}/{k}": np.asarray(v) for layer, e in tree.items() for k, v in e.items()}


@pytest.fixture(scope="module")
def jax_tp(inputs, weights):
    """JAX's tp_decode_logits on a 4-device mesh and its decode_logits:
    (logits, NLL, flat parameter gradients) of each."""
    xq, enc = jnp.asarray(inputs["tp_xq"]), jnp.asarray(inputs["tp_enc"])
    jcfg = JCfg(**workers.TP_TINY)
    jmesh = jmake_mesh(N, axis_name="model")
    out = []
    for decode in (lambda p: jtensor.tp_decode_logits(p, xq, enc, jcfg, jmesh),
                   lambda p: jdecode(p, xq, enc, jcfg)):
        def loss(p, decode=decode):
            logits = decode(p)
            return jnll(logits, xq), logits

        (nll, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            _jtree(weights["tiny"]))
        out.append((np.asarray(logits), float(nll), _flat(g)))
    return out


@pytest.mark.parametrize("remat", [False, True], ids=["remat off", "remat on"])
def test_tp_decode_logits_matches_jax_and_decode_logits(ranks, inputs, weights, jax_tp, remat):
    """tp_decode_logits over 4 ranks: logits, NLL and the gradients of the
    ORIGINAL params against JAX's tp_decode_logits on a 4-device mesh, JAX's
    decode_logits and the port's; every rank's gradients equal bit for bit.
    Remat off also takes the encoding's gradient (the f on the encoding)."""
    key = f"tp{int(remat)}"
    xq, enc = inputs["tp_xq"], inputs["tp_enc"]
    tp = torch_params(weights["tiny"])
    leaves = [v.requires_grad_(True) for e in tp.values() for v in e.values()]
    tenc = torch.tensor(enc).requires_grad_(True)
    tlogits = tw.decode_logits(tp, torch.tensor(xq), tenc,
                               tw.WaveNetAEConfig(**workers.TP_TINY, remat=remat))
    tnll = tw.nll_loss(tlogits, torch.tensor(xq))
    tg = torch.autograd.grad(tnll, leaves + [tenc], allow_unused=True, materialize_grads=True)
    names = [f"{layer}/{k}" for layer, e in tp.items() for k in e]
    tref_g = {n: g.numpy() for n, g in zip(names, tg)}

    (jtp_logits, jtp_nll, jtp_g), (jref_logits, jref_nll, jref_g) = jax_tp
    nonzero = sum(float(np.abs(g).max()) > 0 for g in jref_g.values())
    assert nonzero > len(names) // 2
    for r in ranks:
        for logits in (jtp_logits, jref_logits, tlogits.detach().numpy()):
            _close(r[f"{key}_logits"], logits, 1e-5, 1e-5)
        for nll in (jtp_nll, jref_nll, float(tnll.detach())):
            _close(r[f"{key}_nll"], nll, 1e-6)
        for want in (jtp_g, jref_g, tref_g):
            _grads_close(r, key, want)
        for name in names:
            np.testing.assert_array_equal(r[f"{key}_g/{name}"], ranks[0][f"{key}_g/{name}"])
        if not remat:
            np.testing.assert_allclose(r[f"{key}_enc_grad"], tg[-1].numpy(), rtol=2e-4,
                                       atol=1e-6)


def test_tp_width_must_split_over_the_ranks(ranks):
    for r in ranks:
        assert "decoder width 18 does not split over the 4 ranks of 'model'" in str(r["err_tp"])
