"""Training in the port (train/trainer.py, train/optimizers.py and
models/wavenet_ae.py ``nll_loss`` / ``forward`` / ``remat``) against the JAX
package, on the CPU in float32, from JAX's weights carried across and the
same batches.

Geometry: the JAX trainer test's TINY config (tests/test_trainer.py). JAX
runs its default encoder (XLA convs under ``jax.checkpoint``), the port its
chained trunk (the plain K1/K2 versions on the CPU): the same function,
float32 sums in another order.

Tolerances:
- losses and the forward's outputs: rel 1e-6 (one step's loss agrees to
  about 1e-7);
- after 3 Adam steps, params and the EMA: per tensor max|d| <= 2e-5 *
  max|ref| (measured up to 7.3e-6 on the biases: Adam divides each update
  by the gradient's own scale, so where two steps' gradients nearly cancel
  a 1e-7 gradient difference grows to about 1e-5 of that update); Adam's
  moments: 1e-5 * max|ref| (measured 3.9e-7);
- the five optimizers against optax on the same gradients, learning rate
  0.1: 1e-5 * max|ref| (measured: Adam 1.1e-6, the others 1.2e-7 or less;
  optax takes Adam's bias correction 1 - 0.999^t in float32, 1.3e-5 off
  at t = 1, where torch takes it in float64);
- microbatches against one shot: the loss 1e-6, params 2e-4 * max|ref| +
  2e-6 (the JAX test's bound: the gradient is a mean of two means);
- remat on against off, run_steps against steps, save/restore: bit for bit.
"""

import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_helpers import jax_params_np, torch_params

from audio_style_transfer_tpu.models import wavenet_ae as jw
from audio_style_transfer_tpu.parallel import make_mesh
from audio_style_transfer_tpu.train import TrainConfig as JTrainConfig
from audio_style_transfer_tpu.train import Trainer as JTrainer
from audio_style_transfer_tpu.train import learning_rate as jlearning_rate
from audio_style_transfer_tpu.train.optimizers import get_optimizer as jget_optimizer
from audio_style_transfer_tpu_torch.models import wavenet_ae as tw
from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer, learning_rate
from audio_style_transfer_tpu_torch.train.optimizers import get_optimizer, scheduled_step
from audio_style_transfer_tpu_torch.train.trainer import _leaves, train_loss

TINY = dict(num_layers=2, num_stages=2, width=8, skip_width=8, ae_num_layers=2,
            ae_num_stages=2, ae_width=8, ae_hop_length=64, ae_bottleneck_width=4)
CFG = dict(total_batch_size=4, sample_length=256, save_every_steps=0)


def wavs(seed, shape=(4, 256), lo=-0.9, hi=0.9):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(np.float32)


def jparams(p):
    return {k: {m: jnp.asarray(v) for m, v in e.items()} for k, e in p.items()}


def tree_np(tree):
    return {k: {m: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
                for m, v in e.items()} for k, e in tree.items()}


def assert_trees_close(got, want, rel, abs_=0.0):
    for layer, e in want.items():
        for m, w in e.items():
            g = got[layer][m]
            limit = rel * float(np.abs(w).max()) + abs_
            assert float(np.abs(g - w).max()) <= limit, (layer, m, np.abs(g - w).max(), limit)


def assert_trees_equal(a, b):
    assert a.keys() == b.keys()
    for layer in a:
        for m in a[layer]:
            assert torch.equal(a[layer][m], b[layer][m]), (layer, m)


@pytest.fixture(scope="module")
def pnp():
    return jax_params_np(0, **TINY)


@pytest.fixture(scope="module")
def port():
    return Trainer(TrainConfig(**CFG), tw.WaveNetAEConfig(**TINY), device="cpu")


@pytest.fixture(scope="module")
def jax_trainer():
    return JTrainer(JTrainConfig(**CFG), jw.WaveNetAEConfig(**TINY), make_mesh(1))


@pytest.mark.parametrize("step", [0, 1, 89999, 90000, 119999, 120000, 125000, 150000,
                                  180000, 210000, 240000, 10**6])
def test_learning_rate_matches_jax_at_the_boundaries(step):
    assert learning_rate(step) == float(jlearning_rate(jnp.int32(step)))


@pytest.mark.parametrize("edge", ["inside", "plus_one", "below_minus_one"])
def test_nll_loss_and_forward_match_jax(pnp, edge):
    """Every output of ``forward`` against JAX's; with wav == +1.0 in a row
    (label 256) both losses are NaN and the gradient stays finite; wav
    below -1 (a label below 0) counts from the end in both."""
    wav = wavs(1)
    if edge == "plus_one":
        wav[1, 7] = 1.0
    if edge == "below_minus_one":
        wav[0, 3] = -1.5
    cfg_j, cfg_t = jw.WaveNetAEConfig(**TINY), tw.WaveNetAEConfig(**TINY)
    jo = jw.forward(jparams(pnp), {"wav": jnp.asarray(wav)}, cfg_j)
    tp = torch_params(pnp)
    to = tw.forward(tp, {"wav": torch.tensor(wav)}, cfg_t)
    if edge == "plus_one":
        assert np.isnan(float(jo["loss"])) and torch.isnan(to["loss"])
        assert int(to["quantized_input"][1, 7]) + 128 == 256
    else:
        assert float(to["loss"]) == pytest.approx(float(jo["loss"]), rel=1e-6)
    assert float(to["eval"]["nll"]) == pytest.approx(float(to["loss"]), nan_ok=True)
    for key in ("predictions", "quantized_input", "encoding", "before_enc"):
        want = np.asarray(jo[key])
        got = to[key].detach().numpy()
        assert got.shape == want.shape
        assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max()), key
    assert len(to["extracts"]) == len(jo["extracts"]) == TINY["ae_num_layers"] + 2
    # The labels' logits get a gradient; the NaN row none, as in JAX.
    logits = torch.tensor(np.random.RandomState(2).randn(1, 4, 256).astype(np.float32),
                          requires_grad=True)
    xq = torch.tensor([[127.5, 128.0, -3.2, -129.0]])
    tw.nll_loss(logits, xq).backward()
    jg = jax.grad(lambda lg: jw.nll_loss(lg, jnp.asarray(xq.numpy())))(
        jnp.asarray(logits.detach().numpy()))
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-9)
    assert float(logits.grad[0, 1].abs().max()) == 0.0


def test_trainer_loss_equals_forward_loss(pnp):
    """train_loss keeps only tap 29 and no softmax; the value is forward's."""
    cfg = tw.WaveNetAEConfig(**TINY)
    tp, wav = torch_params(pnp), torch.tensor(wavs(3))
    assert float(train_loss(tp, wav, cfg)) == float(tw.forward(tp, {"wav": wav}, cfg)["loss"])


def test_remat_on_and_off_give_the_same_loss_and_gradients(pnp):
    wav = torch.tensor(wavs(4))
    out = {}
    for remat in (False, True):
        tp = torch_params(pnp)
        leaves = _leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = train_loss(tp, wav, tw.WaveNetAEConfig(**TINY, remat=remat))
        out[remat] = (loss, torch.autograd.grad(loss, leaves, allow_unused=True))
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_three_steps_match_the_jax_trainer(pnp, port, jax_trainer):
    """Loss per step, params, Adam's moments, the EMA and the step count
    after 3 steps of the port against JAX's Trainer(mesh=make_mesh(1))."""
    js = jax_trainer.init_state(jparams(pnp))
    ts = port.init_state(torch_params(pnp))
    for i in range(3):
        w = wavs(10 + i)
        js, jl = jax_trainer.step(js, w)
        ts, tl = port.step(ts, w)
        assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    assert ts["step"] == int(js["step"]) == 3
    assert_trees_close(tree_np(ts["params"]), tree_np(js["params"]), 2e-5)
    assert_trees_close(tree_np(ts["ema"]), tree_np(js["ema"]), 2e-5)
    adam = js["opt_state"][0]
    opt = ts["opt_state"]
    for key, want in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = {k: {m: opt.state[ts["params"][k][m]][key].numpy() for m in e}
               for k, e in ts["params"].items()}
        assert_trees_close(got, tree_np(want), 1e-5)


def test_evaluate_matches_jax_and_the_ema_starts_as_the_params(pnp, port, jax_trainer):
    js = jax_trainer.init_state(jparams(pnp))
    ts = port.init_state(torch_params(pnp))
    wav = wavs(20)
    assert port.evaluate(ts, wav) == pytest.approx(jax_trainer.evaluate(js, wav), rel=1e-6)
    assert port.evaluate(ts, wav, ema=False) == port.evaluate(ts, wav, ema=True)
    assert port.eval_params(ts) is ts["ema"] and port.eval_params(ts, ema=False) is ts["params"]


@pytest.mark.parametrize("name", ["adam", "rmsprop", "adagrad", "mom", "sgd"])
def test_get_optimizer_matches_optax(name):
    """Four updates on the same gradients, the learning rate a schedule read
    at optax's count (the updates made before this one)."""
    rng = np.random.RandomState(5)
    p0 = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(4)]

    def schedule(count):
        return 0.1 if count < 2 else 0.03

    hp = type("HParams", (), {"momentum": 0.8})()
    jopt = jget_optimizer(lambda c: jnp.where(c < 2, 0.1, 0.03), hp, name=name)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    tp = [torch.tensor(p0[k]) for k in sorted(p0)]
    topt = get_optimizer(tp, schedule, hp, name=name)
    for i, g in enumerate(grads):
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tp, sorted(p0)):
            p.grad = torch.tensor(g[k])
        scheduled_step(topt, schedule, i)
        for p, k in zip(tp, sorted(p0)):
            want = np.asarray(jp[k])
            assert float(np.abs(p.numpy() - want).max()) <= 1e-5 * float(np.abs(want).max()), \
                (name, i, k)


def test_get_optimizer_refuses_an_unknown_name():
    with pytest.raises(KeyError, match="unknown optimizer"):
        get_optimizer([torch.zeros(2)], 0.1, name="lamb")


def test_microbatches_match_a_single_shot(pnp):
    wav = wavs(3, (8, 256))
    out = []
    for micro in (None, 2):
        tr = Trainer(TrainConfig(**CFG, microbatch=micro), tw.WaveNetAEConfig(**TINY),
                     device="cpu")
        st, loss = tr.step(tr.init_state(torch_params(pnp)), wav)
        out.append((float(loss), tree_np(st["params"])))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    assert_trees_close(out[1][1], out[0][1], 2e-4, 2e-6)


def test_run_steps_equal_sequential_steps(pnp, port):
    ws = wavs(7, (3, 4, 256))
    s1 = port.init_state(torch_params(pnp))
    seq = [port.step(s1, ws[i])[1] for i in range(3)]
    s2, losses = port.run_steps(port.init_state(torch_params(pnp)), ws)
    assert losses.shape == (3,) and torch.equal(losses, torch.stack(seq))
    assert_trees_equal(s1["params"], s2["params"])
    assert_trees_equal(s1["ema"], s2["ema"])


def test_init_state_draws_the_same_weights_each_time(port):
    a, b = port.init_state(), port.init_state()
    assert_trees_equal(a["params"], b["params"])
    assert_trees_equal(a["params"], a["ema"])
    assert a["params"]["logits"]["w"] is not a["ema"]["logits"]["w"]


def test_save_restore_bit_for_bit_and_temp_names_skipped(tmp_path, pnp):
    tr = Trainer(TrainConfig(**dict(CFG, logdir=str(tmp_path))), tw.WaveNetAEConfig(**TINY),
                 device="cpu")
    st = tr.init_state(torch_params(pnp))
    for i in range(2):
        st, _ = tr.step(st, wavs(30 + i))
    path = tr.save(st)
    assert os.path.basename(path) == "ckpt-2"
    # A save cut off before its rename, and a later one.
    (tmp_path / "ckpt-999.tmp-123").write_bytes(b"partial")
    restored = tr.restore()
    assert restored["step"] == 2
    assert_trees_equal(restored["params"], st["params"])
    assert_trees_equal(restored["ema"], st["ema"])
    for key in ("exp_avg", "exp_avg_sq", "step"):
        for p, q in zip(_leaves(st["params"]), _leaves(restored["params"])):
            assert torch.equal(st["opt_state"].state[p][key],
                               restored["opt_state"].state[q][key])
    # Training on from either gives the same bits.
    w = wavs(40)
    a, la = tr.step(st, w)
    b, lb = tr.step(restored, w)
    assert torch.equal(la, lb)
    assert_trees_equal(a["params"], b["params"])
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        Trainer(TrainConfig(logdir=str(tmp_path / "empty")), device="cpu").restore()


def test_fit_checkpoints_on_preemption_signal(tmp_path, pnp):
    cfg = TrainConfig(**dict(CFG, logdir=str(tmp_path), log_every_steps=1, steps_per_call=1))
    tr = Trainer(cfg, tw.WaveNetAEConfig(**TINY), device="cpu")
    st = tr.init_state(torch_params(pnp))

    def batches():
        n = 0
        while True:
            n += 1
            if n == 2:
                os.kill(os.getpid(), signal.SIGTERM)  # a preemption
            yield {"wav": wavs(50 + n)}

    logged = []
    st = tr.fit(st, batches(), num_steps=100, log=logged.append)
    assert st["step"] < 100
    assert any("preemption signal" in line for line in logged)
    assert tr.restore()["step"] == st["step"]
    assert signal.getsignal(signal.SIGTERM) is not None


@pytest.mark.parametrize("steps_per_call,num_steps", [(4, 6), (2, 4)])
def test_fit_groups_and_the_partial_trailing_group(tmp_path, pnp, steps_per_call, num_steps):
    """Full groups through run_steps, a trailing partial group step by step:
    the host step counter stays exact and the params equal num_steps
    sequential steps on the same batches bit for bit."""
    cfg = TrainConfig(**dict(CFG, logdir=str(tmp_path), log_every_steps=1000,
                             steps_per_call=steps_per_call))
    tr = Trainer(cfg, tw.WaveNetAEConfig(**TINY), device="cpu")
    data = wavs(60, (num_steps + 3, 4, 256))
    st = tr.fit(tr.init_state(torch_params(pnp)), ({"wav": w} for w in data),
                num_steps=num_steps, log=lambda *a: None)
    assert st["step"] == num_steps
    ref = tr.init_state(torch_params(pnp))
    for w in data[:num_steps]:
        ref, _ = tr.step(ref, w)
    assert_trees_equal(st["params"], ref["params"])


def test_memorizing_one_batch_lowers_the_loss(port):
    st = port.init_state()
    wav = wavs(0, lo=-0.5, hi=0.5)
    losses = [float(port.step(st, wav)[1]) for _ in range(5)]
    assert st["step"] == 5 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    # The EMA tracks the params without equalling them.
    p, e = st["params"]["ae_startconv"]["w"].detach(), st["ema"]["ae_startconv"]["w"]
    assert not torch.equal(p, e) and float((p - e).abs().max()) < 1e-2


def test_trainer_runs_on_cuda_by_default():
    tr = Trainer(TrainConfig(), tw.WaveNetAEConfig(**TINY))
    assert tr.device == torch.device("cuda")
    assert dataclasses.replace(tr.model_cfg, remat=False) == tw.WaveNetAEConfig(**TINY)
    assert tr.model_cfg.remat
