"""Worker functions of the port's multi-process tests (tests/test_torch_dp_train.py,
tests/test_torch_clip_sharded.py, tests/test_torch_time_sharded.py), run by
``parallel.mesh.spawn`` in fresh processes over gloo on the CPU.

Each worker reads its inputs from ``<tmp>/in.npz`` (written by the test
process), runs every case of its file in one process group, and writes
``<tmp>/rank<r>.npz``. This module imports torch and the port, never JAX:
the test process imports JAX (tests/conftest.py), the workers do not.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# The toy geometry of the JAX package's multi-device dry run
# (__graft_entry__.py::dryrun_multichip).
DRY = dict(num_layers=4, num_stages=2, width=16, skip_width=8, ae_num_layers=4,
           ae_num_stages=2, ae_width=8, ae_hop_length=64, ae_bottleneck_width=4)
DP_CFG = dict(total_batch_size=4, sample_length=256, save_every_steps=0)
CLIP_SPEC = dict(batch_size=4096, stack=None, style_lyr_ids=(0, 1, 2, 3), cont_lyr_ids=(3,),
                 nb_channels=8, cnt_channels=8, epochs=1, maxiter=2, early_stop_evals=0,
                 write_artifacts=False, device="cpu")
LONGFORM_MAXITER = 4
# tests/test_halo.py's SMALL encoder (6 trunk layers, radius 15: one 512-sample
# halo) and tests/test_tensor_parallel.py's TINY decoder (4 layers of width 16).
HALO_SMALL = dict(num_layers=2, num_stages=2, width=8, skip_width=8, ae_num_layers=6,
                  ae_num_stages=3, ae_width=8, ae_hop_length=64, ae_bottleneck_width=4)
HALO_SPEC = dict(cont_lyr_ids=(5,), style_layer_ids=(0, 1, 2, 3, 4, 5), cnt_channels=8,
                 nb_channels=8, lambd=10.0, gamma=0.01)
TP_TINY = dict(num_layers=4, num_stages=2, width=16, skip_width=8, ae_num_layers=2,
               ae_num_stages=2, ae_width=8, ae_hop_length=32, ae_bottleneck_width=4)
TIME_RANKS = 4  # a middle rank exists: its unwindowed trunk is tested too
EXACT_SPEC = dict(CLIP_SPEC, epochs=2, maxiter=4)


def params_from_flat(flat, prefix: str = "") -> dict:
    """``{"<prefix><layer>/<key>": array}`` -> the port's params dict on the
    CPU (keys without the prefix, or with one more "/", are not weights)."""
    from audio_style_transfer_tpu_torch.ckpt.convert import params_from_numpy

    tree: dict = {}
    for name in flat.files if hasattr(flat, "files") else flat:
        rest = name[len(prefix):]
        if name.startswith(prefix) and rest.count("/") == 1:
            layer, key = rest.split("/")
            tree.setdefault(layer, {})[key] = np.asarray(flat[name])
    return params_from_numpy(tree)


def flat_params(tree, prefix: str = "") -> dict:
    return {f"{prefix}{layer}/{k}": v.detach().cpu().numpy().copy()
            for layer, e in tree.items() for k, v in e.items()}


def _error(fn) -> str:
    """The message of the ValueError ``fn()`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def dp_worker(rank: int, tmp: str) -> None:
    """Every data-parallel case on a 2-rank gloo mesh:
    - ``step``: one step of the global batch ``wav0``, then two more
      (``wav1``, ``wav2``): the loss of each, the params after step 1, the
      params, EMA and Adam's moments after step 3;
    - ``mb``: one step with ``microbatch=2`` on the 8-row ``wav_mb``;
    - ``fit``: ``fit`` over the TFRecord ``<tmp>/train.tfrecord`` (3 steps,
      groups of 2, a checkpoint at step 2), then ``save`` and ``restore``:
      the checkpoints each rank wrote, the restored state;
    - the refusals of a batch that does not split and of a mesh larger than
      the world;
    - ``data_parallel_specs`` and ``make_hybrid_mesh``."""
    torch.set_num_threads(1)
    from audio_style_transfer_tpu_torch.data import NSynthDataset
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.parallel import (
        data_parallel_specs,
        make_hybrid_mesh,
        make_mesh,
    )
    from audio_style_transfer_tpu_torch.train import TrainConfig, Trainer
    from audio_style_transfer_tpu_torch.train.trainer import _leaves

    inp = np.load(os.path.join(tmp, "in.npz"))
    params = params_from_flat(inp)
    cfg = WaveNetAEConfig(**DRY)
    mesh = make_mesh(2, device="cpu")
    out = {}

    tr = Trainer(TrainConfig(**DP_CFG), cfg, mesh=mesh)
    st = tr.init_state(params)
    for i in range(3):
        st, loss = tr.step(st, inp[f"wav{i}"])
        out[f"loss{i}"] = float(loss)
        if i == 0:
            out.update(flat_params(st["params"], "step1/"))
    out.update(flat_params(st["params"], "step3/"))
    out.update(flat_params(st["ema"], "ema3/"))
    opt = st["opt_state"]
    for j, p in enumerate(_leaves(st["params"])):
        out[f"m3/{j}"] = opt.state[p]["exp_avg"].numpy().copy()
        out[f"v3/{j}"] = opt.state[p]["exp_avg_sq"].numpy().copy()

    tr = Trainer(TrainConfig(**dict(DP_CFG, total_batch_size=8, microbatch=2)), cfg, mesh=mesh)
    st, loss = tr.step(tr.init_state(params), inp["wav_mb"])
    out["mb_loss"] = float(loss)
    out.update(flat_params(st["params"], "mb/"))

    logdir = os.path.join(tmp, "fit")
    tr = Trainer(TrainConfig(**dict(DP_CFG, logdir=logdir, save_every_steps=2,
                                    steps_per_call=2, log_every_steps=1)), cfg, mesh=mesh)
    writes, logged = [], []
    write = tr._write
    tr._write = lambda state, path: (writes.append(os.path.basename(path)), write(state, path))
    ds = NSynthDataset(os.path.join(tmp, "train.tfrecord"), is_training=True,
                       use_native=False)
    st = tr.fit(tr.init_state(params), ds.get_wavenet_batch(4, length=256), num_steps=3,
                log=logged.append)
    tr.save(st)
    out["fit_writes"] = np.array(writes, dtype=str)
    out["fit_logged"] = np.array(len(logged))
    out.update(flat_params(st["params"], "fit/"))
    back = tr.restore()
    out["restored_step"] = np.array(back["step"])
    out.update(flat_params(back["params"], "restored/"))
    out.update(flat_params(back["ema"], "restored_ema/"))
    for j, (p, q) in enumerate(zip(_leaves(st["params"]), _leaves(back["params"]))):
        out[f"restored_m_equal/{j}"] = np.array(torch.equal(
            st["opt_state"].state[p]["exp_avg_sq"], back["opt_state"].state[q]["exp_avg_sq"]))

    out["err_total_batch"] = _error(
        lambda: Trainer(TrainConfig(**dict(DP_CFG, total_batch_size=3)), cfg, mesh=mesh))
    tr = Trainer(TrainConfig(**DP_CFG), cfg, mesh=mesh)
    st = tr.init_state(params)
    out["err_batch_rows"] = _error(lambda: tr.step(st, inp["wav0"][:3]))
    out["err_n_devices"] = _error(lambda: make_mesh(3, device="cpu"))

    replicate, shard = data_parallel_specs("data")
    mine = torch.full((2, 3), float(rank + 1))
    replicate(mesh, [mine])
    out["replicated"] = mine.numpy()
    out["shard_rows"] = shard(mesh, np.arange(12).reshape(6, 2))
    out["shard_dim1"] = shard(mesh, torch.arange(12).reshape(2, 6), dim=1).numpy()
    hybrid = make_hybrid_mesh(device="cpu")
    out["hybrid_shape"] = np.array(tuple(hybrid.mesh.shape))
    out["hybrid_names"] = np.array(hybrid.mesh_dim_names)
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def clip_worker(rank: int, tmp: str) -> None:
    """Every clip-sharded case on a 2-rank gloo mesh named ``clips``:
    - ``batch``: ``optimize_batch(phi_cs, phi_ss, mesh=)`` over the 4 clips;
    - ``losses``: each clip's transfer loss against its neighbour's targets
      (``xs``, ``pcs``, ``pss``) on the rank's clips, gathered;
    - ``grads``: the same at T=512 (``xs_g``, ``pcs_g``, ``pss_g``), each
      clip's waveform gradient, gathered;
    - ``lf8`` / ``lf5``: ``transfer_longform`` over 8 windows, and over 5
      windows with ``windows_per_device=2`` (a padded trailing group);
    - the refusal of 3 clips on 2 ranks."""
    torch.set_num_threads(1)
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
    from audio_style_transfer_tpu_torch.parallel import make_mesh
    from audio_style_transfer_tpu_torch.parallel.mesh import gather_rows, shard_rows
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu_torch.transfer.longform import transfer_longform
    from audio_style_transfer_tpu_torch.transfer.losses import transfer_loss

    inp = np.load(os.path.join(tmp, "in.npz"))
    params = params_from_flat(inp)
    cfg = WaveNetAEConfig(**DRY)
    mesh = make_mesh(2, axis_name="clips", device="cpu")
    engine = StyleTransfer(TransferSpec(**CLIP_SPEC), params, model_cfg=cfg)
    out = {}

    batch = engine.optimize_batch(inp["phi_cs"], inp["phi_ss"], epochs=1, mesh=mesh)
    out.update({f"batch/{k}": np.asarray(v) for k, v in batch.items()})

    def per_clip(xs, pcs, pss, grad: bool):
        rows = []
        for x, pc, ps in zip(*(shard_rows(mesh, torch.from_numpy(a), "clips")
                               for a in (xs, pcs, pss))):
            x = x.clone().requires_grad_(grad)
            loss = transfer_loss(engine.params, x, pc, ps, engine.cfg, engine.loss_spec)[0]
            rows.append(torch.autograd.grad(loss, x)[0] if grad else loss.detach())
        return gather_rows(mesh, torch.stack(rows).numpy())

    out["losses"] = per_clip(inp["xs"], inp["pcs"], inp["pss"], grad=False)
    out["grads"] = per_clip(inp["xs_g"], inp["pcs_g"], inp["pss_g"], grad=True)

    lf = StyleTransfer(TransferSpec(**dict(CLIP_SPEC, maxiter=LONGFORM_MAXITER)), params,
                       model_cfg=cfg)
    for name, wins, wpd in (("lf8", 8, 8), ("lf5", 5, 2)):
        res = transfer_longform(lf, inp["content"][: wins * 4096], inp["style"], epochs=1,
                                crossfade=0, mesh=mesh, windows_per_device=wpd)
        out[f"{name}/audio"] = res.audio
        out[f"{name}/evals"] = res.per_window["evals"]

    out["err_clips"] = _error(lambda: engine.optimize_batch(
        inp["phi_cs"][:3], inp["phi_ss"][:3], epochs=1, mesh=mesh))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def time_sharded_worker(rank: int, tmp: str) -> None:
    """Every time-sharded and tensor-parallel case on a TIME_RANKS-rank gloo
    mesh (inputs ``small/``, ``dry/`` and ``tiny/`` weights and the arrays
    named below; gathered results are whole-clip arrays):
    - ``trunk_first`` / ``trunk_last``: ``time_sharded_trunk``'s taps 0 and
      31 of ``trunk_x``;
    - ``stft_v`` / ``stft_g``: ``sharded_stft_l1`` of ``stft_a`` and its
      gradient; ``err_stft``: a 1000-sample chunk refused;
    - ``<cw|gatys>_loss`` / ``_grad``: ``make_sharded_loss`` of ``loss_x``
      against ``<flavour>_phi_c`` / ``_phi_s``, and its gradient;
    - ``emb_c`` / ``emb_gram``: ``make_sharded_embeds`` of ``loss_x``;
    - ``ex_*``: ``transfer_exact(mesh=)`` of ``content`` / ``style``;
    - ``tp<remat>_*``: ``tp_decode_logits`` of ``tp_xq`` / ``tp_enc``, its
      NLL and the gradients of the original params (and of the encoding);
      ``err_tp``: a width that does not split."""
    torch.set_num_threads(1)
    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, nll_loss
    from audio_style_transfer_tpu_torch.parallel import halo, make_mesh, tp_decode_logits
    from audio_style_transfer_tpu_torch.parallel.mesh import gather_rows, shard_rows
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu_torch.transfer.longform import transfer_exact
    from audio_style_transfer_tpu_torch.transfer.losses import LossSpec

    inp = np.load(os.path.join(tmp, "in.npz"))
    mesh = make_mesh(TIME_RANKS, axis_name="time", device="cpu")
    group = mesh.get_group("time")
    small, ps = WaveNetAEConfig(**HALO_SMALL), params_from_flat(inp, "small/")
    out = {}

    def local(name, dim=1):
        return shard_rows(mesh, torch.from_numpy(inp[name]), "time", dim=dim).clone()

    def gather(t):
        return gather_rows(mesh, t.detach().numpy(), "time")

    taps = halo.time_sharded_trunk(ps, local("trunk_x"), small, group)
    out["trunk_first"], out["trunk_last"] = gather(taps[0][0]), gather(taps[-1][0])

    a = local("stft_a", dim=0).requires_grad_(True)
    v = halo.sharded_stft_l1(a, group)
    out["stft_v"], out["stft_g"] = v.detach().numpy(), gather(torch.autograd.grad(v, a)[0])
    out["err_stft"] = _error(lambda: halo.sharded_stft_l1(torch.zeros(1000), group))

    for flavour in ("cw", "gatys"):
        spec = LossSpec(**HALO_SPEC, gatys=flavour == "gatys")
        x = local("loss_x").requires_grad_(True)
        loss = halo.make_sharded_loss(ps, local(f"{flavour}_phi_c", dim=0),
                                      torch.from_numpy(inp[f"{flavour}_phi_s"]), small, spec,
                                      mesh, "time")(x)
        out[f"{flavour}_loss"] = loss.detach().numpy()
        out[f"{flavour}_grad"] = gather(torch.autograd.grad(loss, x)[0][0])
    with torch.no_grad():
        c, gram = halo.make_sharded_embeds(ps, small, LossSpec(**HALO_SPEC), mesh,
                                           "time")(local("loss_x"))
    out["emb_c"], out["emb_gram"] = gather(c), gram.numpy()

    engine = StyleTransfer(TransferSpec(**EXACT_SPEC), params_from_flat(inp, "dry/"),
                           model_cfg=WaveNetAEConfig(**DRY))
    res = transfer_exact(engine, inp["content"], inp["style"], mesh=mesh)
    out.update({f"ex_{k}": np.asarray(v) for k, v in res.per_window.items()})
    out["ex_audio"] = res.audio

    tp_mesh = make_mesh(TIME_RANKS, axis_name="model", device="cpu")
    tiny = params_from_flat(inp, "tiny/")
    xq = torch.from_numpy(inp["tp_xq"])
    for remat in (False, True):
        leaves = [v.requires_grad_(True) for e in tiny.values() for v in e.values()]
        enc = torch.from_numpy(inp["tp_enc"]).requires_grad_(not remat)
        logits = tp_decode_logits(tiny, xq, enc, WaveNetAEConfig(**TP_TINY, remat=remat),
                                  tp_mesh)
        nll = nll_loss(logits, xq)
        grads = torch.autograd.grad(nll, leaves + ([] if remat else [enc]),
                                    allow_unused=True, materialize_grads=True)
        key = f"tp{int(remat)}"
        out[f"{key}_logits"], out[f"{key}_nll"] = logits.detach().numpy(), nll.detach().numpy()
        names = [f"{layer}/{k}" for layer, e in tiny.items() for k in e]
        out.update({f"{key}_g/{n}": g.numpy() for n, g in zip(names, grads)})
        if not remat:
            out[f"{key}_enc_grad"] = grads[-1].numpy()
    out["err_tp"] = _error(lambda: tp_decode_logits(
        tiny, xq, torch.from_numpy(inp["tp_enc"]),
        WaveNetAEConfig(**dict(TP_TINY, width=18)), tp_mesh))
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)


def sleeper(rank: int) -> None:
    """A worker that never ends (the deadline's test)."""
    import time

    while True:
        time.sleep(1)


def raiser(rank: int) -> None:
    """A worker whose rank 1 fails while rank 0 would run on forever."""
    if rank == 1:
        raise RuntimeError("rank 1 fails")
    sleeper(rank)
