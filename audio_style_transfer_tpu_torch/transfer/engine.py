"""Style-transfer engine (counterpart of audio_style_transfer_tpu/transfer/engine.py).

The JAX engine runs the whole multi-epoch optimization as one XLA program.
Here the same semantics run as an eager Python epoch loop around the eager
L-BFGS: a cold restart each epoch (or ``warm_start`` with a reset after a
failed line search), the stop when an epoch takes fewer than
``early_stop_evals`` evaluations, epoch k's metrics row taken from epoch
k+1's initial evaluation, and one closing forward after the last epoch.
Artifacts (ep-N.wav, gram figures, spectrograms) follow the reference's
layout (methods.py:169-179).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig
from audio_style_transfer_tpu_torch.parallel.mesh import gather_rows
from audio_style_transfer_tpu_torch.signal.mu_law import inv_mu_law_numpy, mu_law_numpy
from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize, select_style_layers
from audio_style_transfer_tpu_torch.transfer.lbfgs import LBFGSOptions, lbfgs_minimize
from audio_style_transfer_tpu_torch.transfer.losses import (
    LossSpec,
    transfer_embeds,
    transfer_loss,
)
from audio_style_transfer_tpu_torch.utils.audio_io import load_audio, write_wav
from audio_style_transfer_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class TransferSpec:
    """Run configuration (the argparse surface of methods.py:243-271)."""

    savepath: str = "./data/out"
    logdir: str = "./log"
    figdir: str = "./data/fig"
    stack: int | None = 0
    batch_size: int = 16384
    sr: int = 16000
    cont_lyr_ids: tuple = (29,)
    nb_channels: int = 128
    cnt_channels: int = 128
    gatys: bool = False
    style_lyr_ids: tuple | None = None
    epochs: int = 100
    lambd: float = 100.0
    gamma: float = 0.0
    maxiter: int = 100
    early_stop_evals: int = 50  # epoch eval count below which the run stops
    compute_dtype: str = "float32"  # or "bfloat16"
    # The trunk flavour, resolved as the JAX engine does: chain_encoder None
    # follows fused_encoder, and only fused_encoder=True with
    # chain_encoder=False selects the per-layer blocks (K7f/K7b); every other
    # setting runs the chained trunk (K1/K2). fused_gram is accepted for
    # parity and selects nothing. The device picks kernels (CUDA) or their
    # plain versions (CPU) either way.
    fused_encoder: bool = False
    chain_encoder: bool | None = None
    fused_gram: bool | None = None
    # Carry the L-BFGS curvature memory across epochs instead of the
    # reference's cold per-epoch restarts.
    warm_start: bool = False
    write_artifacts: bool = True
    device: str = "cuda"

    @property
    def late(self) -> int:
        """Receptive-field edge trim (reference methods.py:39)."""
        return (self.batch_size - (self.batch_size // 4096) * 4000) // 2


def _metrics_row(parts) -> np.ndarray:
    return np.array([float(parts[k]) for k in
                     ("loss", "content_loss", "style_loss", "regularizer")], np.float32)


class StyleTransfer:
    """Runs transfers with one set of encoder weights on one device (on each
    rank's, with ``optimize_batch(mesh=)``)."""

    def __init__(self, spec: TransferSpec, params, model_cfg: WaveNetAEConfig | None = None):
        self.spec = spec
        if spec.batch_size % 4096:
            raise ValueError(
                f"batch_size must be a multiple of 4096, got {spec.batch_size}")
        self.device = torch.device(spec.device)
        dtype = getattr(torch, spec.compute_dtype)
        cfg = model_cfg or WaveNetAEConfig()
        use_chain = spec.fused_encoder if spec.chain_encoder is None else spec.chain_encoder
        self.cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                                       fused_encoder=spec.fused_encoder,
                                       chain_encoder=use_chain)
        # Cast the encoder weights (transfer never runs the decoder) to the
        # compute dtype once, on the run's device.
        self.params = {
            layer: {k: torch.as_tensor(v).to(self.device, dtype) for k, v in entry.items()}
            for layer, entry in params.items() if layer.startswith("ae_")
        }
        style_ids = tuple(select_style_layers(cfg.ae_num_layers, spec.stack,
                                              spec.style_lyr_ids))
        self.loss_spec = LossSpec(
            cont_lyr_ids=tuple(spec.cont_lyr_ids),
            style_layer_ids=style_ids,
            cnt_channels=spec.cnt_channels,
            nb_channels=spec.nb_channels,
            gatys=spec.gatys,
            lambd=spec.lambd,
            gamma=spec.gamma,
        )

    def _tensor(self, a) -> torch.Tensor:
        """``a`` as a float32 tensor on the run's device (a tensor already
        there is not copied)."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------ #
    # Feature extraction (reference methods.py:86-111)
    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def _embeds(self, xq: torch.Tensor):
        c, s = transfer_embeds(self.params, xq, self.cfg, self.loss_spec)
        return c.cpu().numpy(), s.cpu().numpy()

    def get_embeds(self, aud: np.ndarray, is_content: bool = True) -> np.ndarray:
        """Features of one window, fed in floor-mu-law space (methods.py:86-95)."""
        aud = np.asarray(aud)
        if aud.ndim == 1:
            aud = aud[: self.spec.batch_size][None, :]
        c, s = self._embeds(self._tensor(mu_law_numpy(aud)))
        return c if is_content else s

    def get_style_phi(self, audio: np.ndarray, max_examples: int = 5,
                      show_mat: bool = False, figdir: str | None = None) -> np.ndarray:
        """Chunked style-gram average (reference methods.py:97-111)."""
        bs = self.spec.batch_size
        if len(audio) < bs:
            raise ValueError(
                f"style/content audio has {len(audio)} samples but one window "
                f"needs batch_size={bs}; provide a longer clip or a smaller "
                f"--batch_size")
        n = max(min(len(audio), max_examples * bs) // bs, 1)
        grams = [self.get_embeds(audio[i * bs : (i + 1) * bs], is_content=False)
                 for i in range(n)]
        phi = np.mean(grams, axis=0)
        if show_mat and figdir:
            from audio_style_transfer_tpu_torch.analysis.viz import show_gram

            show_gram(phi, figdir=figdir, gatys=self.spec.gatys)
        return phi

    # ------------------------------------------------------------------ #
    # The optimization loop
    # ------------------------------------------------------------------ #

    def _run_epochs(self, x0: torch.Tensor, phi_c: torch.Tensor,
                    phi_s: torch.Tensor, epochs: int):
        """All epochs (replaces methods.py:140-181). Returns (snapshots
        [epochs, T], metrics [epochs, 4], evals [epochs], epochs_done)."""
        spec = self.spec
        opts = LBFGSOptions(maxiter=spec.maxiter, line_search="zoom",
                            restart_on_ls_fail=False)

        def loss_fn(x):
            return transfer_loss(self.params, x[None, :], phi_c, phi_s, self.cfg,
                                 self.loss_spec)

        def vg(x):
            xv = x.detach().requires_grad_(True)
            loss, parts = loss_fn(xv)
            (g,) = torch.autograd.grad(loss, xv)
            return (loss.detach(), {k: v.detach() for k, v in parts.items()}), g

        t = x0.shape[-1]
        x = x0.reshape(t).to(torch.float32)
        snapshots = np.zeros((epochs, t), np.float32)
        metrics = np.zeros((epochs, 4), np.float32)
        evals = np.zeros((epochs,), np.int32)
        history = None
        ep = 0
        while ep < epochs:
            res, hist = lbfgs_minimize(vg, x, opts, history=history,
                                       return_history=True, has_aux=True)
            if spec.warm_start:
                # An epoch that ended on a failed line search hands over its
                # x with a reset memory, so the next one cannot repeat it.
                history = None if res.status == 3 else hist
            # res.aux = the components at this epoch's x0, the previous
            # epoch's final iterate: that epoch's metrics row.
            if ep > 0:
                metrics[ep - 1] = _metrics_row(res.aux)
            x = res.x
            snapshots[ep] = x.detach().cpu().numpy()
            evals[ep] = res.n_evals
            ep += 1
            if res.n_evals < spec.early_stop_evals:
                break
        with torch.no_grad():
            _, parts = loss_fn(x)
        metrics[max(ep - 1, 0)] = _metrics_row(parts)
        return snapshots, metrics, evals, ep

    def optimize(self, phi_c, phi_s, epochs: int | None = None, x0=None):
        """Run the optimization; returns a host-side results dict."""
        epochs = epochs or self.spec.epochs
        snapshots, metrics, evals, ep_done = self._run_epochs(
            self._start(x0), self._tensor(phi_c), self._tensor(phi_s), epochs)
        return {
            "snapshots": snapshots[:ep_done],
            "metrics": metrics[:ep_done],
            "evals": evals[:ep_done],
            "epochs_done": ep_done,
            "x": snapshots[max(ep_done - 1, 0)][None, :],
        }

    def _start(self, x0) -> torch.Tensor:
        """The initial waveform [1, T]: ``x0``, or zeros + 1e-6 (methods.py:49-54)."""
        if x0 is None:
            x0 = np.full((1, self.spec.batch_size), 1e-6, np.float32)
        return self._tensor(x0)

    def optimize_batch(self, phi_c, phi_s, epochs: int | None = None, x0=None, mesh=None):
        """Transfer K clips with shared encoder weights.

        Args: phi_c [K, T, C], phi_s [K, ...gram...] (arrays, or tensors that
        stay on their device), optional x0 [K, 1, T].

        The clips run one after another through the single-clip epoch loop,
        each with exact single-run semantics (its own early stop). Returns
        ``snapshots`` [K, epochs, T], ``metrics`` [K, epochs, 4], ``evals``
        [K, epochs] (rows past a clip's ``epochs_done`` are zero),
        ``epochs_done`` [K] and ``x`` [K, 1, T], each clip's last iterate.

        With ``mesh`` (a 1-D ``parallel.make_mesh`` whose device is the
        engine's), rank r of n runs clips ``[r K/n, (r+1) K/n)`` (K must be a
        multiple of n), with no communication until the results are gathered:
        every rank returns the dict above for all K clips, equal to
        ``mesh=None``'s. This is JAX's ``lax.map`` inside ``shard_map``.
        """
        epochs = epochs or self.spec.epochs
        clips = range(len(phi_c))
        if mesh is not None:
            n = mesh.size(0)
            if len(phi_c) % n:
                raise ValueError(f"{len(phi_c)} clips do not split over the {n} ranks of the mesh")
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for an engine on {self.device}")
            per = len(phi_c) // n
            clips = range(mesh.get_local_rank(0) * per, (mesh.get_local_rank(0) + 1) * per)
        outs = [
            self._run_epochs(self._start(None if x0 is None else x0[i]),
                             self._tensor(phi_c[i]), self._tensor(phi_s[i]), epochs)
            for i in clips
        ]
        snapshots = np.stack([o[0] for o in outs])
        metrics = np.stack([o[1] for o in outs])
        evals = np.stack([o[2] for o in outs])
        ep_done = np.asarray([o[3] for o in outs], np.int32)
        if mesh is not None:
            snapshots, metrics, evals, ep_done = (
                gather_rows(mesh, a) for a in (snapshots, metrics, evals, ep_done))
        return {
            "snapshots": snapshots,
            "metrics": metrics,
            "evals": evals,
            "epochs_done": ep_done,
            "x": np.stack([snapshots[i, max(int(e) - 1, 0)]
                           for i, e in enumerate(ep_done)])[:, None, :],
        }

    # ------------------------------------------------------------------ #
    # Full run with file IO (reference methods.py:183-216)
    # ------------------------------------------------------------------ #

    def run(self, cont_file: str, source: str, target: str, epochs: int | None = None,
            audio_channel: int = 0, start: float = 1.0) -> np.ndarray:
        spec = self.spec
        late = spec.late
        t0 = time.time()
        if spec.write_artifacts:
            os.makedirs(spec.savepath, exist_ok=True)
            os.makedirs(spec.figdir, exist_ok=True)

        style_audio_full, _ = load_audio(target, sr=spec.sr, audio_channel=audio_channel)
        source_audio_full, _ = load_audio(source, sr=spec.sr, audio_channel=audio_channel)
        aud, _ = load_audio(cont_file, sr=spec.sr, audio_channel=audio_channel)
        st = max(int(start * spec.sr - late), 0)
        if st + spec.batch_size > len(aud):
            raise ValueError(
                f"content window [{st}, {st + spec.batch_size}) exceeds the "
                f"{len(aud)}-sample clip; lower --start or --batch_size")
        aud = aud[st : st + spec.batch_size]

        if spec.write_artifacts:
            from audio_style_transfer_tpu_torch.analysis.spectrogram import plotstft

            savep = os.path.join(spec.savepath, "ori.wav")
            write_wav(savep, aud[late:-late], sr=spec.sr)
            plotstft(savep, plotpath=os.path.join(spec.figdir, "ori-spec.png"))
            style_aud = style_audio_full[st : st + spec.batch_size]
            saves = os.path.join(spec.savepath, "style.wav")
            write_wav(saves, style_aud[late:-late], sr=spec.sr)
            plotstft(saves, plotpath=os.path.join(spec.figdir, "style-spec.png"))

        with span("transfer.targets"):
            phi_t = self.get_style_phi(style_audio_full, show_mat=spec.write_artifacts,
                                       figdir=spec.figdir)
            phi_s = self.get_style_phi(source_audio_full)
            phi_c = self.get_embeds(aud)
            phi = self.get_embeds(aud, is_content=False)
            if spec.write_artifacts:
                from audio_style_transfer_tpu_torch.analysis.viz import show_gram

                show_gram(phi, ep=0, figdir=spec.figdir, gatys=spec.gatys)

            # The gram-translation trick (methods.py:211-212).
            phi = l2_normalize(torch.as_tensor(phi + phi_t - phi_s), axes=(1, 2)).numpy()

        result = self.optimize(phi_c, phi, epochs=epochs)
        for ep in range(result["epochs_done"]):
            loss_, cnt_, stl_, reg_ = result["metrics"][ep]
            print(f"Ep {ep + 1}/{epochs or spec.epochs} - evals "
                  f"{result['evals'][ep]} - loss {loss_:.4f} - content "
                  f"{cnt_:.4f} - style {stl_:.4f} - regularizer {reg_:.4f}")
        print(f"optimized {result['epochs_done']} epochs in {time.time() - t0:.2f}s; "
              f"final loss {result['metrics'][-1, 0]:.4f}")
        if spec.write_artifacts:
            self._write_metrics(result)
            self._write_epoch_artifacts(result)
        return inv_mu_law_numpy(result["x"])[0]

    def _write_metrics(self, result) -> None:
        """Per-epoch scalars as JSONL (the JAX MetricsLogger format)."""
        os.makedirs(self.spec.logdir, exist_ok=True)
        with open(os.path.join(self.spec.logdir, "metrics.jsonl"), "a") as f:
            for ep in range(result["epochs_done"]):
                loss_, cnt_, stl_, reg_ = (float(v) for v in result["metrics"][ep])
                f.write(json.dumps({"step": ep, "main_loss": loss_, "content_loss": cnt_,
                                    "style_loss": stl_, "regularizer": reg_}) + "\n")

    def _write_epoch_artifacts(self, result) -> None:
        """Per-epoch wav/gram/spectrogram files (methods.py:169-179)."""
        from audio_style_transfer_tpu_torch.analysis.spectrogram import plotstft
        from audio_style_transfer_tpu_torch.analysis.viz import show_gram

        spec = self.spec
        late = spec.late
        for ep in range(result["epochs_done"]):
            audio = inv_mu_law_numpy(result["snapshots"][ep])[late:-late]
            sp = os.path.join(spec.savepath, f"ep-{ep}.wav")
            write_wav(sp, audio / np.max(audio), sr=spec.sr)
            # The reference evaluates embeds_s on the raw variable value
            # (already in quantized space), not re-mu-lawed (methods.py:177).
            _, grams = self._embeds(self._tensor(result["snapshots"][ep][None, :]))
            show_gram(grams, ep + 1, spec.figdir, gatys=spec.gatys)
            plotstft(sp, plotpath=os.path.join(spec.figdir, f"ep_{ep + 1}_spectro.png"))
