"""Composed reference-numerics parity: TF loss + SciPy L-BFGS-B end to end
(counterpart of audio_style_transfer_tpu/transfer/composed_parity.py).

This module composes the reference's ACTUAL stack, a TensorFlow-built
transfer loss (graph built from tf.nn ops exactly as reference
methods.py:44-77,113-131, gradients by TF autodiff) minimized by genuine
``scipy.optimize.minimize(L-BFGS-B)`` with per-epoch cold restarts and the
``< 50 evals`` early stop (reference methods.py:133-181), and runs the
port's engine (``StyleTransfer``) on the identical clips and weights. Both
stacks build their own targets from the same audio (chunked style-phi
averaging + gram translation, methods.py:97-111,211-212), so the comparison
covers the full pipeline, not just the optimizer or just the encoder.

The TF oracle reads the float32 weights as numpy arrays; the port's side runs
on ``device`` (the card by default; its trunk kernels take width 128 alone,
so the toy geometry runs on the CPU). TensorFlow is imported inside
``run_composed``: without it the call raises ImportError.

Reported per seed:

* ``ours`` / ``composed``: each stack's final loss under its own metric;
* ``rel``: (ours - composed)/composed, the north-star "within 1%" number;
* ``tf_at_ours`` / ``tf_at_composed``: the TF loss evaluated at both final
  iterates, a cross-check that the two optimizers found equally good
  minima of the SAME function (trajectories may differ step-for-step;
  minima quality must not);
* per-epoch loss/eval trajectories.

Run (toy geometry, CPU):

    python -m audio_style_transfer_tpu_torch.transfer.composed_parity --toy --device cpu

Full geometry (the port's side on the card, TF on the host CPU; slow: the TF
encoder fwd+bwd at T=16384/width 128 is seconds per evaluation):

    python -m audio_style_transfer_tpu_torch.transfer.composed_parity \
        --epochs 4 --maxiter 50

Exit code 0 iff every seed's final iterate is at most tol (default 1%) worse
than the composed reference's under both stacks' metrics.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from audio_style_transfer_tpu_torch.signal.mu_law import mu_law_numpy

# --------------------------------------------------------------------- #
# TF oracle: encoder, targets, loss (reference methods.py + model.py)
# --------------------------------------------------------------------- #


def _tf_conv(tf, params, h, name, dilation=1):
    """Reference masked.conv1d non-causal semantics (masked.py:110-160).
    ``params`` holds numpy arrays."""
    w = tf.constant(np.asarray(params[name]["w"]), tf.float32)
    b = tf.constant(np.asarray(params[name]["b"]), tf.float32)
    return tf.nn.conv1d(h, w, stride=1, padding="SAME", dilations=dilation) + b


def tf_encoder_extracts(tf, params, x, cfg):
    """Tapped non-causal encoder oracle (reference model.py:88-128).

    ``x`` is a [1, T] float tensor in mu-law-quantized space (the
    reference's 'quantized_wav' input, model.py:80).  Differentiable.
    """
    h = x[:, :, None] / 128.0
    enc = _tf_conv(tf, params, h, "ae_startconv")
    extracts = []
    for k in range(1, cfg.ae_num_layers + 1):
        d = tf.nn.relu(enc)
        d = _tf_conv(tf, params, d, f"ae_dilatedconv_{k}",
                     dilation=cfg.ae_dilation(k - 1))
        d = tf.nn.relu(d)
        d = _tf_conv(tf, params, d, f"ae_res_{k}")
        enc = enc + d
        extracts.append(enc)
    extracts.append(enc)  # enc_ alias tap (model.py:118-119)
    extracts.append(_tf_conv(tf, params, enc, "ae_bottleneck"))
    return extracts


def tf_targets(tf, extracts, spec):
    """(content embed, normalized style gram) exactly as methods.py:58-76."""
    cont = tf.concat(
        [extracts[i][:, :, : spec.cnt_channels] for i in spec.cont_lyr_ids],
        axis=2,
    )[0]
    stl = tf.concat([extracts[i] for i in spec.style_layer_ids], axis=0)
    if spec.gatys:
        stl = tf.transpose(stl, perm=[0, 2, 1])  # [L, C, T]
    else:
        stl = tf.transpose(stl, perm=[2, 0, 1])  # [C, L, T]
    g = tf.linalg.matmul(stl, tf.transpose(stl, perm=[0, 2, 1]))
    g = tf.math.l2_normalize(g, axis=(1, 2))
    if spec.nb_channels < g.shape[0] and not spec.gatys:
        g = g[: spec.nb_channels]
    return cont, g


def _tf_safe_abs(tf, x, eps=1e-12):
    """Gradient-safe |x| (reference utils.py:92-93)."""
    return tf.maximum(x, eps) + tf.maximum(0.0, -x)


def _tf_safe_sign(tf, x, eps=1e-12):
    out = tf.where(tf.abs(x) <= eps, tf.zeros_like(x), x)
    return out / _tf_safe_abs(tf, x, eps)


def _tf_inv_mu_law(tf, x, mu=255.0):
    """Gradient-safe inverse mu-law (reference utils.py:99-104)."""
    out = (x + 0.5) * 2.0 / (mu + 1.0)
    out = _tf_safe_sign(tf, out) / mu * ((1.0 + mu) ** _tf_safe_abs(tf, out) - 1.0)
    return tf.where(tf.equal(x, 0.0), x, out)


class TFComposedReference:
    """The reference composition: TF loss/grad + SciPy L-BFGS-B epochs.
    ``params`` are the float32 weights as numpy arrays."""

    def __init__(self, tf, params, cfg, spec, batch_size: int):
        self.tf = tf
        self.params = params
        self.cfg = cfg
        self.spec = spec
        self.batch_size = batch_size
        self._vg = None

    # -- target construction (mirrors engine.get_embeds/get_style_phi) --

    def embeds(self, aud, is_content=True):
        tf = self.tf
        xq = tf.constant(
            mu_law_numpy(np.asarray(aud)[None, : self.batch_size]), tf.float32
        )
        extracts = tf_encoder_extracts(tf, self.params, xq, self.cfg)
        c, g = tf_targets(tf, extracts, self.spec)
        return (c if is_content else g).numpy()

    def style_phi(self, audio, max_examples=5):
        bs = self.batch_size
        n = max(min(len(audio), max_examples * bs) // bs, 1)
        grams = [
            self.embeds(audio[i * bs : (i + 1) * bs], is_content=False)
            for i in range(n)
        ]
        return np.mean(grams, axis=0)

    # -- the optimized loss --------------------------------------------

    def build_loss(self, phi_c, phi):
        """tf.function value-and-grad of the transfer loss wrt x."""
        tf = self.tf
        spec = self.spec
        phi_c = tf.constant(phi_c, tf.float32)
        phi = tf.constant(phi, tf.float32)

        @tf.function
        def vg(x):
            with tf.GradientTape() as tape:
                tape.watch(x)
                extracts = tf_encoder_extracts(tf, self.params, x, self.cfg)
                c, g = tf_targets(tf, extracts, spec)
                content = tf.reduce_mean(tf.square(c - phi_c)) * 10.0
                style = tf.reduce_mean(tf.square(g - phi)) * 1e3
                loss = content + spec.lambd * style
                if spec.gamma != 0.0:
                    # STFT L1 regularizer (reference methods.py:122-123):
                    # tf.signal.stft == the old contrib op (periodic Hann,
                    # no padding), on the gradient-safe inverse mu-law.
                    a = _tf_inv_mu_law(tf, x[0])
                    s = tf.signal.stft(a, frame_length=1024, frame_step=512)
                    reg = tf.reduce_mean(
                        _tf_safe_abs(tf, tf.math.real(s))
                        + _tf_safe_abs(tf, tf.math.imag(s))
                    )
                    loss = loss + spec.gamma * reg
            return loss, tape.gradient(loss, x)

        self._vg = vg
        return vg

    def loss_grad_np(self, x64):
        """SciPy-facing callable: f64 flat iterate -> (f, g) in f64."""
        tf = self.tf
        x = tf.constant(
            np.asarray(x64, np.float32).reshape(1, self.batch_size)
        )
        v, g = self._vg(x)
        return float(v.numpy()), np.asarray(g.numpy(), np.float64).reshape(-1)

    def run(self, epochs: int, maxiter: int, early_stop_evals: int = 50):
        """Per-epoch SciPy L-BFGS-B restarts (reference methods.py:140-181)."""
        import scipy.optimize

        x = np.full(self.batch_size, 1e-6)
        losses, evals = [], []
        for _ in range(epochs):
            res = scipy.optimize.minimize(
                self.loss_grad_np, x, jac=True, method="L-BFGS-B",
                options={"maxiter": maxiter},
            )
            x = res.x
            losses.append(float(res.fun))
            evals.append(int(res.nfev))
            if res.nfev < early_stop_evals:  # methods.py:180-181
                break
        return {
            "x": np.asarray(x, np.float32),
            "losses": losses,
            "evals": evals,
            "final_loss": losses[-1],
        }


# --------------------------------------------------------------------- #
# The composed comparison
# --------------------------------------------------------------------- #


def _tone(seed: int, n: int) -> np.ndarray:
    r = np.random.RandomState(seed)
    tt = np.arange(n) / 16000.0
    a = sum(
        r.uniform(0.1, 0.4)
        * np.sin(2 * np.pi * r.uniform(100, 400) * (h + 1) * tt + r.uniform(0, 6))
        for h in range(4)
    )
    a = 0.8 * a / np.max(np.abs(a)) + 0.05 * r.randn(n)
    return np.clip(a, -1, 1)


def _noise(seed: int, n: int) -> np.ndarray:
    """Uniform-noise clip: a *stable* toy optimization landscape.

    At toy geometry, harmonic tones make the transfer loss chaotic near the
    1e-6 init: an f32 plateau where sum-order noise between two
    implementations decides whether a trajectory escapes, so final losses
    diverge wildly between two correct implementations. Broadband noise
    targets (plus the gamma STFT regularizer) give a single well-conditioned
    basin.
    """
    return np.random.RandomState(seed).uniform(-0.8, 0.8, n)


def run_composed(
    t: int = 16384,
    epochs: int = 4,
    maxiter: int = 50,
    seeds: int = 1,
    toy: bool = False,
    fused: bool = False,
    early_stop_evals: int | None = None,
    device: str = "cuda",
) -> list[dict]:
    import tensorflow as tf
    import torch

    from audio_style_transfer_tpu_torch.models.wavenet_ae import WaveNetAEConfig, init_params
    from audio_style_transfer_tpu_torch.transfer.engine import StyleTransfer, TransferSpec
    from audio_style_transfer_tpu_torch.transfer.grams import l2_normalize
    from audio_style_transfer_tpu_torch.transfer.losses import transfer_loss

    if toy:
        cfg = WaveNetAEConfig(
            num_layers=2, num_stages=2, width=8, skip_width=8,
            ae_num_layers=4, ae_num_stages=2, ae_width=8,
            ae_hop_length=64, ae_bottleneck_width=4,
        )
        t = min(t, 4096)
        spec = TransferSpec(
            batch_size=t, stack=None, style_lyr_ids=(0, 1, 2, 3),
            cont_lyr_ids=(3,), nb_channels=8, cnt_channels=8,
            epochs=epochs, maxiter=maxiter, lambd=10.0, gamma=0.01,
            write_artifacts=False, device=device,
        )
    else:
        cfg = WaveNetAEConfig()
        spec = TransferSpec(
            batch_size=t, stack=0, cont_lyr_ids=(29,),
            epochs=epochs, maxiter=maxiter, lambd=100.0, gamma=0.0,
            fused_encoder=fused, write_artifacts=False, device=device,
        )
    if early_stop_evals is not None:
        import dataclasses as _dc

        spec = _dc.replace(spec, early_stop_evals=early_stop_evals)
    params = init_params(7 if not toy else 42, cfg)
    # The oracle's weights: float32 numpy copies (the engine keeps its own,
    # cast to its compute dtype on its device).
    params_np = {layer: {k: v.detach().cpu().numpy() for k, v in e.items()}
                 for layer, e in params.items()}

    out = []
    clip = _noise if toy else _tone
    for seed in range(seeds):
        content = clip(2 * seed, 2 * t)
        style = clip(2 * seed + 1, 2 * t)
        window = content[:t]

        # --- our stack: engine targets + the eager epoch loop ----------
        engine = StyleTransfer(spec, params, model_cfg=cfg)
        phi_t = engine.get_style_phi(style)
        phi_s = engine.get_style_phi(content)
        phi_c = engine.get_embeds(window)
        phi = engine.get_embeds(window, is_content=False)
        phi = l2_normalize(torch.from_numpy(phi + phi_t - phi_s), axes=(1, 2)).numpy()
        ours = engine.optimize(phi_c, phi, epochs=epochs)
        ours_final = float(ours["metrics"][-1, 0])

        # --- the reference composition: TF loss + SciPy L-BFGS-B -------
        ref = TFComposedReference(tf, params_np, cfg, engine.loss_spec, t)
        phi_t_tf = ref.style_phi(style)
        phi_s_tf = ref.style_phi(content)
        phi_c_tf = ref.embeds(window)
        phi_tf = ref.embeds(window, is_content=False) + phi_t_tf - phi_s_tf
        phi_tf = phi_tf / np.sqrt(
            np.maximum(np.sum(np.square(phi_tf), axis=(1, 2), keepdims=True),
                       1e-12)
        )
        vg = ref.build_loss(phi_c_tf, phi_tf)
        composed = ref.run(epochs=epochs, maxiter=maxiter,
                           early_stop_evals=spec.early_stop_evals)

        # --- cross-evaluation under BOTH metrics ------------------------
        # Each stack builds its own targets from the same audio, so the two
        # loss surfaces differ by the stacks' f32 target noise; comparing
        # each stack's own final loss (rel) conflates that metric offset
        # with optimizer quality.  Evaluating BOTH final iterates under
        # BOTH metrics separates the two: cross_rel / ours_cross_rel
        # compare minima quality on a single fixed surface.
        x_ours = np.asarray(ours["x"], np.float32).reshape(1, t)
        tf_at_ours = float(vg(tf.constant(x_ours))[0].numpy())
        tf_at_composed = float(
            vg(tf.constant(composed["x"].reshape(1, t)))[0].numpy()
        )
        with torch.no_grad():
            ours_at_composed = float(transfer_loss(
                engine.params, engine._tensor(composed["x"].reshape(1, t)),
                engine._tensor(phi_c), engine._tensor(phi), engine.cfg,
                engine.loss_spec)[0])

        out.append({
            "seed": seed,
            "t": t,
            "toy": toy,
            "epochs": epochs,
            "maxiter": maxiter,
            "ours": ours_final,
            "ours_epochs": int(ours["epochs_done"]),
            "ours_evals": [int(v) for v in ours["evals"]],
            "ours_trajectory": [round(float(v), 4) for v in ours["metrics"][:, 0]],
            "composed": composed["final_loss"],
            "composed_epochs": len(composed["losses"]),
            "composed_evals": composed["evals"],
            "composed_trajectory": [round(v, 4) for v in composed["losses"]],
            "rel": (ours_final - composed["final_loss"]) / abs(composed["final_loss"]),
            "tf_at_ours": tf_at_ours,
            "tf_at_composed": tf_at_composed,
            "cross_rel": (tf_at_ours - tf_at_composed) / abs(tf_at_composed),
            "ours_at_composed": ours_at_composed,
            "ours_cross_rel": (ours_final - ours_at_composed) / abs(ours_at_composed),
        })
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--t", type=int, default=16384)
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--maxiter", type=int, default=50)
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--tol", type=float, default=0.01)
    p.add_argument("--toy", action="store_true",
                   help="toy geometry (width 8: the CPU only)")
    p.add_argument("--fused", action="store_true",
                   help="fused_encoder=True on our side (the chained trunk)")
    p.add_argument("--early_stop", type=int, default=None,
                   help="override the <50-eval epoch early stop on BOTH "
                   "stacks (0 = fixed work: run the full epoch budget)")
    p.add_argument("--device", default="cuda", help="torch device of our side")
    args = p.parse_args(argv)

    records = run_composed(t=args.t, epochs=args.epochs, maxiter=args.maxiter,
                           seeds=args.seeds, toy=args.toy, fused=args.fused,
                           early_stop_evals=args.early_stop, device=args.device)
    ok = True
    for r in records:
        print(json.dumps(r))
        # One-sided: our final iterate may not be more than tol WORSE than
        # the composed reference's, judged on a single fixed loss surface:
        # the reference's TF metric (cross_rel) AND our metric
        # (ours_cross_rel).  Landing lower (ours found a better basin of
        # the same function) is a pass: the north star is "matches or
        # beats", and on a nonconvex landscape two correct optimizers need
        # not share a minimum.  The own-metric diff (rel) is reported but
        # not gated: it additionally carries the two stacks' independent
        # f32 target-construction noise.
        if r["cross_rel"] > args.tol or r["ours_cross_rel"] > args.tol:
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
