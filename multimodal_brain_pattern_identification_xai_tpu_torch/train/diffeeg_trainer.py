"""DiffEEG diffusion trainer (counterpart of the JAX package's
``train/diffeeg_trainer.py``).

At least ``min_steps`` optimizer steps, each over K =
``gradient_accumulate_every`` micro-batches: STFT conditioning → same-class
spectrogram mixup → t ~ U{0..T−1} → q-sample with the cosine ᾱ → ε̂ → MSE,
the gradients averaged over K; Adam; the EMA of the parameters (warm-up,
then every N steps); step checkpoints; a generative evaluation with the
EMA weights (reverse diffusion on a validation slice, then MMD, Fréchet
and Pearson).

The conditioner runs on the device beside the denoiser.  The NaN sentinel
decides on the device, as in :mod:`.steps`: a non-finite loss or gradient
norm keeps the parameters, the optimizer state and the EMA bitwise, and
the step counter still advances.  A step's draws (mixup scores, t, noise,
dropout masks) come from a device generator folded from the trainer's
seed and the step (:func:`.steps.fold_in`), so a resumed run repeats the
uninterrupted one bitwise; :meth:`DiffEEGTrainer.train_step` also takes
the draws themselves (how tests feed the JAX step's draws in).

With ``mesh`` (a ``DeviceMesh`` of ``parallel.make_mesh``; every rank
builds its own trainer on the same stream) the step is data parallel:
each rank takes its part of the micro-batches' sample axis (axis 1 of the
stacked (K, B, ...) batch; B must divide over the ``data`` axis), and the
K-averaged gradients and loss are averaged over ``data`` before the
sentinel, the optimizer and the EMA.  ``decorrelate_shards`` folds the
rank's ``data`` index into the step's generator, so ranks draw different
noise, steps, mixup scores and dropout masks (DDP's ranks); without it
every rank draws the single-device stream on its own samples, and a run
on a batch tiled across the ranks repeats the single-device trajectory.
Rank 0 alone writes checkpoints and logs.
"""

from __future__ import annotations

import contextlib
import copy
import inspect
import logging
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
import torch.utils.checkpoint

from .. import config as C
from ..diffusion import (EMA, compute_frechet_distance, compute_mmd,
                         ema_update, make_schedule, pearson_correlation,
                         q_sample, reverse_diffusion)
from ..models.diffeeg import (DiffEEG, make_cached_denoiser,
                              recombine_spectrograms)
from ..models.layers import dropout_generator
from ..ops.stft import stft_log1p_interp
from .checkpoint import CheckpointManager
from .state import (assign_flat, apply_gradients, create_train_state, flat,
                    make_optimizer)
from .steps import fold_in, global_norm

logger = logging.getLogger(__name__)

#: one micro-batch's draws: mixup scores (B,), steps t (B,), noise x0-shaped
MicroDraws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
#: the evaluation's generators are folded from the step plus this offset,
#: apart from the training steps' own
EVAL_STREAM = 1 << 40


def _remat_contexts(gen: Optional[torch.Generator]):
    """``torch.utils.checkpoint`` contexts that replay the dropout draws:
    the recompute starts ``gen`` where the forward started it and leaves it
    where it was."""
    if gen is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    start = gen.get_state()

    @contextlib.contextmanager
    def recompute():
        now = gen.get_state()
        gen.set_state(start)
        try:
            yield
        finally:
            gen.set_state(now)
    return contextlib.nullcontext(), recompute()


class DiffEEGTrainer:
    """``model``: a :class:`..models.DiffEEG` with its initial weights (its
    ``dtype`` is the step's compute dtype: bf16 for ``cfg.amp``), moved to
    ``device`` (its own parameters' device when None)."""

    def __init__(self, model: DiffEEG, cfg: C.DiffEEGConfig,
                 ckpt_dir: Optional[str] = None, seed: int = 42,
                 device: Optional[torch.device] = None,
                 mesh: Optional[Any] = None,
                 decorrelate_shards: bool = True) -> None:
        from ..parallel import is_primary
        dev = device or next(model.parameters()).device
        self.mesh = mesh
        self.decorrelate_shards = decorrelate_shards
        self.primary = mesh is None or is_primary()
        self.model = model.to(dev)
        self.cfg = cfg
        self.device = dev
        self.schedule = make_schedule(cfg.n_diffusion_steps, dev)
        self.ckpt = (CheckpointManager(ckpt_dir, "mmd", "min")
                     if ckpt_dir else None)
        if self.ckpt is not None:
            self.ckpt.write = self.primary
        self.state = create_train_state(model, make_optimizer(cfg.lr),
                                        seed=seed, with_ema=True)

    @property
    def ema(self) -> EMA:
        """The EMA of the parameters (flat, in ``parameters()`` order)."""
        cfg = self.cfg
        return EMA(self.state.ema, cfg.ema_decay, cfg.step_start_ema,
                   cfg.update_ema_every)

    def ema_model(self) -> DiffEEG:
        """A copy of the model carrying the EMA weights, in eval mode."""
        m = copy.deepcopy(self.model).eval()
        assign_flat(list(m.parameters()), self.state.ema)
        return m

    # ------------------------------------------------------------------

    def draw(self, gen: torch.Generator, x0: torch.Tensor) -> MicroDraws:
        """One micro-batch's draws from ``gen``: scores ~ U[0, 1), t ~
        U{0..T−1}, noise ~ N(0, 1) of x0's shape."""
        B, dev = x0.shape[0], x0.device
        scores = torch.rand((B,), generator=gen, device=dev)
        t = torch.randint(0, self.cfg.n_diffusion_steps, (B,), generator=gen,
                          device=dev)
        noise = torch.randn(x0.shape, generator=gen, device=dev,
                            dtype=x0.dtype)
        return scores, t, noise

    def micro_loss(self, x0: torch.Tensor, y: torch.Tensor,
                   draws: MicroDraws,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """One accumulation micro-batch's MSE (the model in training mode;
        ``gen`` replays its dropout draws under ``remat``)."""
        cfg = self.cfg
        scores, t, noise = draws
        with torch.no_grad():
            spec = stft_log1p_interp(x0, out_t=x0.shape[-1],
                                     nperseg=cfg.stft_n_fft,
                                     noverlap=cfg.stft_noverlap)
            spec = recombine_spectrograms(scores, spec, y.argmax(-1),
                                          cfg.n_classes)
        x_t, _ = q_sample(self.schedule, noise, x0, t)
        tf = t.to(torch.promote_types(x0.dtype, torch.float32))
        if cfg.remat:
            eps = torch.utils.checkpoint.checkpoint(
                self.model, x_t, y, tf, spec, use_reentrant=False,
                context_fn=lambda: _remat_contexts(gen))
        else:
            eps = self.model(x_t, y, tf, spec)
        return ((eps - noise) ** 2).mean()

    def train_step(self, xs: torch.Tensor, ys: torch.Tensor,
                   draws: Optional[Sequence[MicroDraws]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step over K stacked micro-batches, xs (K, B, C, T)
        and ys (K, B, n_classes) on the device.  ``fuse_accum`` = f folds
        f micro-batches into each forward and backward (K/f passes of f·B).
        ``draws``: one :data:`MicroDraws` a pass, or None to draw them.
        Returns ``loss``, ``grad_norm`` and ``nonfinite`` as 0-d device
        tensors; the state is updated in place."""
        f = self.cfg.fuse_accum
        if self.mesh is not None:
            from ..parallel.mesh import axis_index, axis_size, data_slice
            n = axis_size(self.mesh, "data")
            sl = data_slice(self.mesh, xs.shape[1], "micro-batch")
            xs, ys = xs[:, sl], ys[:, sl]
        if xs.shape[0] % f:
            raise ValueError(
                f"fuse_accum={f} must divide the number of accumulation "
                f"micro-batches {xs.shape[0]}")
        xs = xs.reshape((xs.shape[0] // f, f * xs.shape[1]) + xs.shape[2:])
        ys = ys.reshape((ys.shape[0] // f, f * ys.shape[1]) + ys.shape[2:])
        K = xs.shape[0]
        state, model = self.state, self.model
        gen = fold_in(state.rng, state.step, xs.device)
        if self.mesh is not None and self.decorrelate_shards:
            gen = fold_in(gen, axis_index(self.mesh, "data"), xs.device)
        params = list(model.parameters())
        model.train()
        gsum: List[torch.Tensor] = []
        lsum = torch.zeros((), device=xs.device)
        with dropout_generator(model, gen):
            for k in range(K):
                d = self.draw(gen, xs[k]) if draws is None else draws[k]
                loss = self.micro_loss(xs[k], ys[k], d, gen)
                g = torch.autograd.grad(loss, params)
                gsum = list(g) if not gsum else [a + b for a, b in zip(gsum, g)]
                lsum = lsum + loss.detach()
        grads = [g / K for g in gsum]
        loss = lsum / K
        if self.mesh is not None:
            # one all-reduce of [loss, gradients] over the data axis
            vec = torch.cat([loss.reshape(1).float(), flat(grads).float()])
            dist.all_reduce(vec, group=self.mesh.get_group("data"))
            vec = vec / n
            loss, off = vec[0].to(loss.dtype), 1
            for j, g in enumerate(grads):
                grads[j] = vec[off:off + g.numel()].view_as(g).to(g.dtype)
                off += g.numel()
        grad_norm = global_norm(grads)
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        apply_gradients(state, grads, finite)
        state.step += 1
        new_ema = ema_update(self.ema, flat([p.detach() for p in params]),
                             state.step).params
        state.ema = torch.where(finite, new_ema, state.ema)
        return {"loss": loss, "grad_norm": grad_norm, "nonfinite": ~finite}

    # ------------------------------------------------------------------

    def load(self, step: Optional[int] = None) -> Optional[int]:
        """Resume from the latest (or the given) step checkpoint: the
        model, optimizer state, step, EMA and generator state.  A
        checkpoint without the generator's state resumes with the current
        one (a warning).  Returns the step restored, or None."""
        if self.ckpt is None:
            return None
        step = step if step is not None else self.ckpt.latest_step()
        if step is None:
            return None
        d = self.ckpt.load(f"step_{step}")
        if "rng" not in d:
            logger.warning("checkpoint step_%d holds no generator state; "
                           "resuming with the current one", step)
            d = {**d, "rng": self.state.rng.get_state()}
        self.state.load_state_dict(d)
        if self.primary:
            logger.info("resumed DiffEEG trainer at step %d", step)
        return step

    def train(self, batch_iter_factory: Callable[..., Iterator],
              val_batches: Optional[list] = None,
              total_steps: Optional[int] = None) -> Dict[str, list]:
        """The step loop up to ``total_steps`` (default ``min_steps``).

        ``batch_iter_factory`` yields ``(x0, y)`` numpy micro-batches and
        is called again when its iterator is exhausted; a factory that
        takes an argument is called with the number of micro-batches
        already consumed (``state.step × K``) so a resumed run continues
        the stream where the interrupted one stopped.  Each micro-batch is
        copied to the device as it is drawn.  Returns ``{"loss": [...],
        "eval": [...]}`` (floats)."""
        cfg = self.cfg
        total = total_steps or cfg.min_steps
        K = cfg.gradient_accumulate_every
        try:
            takes_start = bool(
                inspect.signature(batch_iter_factory).parameters)
        except (TypeError, ValueError):
            takes_start = False
        it = (batch_iter_factory(self.state.step * K) if takes_start
              else batch_iter_factory())
        losses: List[torch.Tensor] = []
        history: Dict[str, list] = {"loss": [], "eval": []}

        def next_micro():
            nonlocal it
            try:
                return next(it)
            except StopIteration:
                it = (batch_iter_factory(0) if takes_start
                      else batch_iter_factory())
                return next(it)

        dev = self.device
        for step in range(self.state.step, total):
            micros = [tuple(torch.as_tensor(a).to(dev) for a in next_micro())
                      for _ in range(K)]
            xs = torch.stack([m[0] for m in micros])
            ys = torch.stack([m[1] for m in micros])
            losses.append(self.train_step(xs, ys)["loss"])
            if self.ckpt and (step + 1) % cfg.save_and_sample_every == 0:
                self.ckpt.save_step(step + 1, self.state)
            if val_batches and (step + 1) % cfg.evaluate_every == 0:
                history["eval"].append(self.evaluate(val_batches))
        history["loss"] = [float(v) for v in losses]
        return history

    @torch.no_grad()
    def evaluate(self, val_batches: list, frac: float = 0.2
                 ) -> Dict[str, float]:
        """Generative evaluation with the EMA weights on the first ``frac``
        of ``val_batches`` (at least one): the full reverse diffusion
        conditioned on the real labels and spectrograms, then MMD, Fréchet
        and Pearson against the real EEG, averaged."""
        cfg = self.cfg
        n = max(1, int(len(val_batches) * frac))
        model = self.ema_model()
        gen = fold_in(self.state.rng, EVAL_STREAM + self.state.step,
                      self.device)
        scores: Dict[str, list] = {"mmd": [], "frechet": [], "pearson": []}
        for x0, y in val_batches[:n]:
            x0 = torch.as_tensor(x0).to(self.device)
            y = torch.as_tensor(y).to(self.device)
            spec = stft_log1p_interp(x0, out_t=x0.shape[-1],
                                     nperseg=cfg.stft_n_fft,
                                     noverlap=cfg.stft_noverlap)
            den = make_cached_denoiser(model, y, spec, x0.shape[-1])
            gen_x = reverse_diffusion(self.schedule, den, gen, x0.shape[0],
                                      y, spec, (cfg.n_channels, x0.shape[-1]))
            scores["mmd"].append(float(compute_mmd(x0, gen_x)))
            scores["frechet"].append(float(compute_frechet_distance(x0, gen_x)))
            scores["pearson"].append(float(pearson_correlation(x0, gen_x)))
        result = {k: float(np.mean(v)) for k, v in scores.items()}
        if self.primary:
            logger.info("DiffEEG eval: %s", result)
        return result
