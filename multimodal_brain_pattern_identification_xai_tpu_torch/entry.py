"""Serving entry point: raw EEG + raw spectrogram → log-probs.

Counterpart of ``__graft_entry__.entry()``: preprocessing of both branches
then the late-fusion ``MultimodalModel(EEGNetAttentionRegularized,
SpectrogramCNN)``, with the EEGNet stem reassociated for inference and the
first two spectrogram blocks served through the fused conv×3+pool kernel.
``serving_dtype=torch.bfloat16`` selects the bf16 program of the JAX
bench's ``--multimodal`` mode, and ``signal=config.SPEC_RES_PRESET`` its
reduced-resolution preset (``BENCH_SPEC_RES=200x150``): the same weights
on spectrograms anti-alias-resized to 200×150.  :func:`capture_forward` turns a forward
into one captured CUDA graph (the counterpart of ``jax.jit``).
:func:`explain_entry` gives the same model and preprocessed inputs ready
for attribution (``xai``), float32 and eager.  :func:`train_entry` is the
JAX bench's training program (one step: preprocess, forward, loss,
backward, Adam) and :func:`train_multimodal` the JAX CLI's
``train-multimodal`` loop, on its ``--demo`` arrays or, with
``data_root``, on an HMS dataset tree (``init_from``: the branch
checkpoints of :func:`train_branch`, the JAX CLI's ``train-eeg`` /
``train-spectrogram``, grafted in first; ``lime_every``: the per-epoch
LIME snapshots).  :func:`train_wavenet` and :func:`grid_search` are the
JAX CLI's ``train-wavenet`` (cross-validated ``DilatedInceptionWaveNet``)
and ``grid-search`` on such a tree or on given arrays.
:func:`train_diffeeg` and :func:`generate` are the JAX CLI's
``train-diffeeg`` and ``generate``, :func:`sanity_check` its
``sanity-check``.  The command line (``cli``) wraps them all.  Runs on
CUDA unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import config as C
from . import profiling, resolve_device
from .models import (EEGNetAttentionRegularized, MultimodalModel,
                     SpectrogramCNN, seeded_state_dict)
from .ops import preprocess_multimodal

#: spectrogram blocks served by the fused kernel on the serving path
FUSED_BLOCKS = 2
#: eager calls before a capture: the first builds the kernels and sets
#: their shared-memory attributes, the second runs as the graph will
CAPTURE_WARMUP = 2


def build_model(samples: int = 3000, kern_length: int = 64,
                dtype: Optional[torch.dtype] = None,
                fused_blocks: int = FUSED_BLOCKS) -> MultimodalModel:
    """The serving model in eval mode, on the CPU, default-initialised
    (load weights with ``load_state_dict``): the EEGNet stem reassociated
    for inference, spectrogram blocks 1 to ``fused_blocks`` fused (the
    command line's ``--fused-spec``), and the spectrogram branch in
    ``dtype`` (None: float32; the parameters are float32 either way)."""
    model = MultimodalModel(
        EEGNetAttentionRegularized(samples=samples, kern_length=kern_length,
                                   fused_inference=True),
        SpectrogramCNN(fused_blocks=fused_blocks, dtype=dtype))
    return model.eval()


def make_forward(model: MultimodalModel,
                 signal: C.SignalConfig = C.SignalConfig(),
                 assume_finite: bool = False,
                 serving_dtype: Optional[torch.dtype] = None
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``forward(raw_eeg (B, 20, T), raw_spec (B, H, W)) → (B, 6)``
    log-probs (float32), on the device of the model and inputs.

    ``serving_dtype=torch.bfloat16`` is the bf16 program: the spectrogram
    chain and CNN in bf16 (the model must be built with that ``dtype``),
    and the EEG chain's finite route on bf16-rounded input when
    ``assume_finite``."""
    if model.spectrogram_model.dtype != serving_dtype:
        raise ValueError(
            f"serving_dtype {serving_dtype} needs a spectrogram model built "
            f"with that dtype, got {model.spectrogram_model.dtype}")

    def forward(raw_eeg: torch.Tensor, raw_spec: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            eeg_in, spec_in = preprocess_multimodal(
                raw_eeg, raw_spec, signal=signal, assume_finite=assume_finite,
                serving_dtype=serving_dtype)
            return model(eeg_in, spec_in)
    return forward


def capture_forward(forward: Callable[..., torch.Tensor],
                    example_args: Sequence[torch.Tensor]
                    ) -> Callable[..., torch.Tensor]:
    """The counterpart of ``jax.jit(forward)``: ``forward`` as one captured
    CUDA graph.

    On CUDA it runs ``CAPTURE_WARMUP`` calls on ``example_args`` outside
    the capture (the first builds the kernels with nvcc and sets their
    shared-memory attributes), captures one call in a
    ``torch.cuda.CUDAGraph`` over static copies of the arguments, and
    returns ``replay(*args)``: it copies ``args`` (the example shapes and
    dtypes) into the static buffers, replays the graph and returns a copy
    of the static output.  A failed capture raises; nothing falls back to
    eager.  On the CPU it returns ``forward`` unchanged.

    Tracing (:mod:`.profiling`): the warm-up calls and the capture are the
    ``mbx.setup.capture`` span; the spans that ``forward`` opens record
    their timing events into the graph, and a traced replay's layer times
    become ``graph=True`` spans of its request (read by the next replay
    while its inputs copy, before its launch overwrites them, or by
    ``profiling.collect``).  A request is the span ``mbx.entry.request``
    (counter ``entry.requests``) with the children ``mbx.entry.copy_in``,
    ``mbx.entry.read_layers`` (that read), ``mbx.entry.launch`` and
    ``mbx.entry.copy_out``, all on the host clock."""
    dev = example_args[0].device
    if dev.type != "cuda":
        return forward
    with profiling.span("mbx.setup.capture"):
        static_in = [a.clone() for a in example_args]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(CAPTURE_WARMUP):
                forward(*static_in)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph), profiling.capturing() as spans:
            static_out = forward(*static_in)

    def replay(*args: torch.Tensor) -> torch.Tensor:
        with profiling.span("mbx.entry.request") as req:
            with profiling.span("mbx.entry.copy_in"):
                for buf, a in zip(static_in, args, strict=True):
                    if a.shape != buf.shape or a.dtype != buf.dtype:
                        raise ValueError(
                            f"captured for {tuple(buf.shape)} {buf.dtype}, "
                            f"got {tuple(a.shape)} {a.dtype}")
                    buf.copy_(a)
            with profiling.span("mbx.entry.read_layers"):
                spans.flush()
            with profiling.span("mbx.entry.launch"):
                graph.replay()
            with profiling.span("mbx.entry.copy_out"), \
                    torch.inference_mode():
                out = static_out.clone()
        if req is not None:
            profiling.count("entry.requests")
            if len(spans):
                spans.pending(req.request)
        return out
    return replay


def seeded(device: Optional[Union[str, torch.device]] = None, batch: int = 4,
           seed: int = 0, dtype: Optional[torch.dtype] = None
           ) -> Tuple[MultimodalModel, torch.Tensor, torch.Tensor]:
    """The serving model (spectrogram branch in ``dtype``) with weights
    drawn from ``seed`` on ``device``, and seeded raw inputs: EEG
    (batch, 20, 10000) µV and spectrograms (batch, 400, 300)."""
    dev = resolve_device(device)
    model = build_model(dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, seed))
    model.to(dev)
    rng = np.random.default_rng(seed)
    raw_eeg = torch.as_tensor(rng.standard_normal((batch, 20, 10_000)) * 40,
                              dtype=torch.float32, device=dev)
    raw_spec = torch.as_tensor(rng.standard_normal((batch, 400, 300)) * 5,
                               dtype=torch.float32, device=dev)
    return model, raw_eeg, raw_spec


def entry(device: Optional[Union[str, torch.device]] = None, batch: int = 4,
          assume_finite: bool = False, seed: int = 0,
          serving_dtype: Optional[torch.dtype] = None,
          signal: Optional[C.SignalConfig] = None
          ) -> Tuple[Callable, Tuple[torch.Tensor, torch.Tensor]]:
    """Return ``(forward, (raw_eeg, raw_spec))``: the full-size serving
    forward with weights drawn from ``seed``, and seeded raw inputs —
    EEG (batch, 20, 10000) µV and spectrograms (batch, 400, 300).
    ``assume_finite=False`` (the default, as the JAX entry) runs the
    NaN-bearing EEG route; ``serving_dtype=torch.bfloat16`` the bf16
    program; ``signal`` (default ``SignalConfig()``) sets the spectrogram
    plane the model sees, e.g. the 200×150 ``resize_mode="resample"``
    preset (:func:`make_forward`).  The forward is eager: pass it to
    :func:`capture_forward` for one CUDA graph."""
    model, raw_eeg, raw_spec = seeded(device, batch, seed, serving_dtype)
    return make_forward(model, signal=signal or C.SignalConfig(),
                        assume_finite=assume_finite,
                        serving_dtype=serving_dtype), (raw_eeg, raw_spec)


def explain_entry(device: Optional[Union[str, torch.device]] = None,
                  batch: int = 4, seed: int = 0
                  ) -> Tuple[MultimodalModel, Tuple[torch.Tensor, torch.Tensor]]:
    """Return ``(model, (eeg_in, spec_in))`` for attribution: the serving
    model of :func:`entry` (eval mode, fused blocks 1-2, weights from
    ``seed``) with its parameters frozen — attribution needs only input
    gradients — and the seeded raw inputs preprocessed (under
    ``no_grad``, NaN-safe EEG route): EEG (batch, 1, 37, 3000) and
    spectrograms (batch, 3, 400, 300).  ``make_forward``'s inference mode
    makes tensors that autograd cannot use, so this entry has its own."""
    model, raw_eeg, raw_spec = seeded(device, batch, seed)
    model.requires_grad_(False)
    with torch.no_grad():
        eeg_in, spec_in = preprocess_multimodal(raw_eeg, raw_spec)
    return model, (eeg_in, spec_in)


# ---------------------------------------------------------------------------
# training

def build_train_model(samples: int = 3000, kern_length: int = 64,
                      dtype: Optional[torch.dtype] = None) -> MultimodalModel:
    """The model both training programs build: ``MultimodalModel(
    EEGNetAttentionRegularized(), SpectrogramCNN(dtype=dtype))`` with no
    fused block (training runs the unfused convs), on the CPU, in
    training mode."""
    if dtype == torch.float32:
        dtype = None
    return MultimodalModel(
        EEGNetAttentionRegularized(samples=samples, kern_length=kern_length),
        SpectrogramCNN(dtype=dtype)).train()


def preprocess_batch(raw_eeg: torch.Tensor, raw_spec: torch.Tensor,
                     y: torch.Tensor, signal: C.SignalConfig = C.SignalConfig(),
                     assume_finite: bool = True) -> dict:
    """Both preprocessing chains (float32, no gradients) → a training batch
    ``{"eeg", "spec", "y"}``."""
    with torch.no_grad():
        eeg, spec = preprocess_multimodal(raw_eeg, raw_spec, signal=signal,
                                          assume_finite=assume_finite)
    return {"eeg": eeg, "spec": spec, "y": y}


def train_entry(device: Optional[Union[str, torch.device]] = None,
                batch: int = 256, seed: int = 0,
                dtype: Optional[torch.dtype] = torch.bfloat16,
                assume_finite: bool = True, l2_lambda: float = 1e-3,
                lr: float = 1e-3, n_points: int = 10_000,
                signal: C.SignalConfig = C.SignalConfig()):
    """The training program of the JAX bench's ``--train`` mode: raw
    windows → both preprocessing chains → forward + KLDiv + L2 + backward
    + Adam, on the full-width model (:func:`build_train_model`, the
    spectrogram branch in ``dtype``: bf16 by default, ``None`` or float32
    for the all-float32 program) with Kaiming weights drawn from ``seed``.

    Returns ``(step, state, (raw_eeg, raw_spec, y))`` on ``device`` (cuda
    unless given): ``step(state, raw_eeg, raw_spec, y) -> (state,
    metrics)`` preprocesses under ``no_grad`` and takes one train step
    (:func:`..train.make_train_step`, NaN sentinel on); ``state`` is the
    :class:`..train.TrainState`; the inputs are seeded synthetic raw EEG
    (batch, 20, 10000) µV gathered through ``runtime.gather_windows`` (NaN
    repair) when ``assume_finite``, else with their NaNs (the NaN route),
    raw spectrograms (batch, 400, 300) and soft targets (batch, 6).
    ``n_points`` sets the windows' length and ``signal`` the planes the
    model sees (zero-padded or cropped to its ``image_size``)."""
    from .data import synthetic_raw_eeg, synthetic_raw_spectrogram
    from .runtime import gather_windows
    from .train import (create_train_state, initialize_kaiming_weights,
                        make_optimizer, make_train_step)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    raw_eeg = synthetic_raw_eeg(batch, rng, n_points=n_points)
    if assume_finite:
        raw_eeg = gather_windows(raw_eeg, np.arange(batch, dtype=np.int64))
    raw_spec = synthetic_raw_spectrogram(batch, rng)
    votes = rng.random((batch, 6))
    y = (votes / votes.sum(1, keepdims=True)).astype(np.float32)
    model = build_train_model(dtype=dtype)
    initialize_kaiming_weights(model, torch.Generator().manual_seed(seed))
    state = create_train_state(model.to(dev), make_optimizer(lr), seed=seed)
    inner = make_train_step(l2_lambda=l2_lambda)

    def step(state, raw_eeg, raw_spec, y):
        return inner(state, preprocess_batch(raw_eeg, raw_spec, y, signal,
                                             assume_finite=assume_finite))
    return step, state, tuple(torch.as_tensor(a).to(dev)
                              for a in (raw_eeg, raw_spec, y))


#: the demo data of ``train_multimodal``: rows, raw EEG samples a window,
#: spectrogram plane, and the signal the model sees
DEMO_ROWS, DEMO_POINTS, DEMO_PLANE = 24, 2000, (80, 60)
DEMO_SIGNAL = C.SignalConfig(fixed_length=600, image_size=DEMO_PLANE)


def _paths(data_root: Union[str, C.PathsConfig]) -> C.PathsConfig:
    """A dataset tree's paths: given, or the standard layout under a
    directory."""
    return (data_root if isinstance(data_root, C.PathsConfig)
            else C.PathsConfig.at(data_root))


def multimodal_fold0(data_root: Union[str, C.PathsConfig], ckpt_dir: str,
                     seed: int = 0, n_folds: int = C.N_FOLDS,
                     limit: Optional[int] = None, workers: int = 8,
                     npy_dir: Optional[str] = None):
    """``train-multimodal``'s real data: ``data.multimodal_source`` over
    the tree under ``data_root`` (a directory, or a ``PathsConfig``;
    window cache in ``ckpt_dir``, spectrograms from ``npy_dir`` where
    given) and fold 0 of the stratified ``n_folds`` split on the expert
    consensus.  Returns ``(source, train rows, validation rows)``."""
    from .data import multimodal_source
    from .train import stratified_kfold
    src = multimodal_source(_paths(data_root), cache_dir=ckpt_dir,
                            n_workers=workers, npy_dir=npy_dir, limit=limit)
    labels = np.asarray([C.NAME2LABEL[c]
                         for c in src.meta["expert_consensus"]])
    tr_idx, va_idx = stratified_kfold(labels, n_splits=n_folds, seed=seed)[0]
    return src, tr_idx, va_idx


def _multimodal_data(ckpt_dir: str, dev: torch.device, seed: int,
                     batch_size: Optional[int],
                     data_root: Optional[Union[str, C.PathsConfig]],
                     n_folds: int, limit: Optional[int], workers: int,
                     npy_dir: Optional[str],
                     want: Sequence[str] = ("eeg", "spec"),
                     signal: Optional[C.SignalConfig] = None):
    """The data of ``train-multimodal`` and the branch-pretraining
    commands (the JAX CLI's ``_multimodal_data``): ``(raw_batches,
    signal, finite route, EEGNet kern_length, first_val)``, where
    ``raw_batches(shuffle, epoch=0)`` yields raw batches of the ``want``
    modalities and ``y`` on ``dev``: the training rows shuffled with
    ``seed + epoch`` (whole batches) or the validation rows in order; and
    ``first_val()`` gives the first validation row's raw arrays (a batch
    of one, numpy, both modalities).

    Without ``data_root`` (``--demo``): 24 rows of synthetic raw EEG (20,
    2000) with NaNs and 80×60 spectrogram planes (``data.dummy``), one-hot
    targets, every row in both splits, batches of 8 (or ``batch_size``),
    600-sample windows with a 16-tap temporal kernel, the NaN route.  With
    ``data_root``: fold 0 of :func:`multimodal_fold0`, batches of
    ``TrainerConfig().batch_size`` (256, or ``batch_size``) gathered by
    the host library (``MultimodalSource.batches``; on the card into two
    reused buffers, with synced transfers), ``signal`` (default the
    full-width ``SignalConfig()``) and the finite route (the cache's
    windows are NaN-repaired)."""
    from .data import (batch_iterator, prefetch_to_device, synthetic_raw_eeg,
                       synthetic_raw_spectrogram)

    if data_root is None:
        rng = np.random.default_rng(seed)
        raw_eeg = synthetic_raw_eeg(DEMO_ROWS, rng, n_points=DEMO_POINTS)
        raw_spec = synthetic_raw_spectrogram(DEMO_ROWS, rng, shape=DEMO_PLANE)
        y = np.eye(6, dtype=np.float32)[np.arange(DEMO_ROWS) % 6]
        arrays = {k: v for k, v in (("eeg", raw_eeg), ("spec", raw_spec))
                  if k in want}
        arrays["y"] = y
        bs = batch_size or 8

        def raw_batches(shuffle: bool, epoch: int = 0):
            return prefetch_to_device(
                batch_iterator(arrays, bs, shuffle=shuffle,
                               seed=seed + (epoch if shuffle else 0)),
                device=dev)

        def first_val():
            return {"eeg": raw_eeg[:1], "spec": raw_spec[:1], "y": y[:1]}
        return raw_batches, DEMO_SIGNAL, False, 16, first_val

    src, tr_idx, va_idx = multimodal_fold0(data_root, ckpt_dir, seed,
                                           n_folds, limit, workers, npy_dir)
    bs = batch_size or C.TrainerConfig().batch_size
    # on the card the host gathers into two reused buffers, which the
    # synced transfers make safe; on the CPU a tensor shares its array
    reuse = dev.type == "cuda"

    def raw_batches(shuffle: bool, epoch: int = 0):
        return prefetch_to_device(
            src.batches(tr_idx if shuffle else va_idx, bs, shuffle=shuffle,
                        seed=seed + (epoch if shuffle else 0),
                        drop_last=shuffle, reuse_buffers=reuse, want=want),
            device=dev, sync_transfers=reuse)

    def first_val():
        return src.gather(va_idx[:1])
    return raw_batches, signal or C.SignalConfig(), True, 64, first_val


def train_multimodal(ckpt_dir: str,
                     device: Optional[Union[str, torch.device]] = None,
                     epochs: int = 3, batch_size: Optional[int] = None,
                     seed: int = 0, augment: bool = False,
                     resume: bool = False,
                     dtype: Optional[torch.dtype] = None,
                     epoch_callbacks: Optional[list] = None,
                     data_root: Optional[str] = None,
                     n_folds: int = C.N_FOLDS, limit: Optional[int] = None,
                     workers: int = 8, npy_dir: Optional[str] = None,
                     loggers: Optional[list] = None,
                     init_from: Optional[str] = None,
                     signal: Optional[C.SignalConfig] = None,
                     lime_every: int = 0, mesh=None):
    """The JAX CLI's ``train-multimodal`` loop.

    The data (demo without ``data_root``, else fold 0 of the HMS tree under
    it) are :func:`_multimodal_data`'s, the model on its signal.

    Each train batch (shuffled with ``seed + epoch``, prefetched to the
    device) is mirrored when ``augment``, preprocessed on the device, and
    augmented by ``spectrogram_augment`` against the in-batch pool with
    draws keyed on (``seed + 1``, epoch, batch); then
    ``Trainer.train_eval`` with Adam at the configured learning rate,
    checkpoints under ``<ckpt_dir>/multimodal``, ``resume``, ``loggers``
    (``log_loss(loss, step)`` on the first batch of every 50).
    ``init_from`` grafts the best branch checkpoints that
    :func:`train_branch` wrote under that directory into the model before
    the first step (:func:`init_from_branches`).  ``data_root`` may be a
    ``PathsConfig``; ``signal`` sets the real data's plane (default
    ``SignalConfig()``).  ``lime_every`` = N > 0 appends the JAX
    command's per-epoch LIME snapshot (``xai.LimeEpochSnapshot``, 40
    segments, 150 perturbations, seeded with ``seed``) on the first
    validation row's preprocessed spectrogram, every N epochs, overlays
    under ``<ckpt_dir>/lime``; it runs after ``epoch_callbacks``.  ``mesh``
    (``parallel.make_mesh``, called on every rank of the world) trains
    data parallel: every rank builds the same batches and preprocesses
    them whole (the augmentation draws against the whole batch), and
    ``Trainer(mesh=...)`` gives each rank its rows; ``batch_size`` must
    divide over the ``data`` axis.  Returns ``(trainer, best_kldiv)``;
    the snapshot is ``trainer.epoch_callbacks[-1]``."""
    from .ops import (hms_spectrogram_preprocess, mirror_eeg,
                      spectrogram_augment)
    from .train import (Trainer, TrainerConfig, create_train_state,
                        initialize_kaiming_weights, make_optimizer)
    from .train.steps import fold_in

    dev = resolve_device(device)
    raw_batches, signal, finite, kern_length, first_val = _multimodal_data(
        ckpt_dir, dev, seed, batch_size, data_root, n_folds, limit, workers,
        npy_dir, signal=signal)

    aug_key = torch.Generator().manual_seed(seed + 1)

    def train_iter(epoch: int = 0):
        ep_key = fold_in(aug_key, epoch, torch.device("cpu"))
        for i, b in enumerate(raw_batches(True, epoch)):
            eeg = mirror_eeg(b["eeg"]) if augment else b["eeg"]
            pb = preprocess_batch(eeg, b["spec"], b["y"], signal,
                                  assume_finite=finite)
            s, yb = spectrogram_augment(fold_in(ep_key, i, dev), pb["spec"],
                                        pb["y"], pb["spec"], pb["y"])
            yield {"eeg": pb["eeg"], "spec": s, "y": yb}

    def val_iter():
        for b in raw_batches(False):
            yield preprocess_batch(b["eeg"], b["spec"], b["y"], signal,
                                   assume_finite=finite)

    model = build_train_model(samples=signal.fixed_length,
                              kern_length=kern_length, dtype=dtype)
    initialize_kaiming_weights(model, torch.Generator().manual_seed(seed))
    if init_from is not None:
        init_from_branches(model, init_from)
    state = create_train_state(model.to(dev),
                               make_optimizer(C.TrainerConfig().lr))
    cfg = TrainerConfig(epochs=epochs, seed=seed, resume=resume,
                        hyperparams={"optimizer": "adam"})
    callbacks = list(epoch_callbacks or [])
    if lime_every:
        from .xai import LimeEpochSnapshot
        with torch.no_grad():
            sample = hms_spectrogram_preprocess(
                torch.as_tensor(first_val()["spec"]).to(dev), signal=signal)
        callbacks.append(LimeEpochSnapshot(
            sample[0].cpu().numpy(), f"{ckpt_dir}/lime", every=lime_every,
            n_segments=40, num_samples=150, seed=seed))
    trainer = Trainer(state, cfg, ckpt_dir=f"{ckpt_dir}/multimodal",
                      epoch_callbacks=callbacks, loggers=loggers, mesh=mesh)
    _, best, _ = trainer.train_eval(train_iter, val_iter)
    return trainer, best


# ---------------------------------------------------------------------------
# branch pretraining and the handoff into the multimodal model

#: the zoo models that take each branch's input (``--arch`` of
#: ``train-eeg`` / ``train-spectrogram``), and each branch's default: the
#: multimodal model's own branch
BRANCH_ARCHS = {
    "eeg": ("eegnet", "eegnet_attention_deep",
            "eegnet_attention_regularized", "eegnet_residual",
            "eegnet_residual_lstm", "eegnet_transformer",
            "eeg_seizure_detection", "deepconvnet"),
    "spectrogram": ("spectrogram_cnn", "spectrogram_vit", "efficientnet_b0",
                    "efficientnetv2_b2"),
}
BRANCH_DEFAULT = {"eeg": "eegnet_attention_regularized",
                  "spectrogram": "spectrogram_cnn"}


def _check_arch(which: str, arch: Optional[str]) -> str:
    """``arch`` (default: the multimodal model's branch), validated against
    the branch's list with the JAX CLI's message."""
    if which not in BRANCH_ARCHS:
        raise ValueError(f"unknown branch {which!r}; choose from "
                         f"{tuple(BRANCH_ARCHS)}")
    arch = arch or BRANCH_DEFAULT[which]
    if arch not in BRANCH_ARCHS[which]:
        raise ValueError(f"--arch {arch!r} is not a {which}-branch model; "
                         f"choose from {BRANCH_ARCHS[which]}")
    return arch


def branch_model(which: str, arch: Optional[str] = None,
                 signal: C.SignalConfig = C.SignalConfig(),
                 kern_length: int = 64, seed: int = 42) -> torch.nn.Module:
    """The model ``train_branch`` trains, on the CPU: ``build(arch)`` with
    the keyword arguments it takes of ``samples`` = the signal's window and
    ``kern_length`` (EEG) or ``image_size`` (spectrogram), with the
    weights torch draws at construction from ``seed`` (uniform in
    ±1/√fan_in on the convs and dense layers: the scale of flax's
    LeCun-normal default, which the JAX CLI's branch models start from)."""
    import inspect

    from .models import REGISTRY

    cls = REGISTRY[_check_arch(which, arch)]
    offered = ({"samples": signal.fixed_length, "kern_length": kern_length}
               if which == "eeg" else {"image_size": signal.image_size})
    params = inspect.signature(cls).parameters
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return cls(**{k: v for k, v in offered.items() if k in params})


def train_branch(which: str, ckpt_dir: str, arch: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None,
                 epochs: int = 3, batch_size: Optional[int] = None,
                 seed: int = 42, data_root: Optional[str] = None,
                 augment: bool = False, resume: bool = False,
                 n_folds: int = C.N_FOLDS, limit: Optional[int] = None,
                 workers: int = 8, npy_dir: Optional[str] = None,
                 loggers: Optional[list] = None,
                 signal: Optional[C.SignalConfig] = None, mesh=None):
    """The JAX CLI's ``train-eeg`` / ``train-spectrogram`` (``which`` =
    ``"eeg"`` or ``"spectrogram"``): one modality's model trained alone.

    ``arch`` (a :data:`BRANCH_ARCHS` name; default
    :data:`BRANCH_DEFAULT`, the multimodal model's branch) is checked before any data work.  The data are
    :func:`_multimodal_data`'s with only this modality gathered; each train
    batch is mirrored when ``augment`` (EEG), then preprocessed on the
    device (``hms_eeg_preprocess`` on the demo's NaN route or the real
    data's finite route; ``hms_spectrogram_preprocess``).  The model is
    :func:`branch_model`'s; ``Trainer.train_eval`` with Adam at
    ``TrainerConfig().lr``, the L2 term at λ = 1e-3 and
    ``ReduceLROnPlateau`` on the validation loss; checkpoints under
    ``<ckpt_dir>/<which>``, where the run then writes ``ARCH`` (the arch's
    name) for :func:`init_from_branches`.  ``data_root`` and ``signal``
    as in :func:`train_multimodal`, and ``mesh`` (rank 0 writes
    ``ARCH``).  Returns ``(history, best_kldiv)``; the command line plots
    the curves."""
    from .ops import (hms_eeg_preprocess, hms_spectrogram_preprocess,
                      mirror_eeg)
    from .train import (ReduceLROnPlateau, Trainer, TrainerConfig,
                        create_train_state, make_optimizer)

    arch = _check_arch(which, arch)
    dev = resolve_device(device)
    key = "eeg" if which == "eeg" else "spec"
    raw_batches, signal, finite, kern_length, _ = _multimodal_data(
        ckpt_dir, dev, seed, batch_size, data_root, n_folds, limit, workers,
        npy_dir, want=(key,), signal=signal)

    @torch.no_grad()
    def pp(raw: torch.Tensor) -> torch.Tensor:
        if which == "eeg":
            return hms_eeg_preprocess(raw, signal=signal,
                                      assume_finite=finite)
        return hms_spectrogram_preprocess(raw, signal=signal)

    def train_iter(epoch: int = 0):
        for b in raw_batches(True, epoch):
            raw = mirror_eeg(b[key]) if augment and which == "eeg" else b[key]
            yield {"x": pp(raw), "y": b["y"]}

    def val_iter():
        for b in raw_batches(False):
            yield {"x": pp(b[key]), "y": b["y"]}

    lr = C.TrainerConfig().lr
    model = branch_model(which, arch, signal, kern_length, seed)
    state = create_train_state(model.to(dev), make_optimizer(lr))
    cfg = TrainerConfig(epochs=epochs, seed=seed, resume=resume,
                        l2_lambda=1e-3, hyperparams={"optimizer": "adam"},
                        plateau=ReduceLROnPlateau(lr))
    trainer = Trainer(state, cfg, ckpt_dir=f"{ckpt_dir}/{which}",
                      loggers=loggers, mesh=mesh)
    _, best, _ = trainer.train_eval(train_iter, val_iter)
    if trainer.primary:
        with open(os.path.join(ckpt_dir, which, "ARCH"), "w") as f:
            f.write(arch + "\n")
    return trainer.history, best


def init_from_branches(model: MultimodalModel, init_dir: str
                       ) -> MultimodalModel:
    """Graft the best checkpoints of :func:`train_branch` under
    ``init_dir`` (``eeg/`` and ``spectrogram/``) into ``model``'s
    ``eeg_model`` and ``spectrogram_model``: parameters and BatchNorm
    statistics.  A branch pretrained with another arch than the
    multimodal model's raises ``ValueError``; a missing branch directory
    warns and is skipped.  Returns ``model``."""
    import warnings

    from .train import CheckpointManager

    for which, sub in (("eeg", "eeg_model"),
                       ("spectrogram", "spectrogram_model")):
        ckpt_dir = os.path.join(init_dir, which)
        if not os.path.isdir(ckpt_dir):
            warnings.warn(f"no {which} branch checkpoint under {init_dir}")
            continue
        marker = os.path.join(ckpt_dir, "ARCH")
        expected = BRANCH_DEFAULT[which]
        if os.path.exists(marker):
            with open(marker) as f:
                arch = f.read().strip()
            if arch != expected:
                raise ValueError(
                    f"--init-from: the {which} branch under {ckpt_dir} was "
                    f"pretrained with --arch {arch}, but the multimodal "
                    f"model's {which} branch is {expected}; repretrain "
                    f"without --arch for the handoff")
        best = CheckpointManager(ckpt_dir).load("best-kldiv")["model"]
        getattr(model, sub).load_state_dict(best)
    return model


# ---------------------------------------------------------------------------
# the WaveNet: cross-validated training and the grid search

#: ``train-wavenet``'s and ``grid-search``'s transform: the Chris-magic-8
#: bipolar channels, lowpass (the IIR kernel on the card), ÷5, clip, scale
WAVENET_TRANSFORM = C.EEGTransformConfig(apply_chris_magic_ch8=True,
                                         n_feats=8)
#: ``grid-search``'s default grid
DEFAULT_GRID = {"lr": [1e-3, 3e-3, 1e-2]}


def transform_windows(raw: np.ndarray, tcfg: C.EEGTransformConfig,
                      device: Union[str, torch.device],
                      chunk: int = 256) -> np.ndarray:
    """``eeg_transform`` with ``tcfg`` over raw (N, L, C) µV windows,
    ``chunk`` windows a call on ``device`` → (N, L', C') float32 on the
    host."""
    from .ops import eeg_transform
    outs = []
    with torch.no_grad():
        for s in range(0, len(raw), chunk):
            a = torch.as_tensor(raw[s:s + chunk], dtype=torch.float32)
            outs.append(eeg_transform(a.to(device), tcfg).cpu().numpy())
    return np.concatenate(outs)


def wavenet_training_set(data_root: Union[str, C.PathsConfig],
                         ckpt_dir: str, device: Union[str, torch.device],
                         limit: Optional[int] = None, workers: int = 8
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``train-wavenet``'s and ``grid-search``'s data from the tree under
    ``data_root`` (a directory or a ``PathsConfig``):
    ``data.wavenet_arrays`` (window cache in ``ckpt_dir``), then
    :data:`WAVENET_TRANSFORM` on ``device``.  Returns ``(x (N, 2000, 8),
    y (N, 6) soft targets, groups (N,) patient ids)``."""
    from .data import wavenet_arrays
    src = wavenet_arrays(_paths(data_root), cache_dir=ckpt_dir,
                         n_workers=workers, limit=limit)
    x = transform_windows(src["x"], WAVENET_TRANSFORM, device)
    return x, src["y"].astype(np.float32), src["groups"]


def wavenet_model(seed: int = 42) -> torch.nn.Module:
    """The full ``DilatedInceptionWaveNet()`` (blocks of 12/8/4/1 layers,
    widths 16/32/64/64) on the CPU with weights drawn from ``seed``
    (:func:`..models.seeded_state_dict`)."""
    from .models import DilatedInceptionWaveNet
    model = DilatedInceptionWaveNet()
    model.load_state_dict(seeded_state_dict(model, seed))
    return model


def load_generated_pools(augment_dir: str, length: int,
                         device: Union[str, torch.device]
                         ) -> Dict[int, np.ndarray]:
    """``generate``'s ``generated_class_{c}.npy`` pools under
    ``augment_dir`` ((M, 19, length) windows in the transformed 19-channel
    space) mapped into the WaveNet's input space: the magic-8 bipolar
    differences on ``device``, clipped at ±32 (the bound the real chain's
    clip and scale guarantee).  A missing file or one of another shape is
    skipped with a printed warning, as the JAX command does."""
    from .ops import chris_magic_ch8
    gen = {}
    for c in range(C.N_CLASSES):
        path = os.path.join(augment_dir, f"generated_class_{c}.npy")
        if not os.path.exists(path):
            print(f"warning: {path} missing")
            continue
        arr = np.load(path)
        if arr.ndim != 3 or arr.shape[1] != len(C.EEG_FEATURES) \
                or arr.shape[2] != length:
            print(f"warning: {path} shape {arr.shape} does not match the "
                  f"19-channel/{length}-pt transformed space; skipping")
            continue
        with torch.no_grad():
            g8 = chris_magic_ch8(torch.as_tensor(
                arr.transpose(0, 2, 1), dtype=torch.float32).to(device),
                columns=C.EEG_FEATURES)
        gen[c] = np.clip(g8.cpu().numpy(), -32.0, 32.0).astype(np.float32)
    return gen


def train_wavenet(data_root: Optional[Union[str, C.PathsConfig]],
                  ckpt_dir: str,
                  device: Optional[Union[str, torch.device]] = None,
                  epochs: int = 3, batch_size: int = 16, seed: int = 42,
                  n_folds: int = C.N_FOLDS, one_fold: bool = False,
                  resume: bool = False, limit: Optional[int] = None,
                  workers: int = 8, loggers: Optional[list] = None,
                  raw: Optional[np.ndarray] = None,
                  y: Optional[np.ndarray] = None,
                  groups: Optional[np.ndarray] = None,
                  augment_dir: Optional[str] = None, mesh=None):
    """The JAX CLI's ``train-wavenet``: :func:`wavenet_training_set` (or,
    with ``data_root`` None, ``raw`` (N, L, 19 or 20) µV windows with soft
    labels ``y`` and patient ``groups`` through
    :data:`WAVENET_TRANSFORM`), then, with ``augment_dir``, the generated
    pools of :func:`load_generated_pools` merged in by
    ``diffusion.augment_dataset_balanced`` (seeded with ``seed``), then
    the patient-grouped ``n_folds`` split and ``train.run_cv`` (fold 0
    only with ``one_fold``): each fold trains :func:`wavenet_model` with
    Adam under a cosine schedule with 10 warm-up steps to
    ``TrainerConfig().lr``, batches of ``batch_size`` shuffled with
    ``seed + epoch``, checkpoints under ``<ckpt_dir>/wavenet_fold{k}``.
    The out-of-fold predictions go to ``<ckpt_dir>/oof.npy``.  ``mesh``
    trains each fold data parallel as in :func:`train_multimodal` (rank
    0 writes and prints).  Returns ``(oof, fold scores)``."""
    from .data import batch_iterator
    from .parallel import is_primary
    from .train import (Trainer, TrainerConfig, cosine_schedule_with_warmup,
                        create_train_state, group_kfold, make_optimizer,
                        run_cv)

    dev = resolve_device(device)
    if data_root is not None:
        x, y, groups = wavenet_training_set(data_root, ckpt_dir, dev, limit,
                                            workers)
    else:
        x = transform_windows(raw, WAVENET_TRANSFORM, dev)
        y = np.asarray(y, np.float32)
    if augment_dir:
        from .diffusion import augment_dataset_balanced
        n_real = len(x)
        x, y, groups = augment_dataset_balanced(
            x, y, load_generated_pools(augment_dir, x.shape[1], dev),
            seed=seed, groups=groups)
        if is_primary():
            print(f"augmented dataset: {n_real} real + {len(x) - n_real} "
                  f"synthetic samples")
    splits = group_kfold(groups, n_splits=n_folds)
    lr = C.TrainerConfig().lr

    def make_loaders(tr, va):
        def train_loader(epoch: int = 0):
            return batch_iterator({"x": x[tr], "y": y[tr]}, batch_size,
                                  shuffle=True, seed=seed + epoch)

        def val_loader():
            return batch_iterator({"x": x[va], "y": y[va]}, batch_size,
                                  drop_last=False)
        return train_loader, val_loader

    def make_trainer(fold: int):
        state = create_train_state(wavenet_model(seed).to(dev),
                                   make_optimizer(lr), seed=seed)
        cfg = TrainerConfig(
            epochs=epochs, seed=seed, resume=resume,
            hyperparams={"optimizer": "adam"},
            lr_schedule=cosine_schedule_with_warmup(
                10, epochs * max(1, len(x) // batch_size), lr))
        return Trainer(state, cfg, ckpt_dir=f"{ckpt_dir}/wavenet_fold{fold}",
                       loggers=loggers, mesh=mesh)

    oof, scores = run_cv(make_trainer, make_loaders, splits, len(x),
                         one_fold_only=one_fold)
    if is_primary():
        np.save(f"{ckpt_dir}/oof.npy", oof)
    return oof, scores


def grid_search(data_root: Optional[Union[str, C.PathsConfig]],
                ckpt_dir: str,
                device: Optional[Union[str, torch.device]] = None,
                grid: Optional[Dict[str, Sequence[float]]] = None,
                epochs: int = 2, batch_size: int = 16, seed: int = 42,
                limit: Optional[int] = None, workers: int = 8,
                x: Optional[np.ndarray] = None,
                y: Optional[np.ndarray] = None,
                model: Optional[torch.nn.Module] = None):
    """The JAX CLI's ``grid-search``: :func:`wavenet_training_set` (window
    cache in ``ckpt_dir``; or, with ``data_root`` None, the transformed
    windows ``x`` (N, L, 8) and soft labels ``y`` as given), then
    ``train.parallel_grid_search`` of ``model`` (default the full
    :func:`wavenet_model`) over ``grid`` (default :data:`DEFAULT_GRID`)
    with the KLDiv loss, every candidate through one step over the stacked
    candidates (candidate g's weights drawn from ``seed + g``), ``epochs``
    passes over batches of ``batch_size`` shuffled with ``seed``.  Returns
    ``(best, ranked results)``."""
    from .data import batch_iterator
    from .train import kldiv_with_logits, parallel_grid_search

    dev = resolve_device(device)
    if data_root is not None:
        x, y, _ = wavenet_training_set(data_root, ckpt_dir, dev, limit,
                                       workers)

    def batches():
        return batch_iterator({"x": x, "y": y}, batch_size, shuffle=True,
                              seed=seed)

    return parallel_grid_search(
        model if model is not None else wavenet_model(seed),
        (torch.as_tensor(x[:2]).to(dev),), batches,
        grid or DEFAULT_GRID, kldiv_with_logits, epochs=epochs, seed=seed)


# ---------------------------------------------------------------------------
# DiffEEG diffusion

def diffeeg_demo_config(batch_size: Optional[int] = None,
                        steps: Optional[int] = None) -> C.DiffEEGConfig:
    """The JAX CLI's ``--demo`` DiffEEG configuration: 4 channels × 256
    samples, hidden 8, 50 diffusion steps, K=2 micro-batches of 8 (or
    ``batch_size``), ``steps`` (default 20) steps, checkpoints and
    evaluations every 10, STFT 32/16."""
    return C.DiffEEGConfig(
        n_channels=4, input_length=256, hidden_channels=8,
        n_diffusion_steps=50, gradient_accumulate_every=2,
        batch_size=batch_size or 8, evaluate_every=10,
        save_and_sample_every=10, min_steps=steps or 20, stft_n_fft=32,
        stft_noverlap=16)


def diffeeg_model(cfg: C.DiffEEGConfig, seed: int = 42,
                  dtype: Optional[torch.dtype] = None):
    """A ``DiffEEG`` of ``cfg``'s width on the CPU with weights drawn from
    ``seed`` (:func:`..models.seeded_state_dict`), computing in ``dtype``."""
    from .models import DiffEEG
    model = DiffEEG(n_channels=cfg.n_channels, hidden=cfg.hidden_channels,
                    dtype=dtype)
    model.load_state_dict(seeded_state_dict(model, seed))
    return model


def diffeeg_training_windows(raw: np.ndarray,
                             device: Union[str, torch.device],
                             chunk: int = 256) -> np.ndarray:
    """``train-diffeeg``'s training set from raw windows: (N, L, 20) µV
    (the EKG column is dropped) → ``eeg_transform`` with the 19 scalp
    channels and no magic-8 montage (the order-4 lowpass is the IIR kernel
    on the card), ``chunk`` windows a call on ``device`` → (N, C', L/5)
    float32 on the host."""
    tcfg = C.EEGTransformConfig(apply_chris_magic_ch8=False,
                                n_feats=len(C.EEG_FEATURES))
    x = transform_windows(raw[..., :len(C.EEG_FEATURES)], tcfg, device, chunk)
    return np.ascontiguousarray(x.transpose(0, 2, 1))


def train_diffeeg(ckpt_dir: str,
                  device: Optional[Union[str, torch.device]] = None,
                  raw: Optional[np.ndarray] = None,
                  y: Optional[np.ndarray] = None,
                  cfg: Optional[C.DiffEEGConfig] = None,
                  steps: Optional[int] = None,
                  batch_size: Optional[int] = None, seed: int = 42,
                  resume: bool = False,
                  data_root: Optional[Union[str, C.PathsConfig]] = None,
                  limit: Optional[int] = None, workers: int = 8,
                  mesh=None):
    """The JAX CLI's ``train-diffeeg``: a :class:`..train.DiffEEGTrainer`
    with step checkpoints under ``<ckpt_dir>/diffeeg``, resumed from the
    latest when ``resume``, run to ``steps`` (default ``cfg.min_steps``).
    Returns ``(trainer, history)``.

    Without ``raw``: the ``--demo`` configuration
    (:func:`diffeeg_demo_config`; a ``cfg`` given raises ``ValueError``)
    on a stream of Gaussian micro-batches,
    micro-batch i drawn from ``default_rng((seed, i))``, and one Gaussian
    validation batch.  With ``raw`` (N, 10000, 20) µV windows and soft
    labels ``y`` (N, 6) (what the JAX package's ``data.wavenet_arrays``
    returns): ``cfg`` (default ``DiffEEGConfig()``) with ``batch_size``
    if given; the training set from :func:`diffeeg_training_windows`; 10 %
    (at least one window, at most N − 1) held out for validation by
    ``default_rng(seed)``; the rest in epoch-shuffled micro-batches
    (``runtime.NativeBatchQueue`` with ``seed + epoch``, a resumed run
    skipping the micro-batches already consumed), or, with fewer windows
    than a batch, micro-batch i drawn with replacement by
    ``default_rng((seed, i))``; the first four validation batches.
    ``data_root`` (an HMS dataset tree or its ``PathsConfig``, in place of
    ``raw`` and ``y``) reads them with ``data.wavenet_arrays`` (window
    cache in ``ckpt_dir``, the first ``limit`` ids when given).  ``mesh``
    trains data parallel (``DiffEEGTrainer(mesh=...)``: each rank takes
    its part of every micro-batch; the batch size must divide over the
    ``data`` axis)."""
    from .runtime import NativeBatchQueue
    from .train import DiffEEGTrainer

    dev = resolve_device(device)
    if data_root is not None:
        if raw is not None:
            raise ValueError("pass raw windows or a data_root, not both")
        from .data import wavenet_arrays
        src = wavenet_arrays(_paths(data_root), cache_dir=ckpt_dir,
                             n_workers=workers, limit=limit)
        raw, y = src["x"], src["y"]
    rng = np.random.default_rng(seed)
    if raw is None:
        if cfg is not None:
            raise ValueError("the demo path runs diffeeg_demo_config(); "
                             "cfg applies only with raw windows")
        cfg = diffeeg_demo_config(batch_size, steps)
        B, shape = cfg.batch_size, (cfg.n_channels, cfg.input_length)

        def batches(start=0):
            for i in itertools.count(start):
                g = np.random.default_rng((seed, i))
                x = g.standard_normal((B,) + shape).astype(np.float32)
                yield x, np.eye(6, dtype=np.float32)[g.integers(0, 6, B)]

        val = [(rng.standard_normal((4,) + shape).astype(np.float32),
                np.eye(6, dtype=np.float32)[rng.integers(0, 6, 4)])]
    else:
        x = diffeeg_training_windows(raw, dev)
        y = np.asarray(y, np.float32)
        cfg = cfg or C.DiffEEGConfig()
        if batch_size:
            cfg = dataclasses.replace(cfg, batch_size=batch_size)
        B = cfg.batch_size
        n_val = max(1, min(len(x) // 10, len(x) - 1))
        perm = rng.permutation(len(x))
        va, tr = perm[:n_val], perm[n_val:]
        if len(tr) >= B:
            xtr = np.ascontiguousarray(x[tr])
            ytr = np.ascontiguousarray(y[tr])

            def batches(start=0):
                # the trainer holds K micro-batches before it stacks them:
                # the ring must exceed that
                ring = cfg.gradient_accumulate_every + 8
                ep0, off = divmod(start, max(1, len(xtr) // B))
                for ep in itertools.count(ep0):
                    it = iter(NativeBatchQueue(xtr, ytr, B, shuffle=True,
                                               seed=seed + ep, pop_ring=ring))
                    if ep == ep0:
                        for _ in range(off):
                            next(it, None)
                    for b in it:
                        yield b["x"], b["y"]
        else:
            def batches(start=0):
                for i in itertools.count(start):
                    sel = np.random.default_rng((seed, i)).choice(tr, size=B)
                    yield x[sel], y[sel]

        val = [(x[va[s:s + B]], y[va[s:s + B]])
               for s in range(0, min(len(va), 4 * B), B)]
    model = diffeeg_model(cfg, seed, torch.bfloat16 if cfg.amp else None)
    trainer = DiffEEGTrainer(model, cfg, ckpt_dir=f"{ckpt_dir}/diffeeg",
                             seed=seed, device=dev, mesh=mesh)
    if resume:
        trainer.load()
    history = trainer.train(batches, val_batches=val,
                            total_steps=steps or cfg.min_steps)
    return trainer, history


def generate(ckpt_dir: str,
             device: Optional[Union[str, torch.device]] = None,
             demo: bool = False, cfg: Optional[C.DiffEEGConfig] = None,
             n_samples: Optional[int] = None, seed: int = 42
             ) -> Dict[int, str]:
    """The JAX CLI's ``generate``: restore the latest ``train-diffeeg``
    step under ``<ckpt_dir>/diffeeg`` and sample every class with its EMA
    weights from a zeros (50, 50) spectrogram prior
    (``diffusion.generate_for_class_cached``, class c from a device
    generator seeded ``seed + c``), ``n_samples`` windows a class (50; 2
    with ``demo``), written to ``<ckpt_dir>/generated/
    generated_class_{c}.npy``.  ``cfg``: the demo configuration with
    ``demo`` (a ``cfg`` given then raises ``ValueError``), else
    ``DiffEEGConfig()`` unless given.  Without a checkpoint
    the demo samples from the seeded initial weights and anything else
    raises ``FileNotFoundError``.  Returns {class: path}."""
    from .diffusion import generate_for_class_cached
    from .train import DiffEEGTrainer

    if demo and cfg is not None:
        raise ValueError("generate(demo=True) runs diffeeg_demo_config(); "
                         "pass cfg without demo")
    dev = resolve_device(device)
    cfg = diffeeg_demo_config() if demo else (cfg or C.DiffEEGConfig())
    trainer = DiffEEGTrainer(diffeeg_model(cfg, seed), cfg,
                             ckpt_dir=f"{ckpt_dir}/diffeeg", seed=seed,
                             device=dev)
    if trainer.load() is None and not demo:
        raise FileNotFoundError(
            f"no train-diffeeg checkpoint under {ckpt_dir}/diffeeg: run "
            f"train_diffeeg first")
    n = n_samples or (2 if demo else 50)
    out_dir = os.path.join(ckpt_dir, "generated")
    os.makedirs(out_dir, exist_ok=True)
    model = trainer.ema_model()
    paths = {}
    for c in range(cfg.n_classes):
        gen = torch.Generator(device=dev).manual_seed(seed + c)
        out = generate_for_class_cached(
            trainer.schedule, model, gen, c, n_samples=n,
            n_channels=cfg.n_channels, length=cfg.input_length,
            n_classes=cfg.n_classes)
        paths[c] = os.path.join(out_dir, f"generated_class_{c}.npy")
        np.save(paths[c], out)
    return paths


# ---------------------------------------------------------------------------
# the sanity check

def sanity_images(seed: int = 42, n: int = 256) -> np.ndarray:
    """``sanity-check``'s synthetic digits: (n, 28, 28) float32 Gaussian
    blobs at centres drawn uniformly in [6, 22)² by ``default_rng(seed)``
    (the JAX command's numpy draws)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28]
    centers = rng.uniform(6, 22, size=(n, 2))
    imgs = np.exp(-(((yy[None] - centers[:, :1, None]) ** 2
                     + (xx[None] - centers[:, 1:, None]) ** 2) / 18.0))
    return imgs.astype(np.float32)


def sanity_check(device: Optional[Union[str, torch.device]] = None,
                 epochs: int = 50, seed: int = 42,
                 state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 on_epoch: Optional[Callable] = None) -> list:
    """The JAX CLI's ``sanity-check``: ``DiffEEGSanityCheck(784, 128)``
    (weights ``state_dict``, default drawn from ``seed`` by
    :func:`..models.seeded_state_dict`) trained as an autoencoder on
    :func:`sanity_images`, full batch, by ``train.make_optimizer(1e-3)``
    (optax's Adam), one step an epoch.  ``on_epoch(epoch, loss, model)``
    is called after each step (the command plots reconstructions).
    Returns the loss of every epoch, each before its step."""
    from .models import DiffEEGSanityCheck
    from .train import make_optimizer
    from .train.state import assign_flat, flat

    dev = resolve_device(device)
    model = DiffEEGSanityCheck(input_dim=784, hidden=128)
    model.load_state_dict(state_dict if state_dict is not None
                          else seeded_state_dict(model, seed))
    model.to(dev)
    x = torch.as_tensor(sanity_images(seed)).to(dev)
    params = list(model.parameters())
    tx = make_optimizer(1e-3)
    opt = tx.init([p.detach() for p in params])
    losses = []
    for epoch in range(epochs):
        loss = torch.mean((model(x) - x) ** 2)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            new, opt = tx.update(flat(grads), flat(params), opt)
            assign_flat(params, new)
        losses.append(float(loss.detach()))
        if on_epoch is not None:
            on_epoch(epoch, losses[-1], model)
    return losses


# ---------------------------------------------------------------------------
# the multichip dry run

def _factor(n: int) -> Tuple[int, int, int]:
    """``n`` ranks as (data, model, seq), three axes where n allows."""
    if n % 4 == 0:
        return (n // 4, 2, 2)
    if n % 2 == 0:
        return (n // 2, 1, 2)
    return (n, 1, 1)


def _dryrun_rank(dev: torch.device, n_devices: int) -> dict:
    """One rank of :func:`dryrun_multichip`."""
    from . import parallel
    from .parallel import dryrun
    from .train import (create_train_state, initialize_kaiming_weights,
                        make_optimizer)

    dp, mp, sp = _factor(n_devices)
    mesh = parallel.make_mesh(C.MeshConfig(data=dp, model=mp, seq=sp), dev)
    enc = parallel.LongEEGEncoder(n_channels=4, patch=8, d_model=32,
                                  depth=2, n_heads=4)
    params = dryrun.init_dp_tp_sp_params(torch.Generator().manual_seed(0),
                                         enc, head_hidden=64)
    rng = np.random.default_rng(0)
    B, T = 2 * dp, 8 * 8 * sp                     # patches divide over seq
    x = rng.standard_normal((B, 4, T)).astype(np.float32)
    y = np.eye(6, dtype=np.float32)[rng.integers(0, 6, B)]
    local, xs, ys = dryrun.place_inputs(mesh, params, x, y, dev)
    enc.to(dev)
    _, loss = dryrun.make_dp_tp_sp_train_step(mesh, enc, lr=1e-3)(
        local, xs, ys)
    if not bool(torch.isfinite(loss)):
        raise RuntimeError("non-finite loss in the multichip dry run")

    # the multimodal model's data-parallel step over each rank's own
    # preprocessing of its rows, then the single-device replay of its loss
    sig = C.SignalConfig(fixed_length=512, image_size=(64, 48))
    raw_eeg = rng.standard_normal((B, 20, 2000)).astype(np.float32) * 40
    raw_spec = rng.standard_normal((B, 64, 48)).astype(np.float32) * 5
    raw = parallel.shard_batch(mesh, {"eeg": raw_eeg, "spec": raw_spec,
                                      "y": y})
    batch = preprocess_batch(raw["eeg"].to(dev), raw["spec"].to(dev),
                             raw["y"].to(dev), sig, assume_finite=False)
    model = MultimodalModel(
        EEGNetAttentionRegularized(samples=512, kern_length=16),
        SpectrogramCNN()).train()
    initialize_kaiming_weights(model, torch.Generator().manual_seed(0))
    state = create_train_state(model.to(dev), make_optimizer(1e-3))
    before = parallel.train.copy_state(state)
    step = parallel.make_parallel_train_step(mesh, state)
    state, metrics = step(state, batch, torch.Generator().manual_seed(1))
    dp_loss = float(metrics["loss"])
    if not np.isfinite(dp_loss):
        raise RuntimeError("non-finite multimodal loss in the multichip "
                           "dry run")
    full = {k: parallel.mesh.gather_data(v, mesh) for k, v in batch.items()}
    rp_loss = float(parallel.replay_dp_loss_single_device(
        before, full, torch.Generator().manual_seed(1), dp))
    if abs(dp_loss - rp_loss) >= 1e-4 * max(1.0, abs(rp_loss)):
        raise RuntimeError(f"mesh DP loss {dp_loss} != single-device "
                           f"replay {rp_loss}")
    if parallel.is_primary():
        print(f"dryrun_multichip OK: mesh=({dp},{mp},{sp}) "
              f"sp_loss={float(loss):.4f} "
              f"multimodal_dp_loss={dp_loss:.6f} "
              f"single_device_replay_loss={rp_loss:.6f} (match)",
              flush=True)
    return {"mesh": (dp, mp, sp), "sp_loss": float(loss),
            "dp_loss": dp_loss, "replay_loss": rp_loss}


def dryrun_multichip(n_devices: int,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> dict:
    """The JAX entry's ``dryrun_multichip``: a world of ``n_devices``
    ranks (``parallel.launch.spawn``: NCCL, one card a rank, on cuda —
    the default, and ``n_devices`` cards are required; gloo on ``cpu``)
    runs one DP × TP × SP step of the long-EEG encoder with the TP head
    (``parallel.dryrun``) on a (data, model, seq) mesh factored from
    ``n_devices``, then one data-parallel step of the multimodal model
    over each rank's preprocessing of its rows, whose loss must equal the
    single-device replay (``parallel.replay_dp_loss_single_device``) to
    1e-4·max(1, |loss|).  Rank 0 prints ``dryrun_multichip OK: mesh=(d,m,
    s) ...``; returns rank 0's losses."""
    from .parallel import launch
    dev = resolve_device(device)
    return launch.spawn(_dryrun_rank, n_devices, dev.type, (n_devices,))[0]
