"""The port's command line (counterpart of the JAX package's ``cli.py``):
the same subcommands and flags, on the card.

    python -m multimodal_brain_pattern_identification_xai_tpu_torch <cmd> [...]

    cache-build          sweep eeg parquets into the npz window cache
    train-wavenet        GroupKFold CV of DilatedInceptionWaveNet;
                         --augment-dir merges generated EEG pools first
    train-multimodal     multimodal EEG+spectrogram training, with per-epoch
                         LIME snapshots (--lime-every; --demo: every epoch);
                         --init-from grafts pretrained branch checkpoints
    train-eeg            EEG-branch pretraining (--arch: a zoo model)
    train-spectrogram    spectrogram-branch pretraining (--arch)
    train-diffeeg        DiffEEG diffusion training
    generate             class-conditional EEG from the trained EMA weights
    predict              batch inference with the trained multimodal
                         checkpoint → predictions.csv (the serving path)
    xai                  saliency / IG / SHAP / LIME / Grad-CAM report
    grid-search          WaveNet hyperparameter grid search
    sanity-check         autoencoder sanity run with sample grids
    convert-spectrograms spectrogram parquets → .npy (needs pandas)
    dump-config          the effective configuration as YAML (needs PyYAML)
    long-eeg, bench      not ported yet: exit 2 naming what brings them

Every command takes the JAX command's flags with the same defaults, and
one more: ``--device`` (default ``cuda``).  A command that computes
resolves it through ``resolve_device``: without a card it stops unless
``--device cpu`` is given, and nothing moves to the CPU by itself.
``dump-config``, ``cache-build`` and ``convert-spectrograms`` touch no
device.  ``--mesh N`` with N > 1 exits 2 (the parallel slice brings it).

Optional packages: without matplotlib every plot is skipped with one
logged line and nothing else changes; ``--config`` and ``dump-config``
need PyYAML (``--set`` does not); parquet reads (``cache-build``,
``convert-spectrograms``, a tree without its ``.npy`` spectrograms) need
pandas.  Real data is read from ``paths.data_root`` (``--set
paths.data_root=DIR``) with the window cache ``<ckpt-dir>/eeg_cache.npz``
and, where ``<ckpt-dir>/spectrograms_npy`` exists (``convert-
spectrograms`` writes it), the spectrograms from there.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

#: what brings each command or option that is not ported yet
PARALLEL_SLICE = ("the port's parallel slice (ROADMAP queue 1 item 4, "
                  "parallel)")
BENCH_SLICE = "the port's benchmark"
#: commands that touch no device
HOST_COMMANDS = ("dump-config", "cache-build", "convert-spectrograms")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", default=None, help="YAML config path")
    p.add_argument("--set", dest="overrides", action="append", default=[],
                   help="config override key.path=value (repeatable)")
    p.add_argument("--demo", action="store_true",
                   help="run on synthetic data")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--ckpt-dir", default="checkpoints")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--limit", type=int, default=None,
                   help="cap the number of records/rows (real-data smoke)")
    p.add_argument("--workers", type=int, default=8,
                   help="host loader threads for cache builds")
    p.add_argument("--one-fold", action="store_true",
                   help="train only fold 0 of the CV split")
    p.add_argument("--resume", action="store_true",
                   help="resume training from the latest checkpoint under "
                        "--ckpt-dir")
    p.add_argument("--n-samples", type=int, default=None,
                   help="samples per class for `generate` "
                        "(default 50; 2 with --demo)")
    p.add_argument("--augment-dir", default=None,
                   help="directory of generated_class_{c}.npy files; "
                        "balanced-merge them into the training set before "
                        "training")
    p.add_argument("--init-from", default=None,
                   help="ckpt root holding train-eeg / train-spectrogram "
                        "branch checkpoints to initialize the multimodal "
                        "model from")
    p.add_argument("--channel-retrain", type=int, default=0,
                   help="xai: retrain a binary classifier on the top-N "
                        "SHAP channels (0 = off)")
    p.add_argument("--channel-class", type=int, default=0,
                   help="xai: positive class for --channel-retrain")
    p.add_argument("--lime-every", type=int, default=0,
                   help="per-epoch LIME snapshot interval (0 = off; "
                        "--demo defaults to 1)")
    p.add_argument("--grid", action="append", default=[],
                   help="grid-search axis name=v1,v2,... (repeatable; "
                        "e.g. --grid lr=1e-3,3e-3,1e-2)")
    p.add_argument("--mesh", type=int, default=0,
                   help="data-parallel mesh of N devices (0/1 = one "
                        "device; N > 1 is not ported yet)")
    p.add_argument("--torch-ckpt", default=None,
                   help="predict/xai: load a reference-layout combined "
                        "MultimodalModel state dict (.pt) instead of a "
                        "train-multimodal checkpoint")
    p.add_argument("--eval", action="store_true",
                   help="predict: score the predictions against the rows' "
                        "labels (KL-div, hard/soft accuracy, macro PRF, "
                        "confusion-matrix plot)")
    p.add_argument("--arch", default=None,
                   help="train-eeg/train-spectrogram: zoo model to "
                        "pretrain (registry name; default "
                        "eegnet_attention_regularized / spectrogram_cnn)")
    p.add_argument("--fused-spec", type=int, default=0,
                   help="predict/xai: run the first N spectrogram CNN "
                        "blocks through the fused conv×3+pool kernel "
                        "(same parameters; gradients by its VJP)")
    p.add_argument("--device", default="cuda",
                   help="device to run on (default cuda; --device cpu "
                        "runs the plain PyTorch versions on the CPU)")


def _load_cfg(args):
    from . import config as C
    return C.load_config(args.config, args.overrides)


def _npy_dir(args) -> Optional[str]:
    """``<ckpt-dir>/spectrograms_npy`` where it exists (the spectrograms
    ``convert-spectrograms`` wrote), else None."""
    d = os.path.join(args.ckpt_dir, "spectrograms_npy")
    return d if os.path.isdir(d) else None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed(dev: torch.device, fn):
    """``(fn(), ms)`` with the device synchronised around the call."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _check_arch(which: str, arch: Optional[str]) -> str:
    """The branch's arch, or the JAX command's refusal as an exit."""
    from . import entry
    try:
        return entry._check_arch(which, arch)
    except ValueError as e:
        raise SystemExit(str(e))


# ---------------------------------------------------------------------------
# training commands

def cmd_train_wavenet(args) -> int:
    """Cross-validated ``DilatedInceptionWaveNet`` (``entry.train_wavenet``):
    ``--demo`` 48 random (2000, 19) windows, else the HMS tree's windows;
    ``--augment-dir`` merges generated pools in first."""
    from . import entry, train
    from .data import wavenet_arrays

    cfg = _load_cfg(args)
    rng = np.random.default_rng(args.seed)
    if args.demo:
        n = 48
        raw = rng.standard_normal((n, 2000, 19)).astype(np.float32) * 100
        groups = rng.integers(0, 12, n)
        y = train.cv.aggregate_vote_labels(rng.integers(0, 10, (n, 6)))
    else:
        src = wavenet_arrays(cfg.paths, cache_dir=args.ckpt_dir,
                             n_workers=args.workers, limit=args.limit)
        raw, y, groups = src["x"], src["y"], src["groups"]
        print(f"loaded {len(raw)} eeg windows "
              f"({raw.nbytes / 1e9:.2f} GB raw)")
    oof, scores = entry.train_wavenet(
        None, args.ckpt_dir, device=args.device, epochs=args.epochs or 3,
        batch_size=args.batch_size or 16, seed=args.seed,
        n_folds=cfg.n_folds, one_fold=args.one_fold, resume=args.resume,
        raw=raw, y=y, groups=groups, augment_dir=args.augment_dir)
    print("fold scores:", [round(s, 4) for s in scores])
    return 0


def cmd_train_multimodal(args) -> int:
    """Multimodal training (``entry.train_multimodal``) with the per-epoch
    LIME snapshot and the training curves."""
    from . import entry, utils

    cfg = _load_cfg(args)
    lime_every = args.lime_every or (1 if args.demo else 0)
    try:
        trainer, best = entry.train_multimodal(
            args.ckpt_dir, device=args.device, epochs=args.epochs or 3,
            batch_size=args.batch_size or (8 if args.demo
                                           else cfg.trainer.batch_size),
            seed=args.seed, augment=cfg.augment, resume=args.resume,
            data_root=None if args.demo else cfg.paths,
            n_folds=cfg.n_folds, limit=args.limit, workers=args.workers,
            npy_dir=_npy_dir(args), init_from=args.init_from,
            signal=cfg.signal, lime_every=lime_every)
    except ValueError as e:
        if "--init-from" in str(e):
            raise SystemExit(str(e))
        raise
    p = utils.plot_training_curves(trainer.history, args.ckpt_dir,
                                   "multimodal_training_curves")
    print(f"best kldiv: {best:.4f}; curves: {p}")
    if lime_every:
        print(f"lime snapshots: {len(trainer.epoch_callbacks[-1].results)}")
    return 0


def _train_branch(args, which: str) -> int:
    from . import entry, utils

    arch = _check_arch(which, args.arch)
    cfg = _load_cfg(args)
    history, best = entry.train_branch(
        which, args.ckpt_dir, arch=arch, device=args.device,
        epochs=args.epochs or 3,
        batch_size=args.batch_size or (8 if args.demo
                                       else cfg.trainer.batch_size),
        seed=args.seed, data_root=None if args.demo else cfg.paths,
        augment=cfg.augment, resume=args.resume, n_folds=cfg.n_folds,
        limit=args.limit, workers=args.workers, npy_dir=_npy_dir(args),
        signal=cfg.signal)
    p = utils.plot_training_curves(history, args.ckpt_dir,
                                   f"{which}_training_curves")
    print(f"{which} branch best kldiv: {best:.4f}; curves: {p}")
    return 0


def cmd_train_eeg(args) -> int:
    """EEG-branch pretraining (``entry.train_branch("eeg")``)."""
    return _train_branch(args, "eeg")


def cmd_train_spectrogram(args) -> int:
    """Spectrogram-branch pretraining
    (``entry.train_branch("spectrogram")``)."""
    return _train_branch(args, "spectrogram")


def cmd_train_diffeeg(args) -> int:
    """DiffEEG diffusion training (``entry.train_diffeeg``): ``--demo``'s
    configuration, else ``cfg.diffeeg`` on the tree's windows."""
    import dataclasses

    from . import entry
    from .data import wavenet_arrays

    if args.demo:
        trainer, hist = entry.train_diffeeg(
            args.ckpt_dir, device=args.device, steps=args.epochs or 20,
            batch_size=args.batch_size, seed=args.seed, resume=args.resume)
        total = args.epochs or 20
    else:
        full = _load_cfg(args)
        src = wavenet_arrays(full.paths, cache_dir=args.ckpt_dir,
                             n_workers=args.workers, limit=args.limit)
        cfg = full.diffeeg
        if args.batch_size:
            cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
        total = args.epochs or cfg.min_steps
        trainer, hist = entry.train_diffeeg(
            args.ckpt_dir, device=args.device, raw=src["x"], y=src["y"],
            cfg=cfg, steps=total, seed=args.seed, resume=args.resume)
    if hist["loss"]:
        print(f"final loss: {hist['loss'][-1]:.4f}; "
              f"evals: {len(hist['eval'])}")
    else:
        print(f"nothing to do: resumed at step {int(trainer.state.step)} "
              f">= total {total}")
    return 0


def cmd_generate(args) -> int:
    """Class-conditional generation from the ``train-diffeeg`` checkpoint
    (``entry.generate``) → ``<ckpt-dir>/generated/generated_class_{c}.npy``."""
    from . import entry

    cfg = None if args.demo else _load_cfg(args).diffeeg
    try:
        paths = entry.generate(args.ckpt_dir, device=args.device,
                               demo=args.demo, cfg=cfg,
                               n_samples=args.n_samples, seed=args.seed)
    except FileNotFoundError as e:
        print(f"error: {e}")
        return 1
    for c, path in paths.items():
        print(f"class {c}: {np.load(path).shape} → {os.path.basename(path)}")
    print(f"generated dir: {os.path.join(args.ckpt_dir, 'generated')}")
    return 0


def cmd_grid_search(args) -> int:
    """WaveNet grid search (``entry.grid_search``): axes from ``--grid
    name=v1,v2,...`` (default ``lr=1e-3,3e-3,1e-2``; only ``lr`` steers
    the optimizer).  Prints the ranked table and the best point."""
    from . import entry, train
    from .models import DilatedInceptionWaveNet

    grid = {}
    for spec in args.grid or ["lr=1e-3,3e-3,1e-2"]:
        name, _, vals = spec.partition("=")
        if not vals:
            print(f"error: --grid {spec!r} is not name=v1,v2,...")
            return 1
        try:
            grid[name.strip()] = [float(v) for v in vals.split(",")]
        except ValueError:
            print(f"error: --grid {spec!r} has a non-numeric value "
                  "(grid axes must be numbers)")
            return 1

    common = dict(device=args.device, grid=grid, epochs=args.epochs or 2,
                  batch_size=args.batch_size or 16, seed=args.seed)
    if args.demo:
        rng = np.random.default_rng(args.seed)
        n = 32
        x = rng.standard_normal((n, 256, 8)).astype(np.float32)
        y = train.cv.aggregate_vote_labels(rng.integers(0, 10, (n, 6)))
        model = DilatedInceptionWaveNet(block_layers=(3, 2),
                                        block_dims=(8, 8))
        best, results = entry.grid_search(None, args.ckpt_dir, x=x, y=y,
                                          model=model, **common)
    else:
        best, results = entry.grid_search(
            _load_cfg(args).paths, args.ckpt_dir, limit=args.limit,
            workers=args.workers, **common)
    for r in results:
        print("  " + "  ".join(f"{k}={v:.4g}" for k, v in r.items()))
    print("best:", " ".join(f"{k}={v:.4g}" for k, v in best.items()))
    return 0


def cmd_sanity_check(args) -> int:
    """Autoencoder sanity training on synthetic digits
    (``entry.sanity_check``) with reconstruction grids every 10 epochs and
    at the last."""
    from . import entry, utils

    epochs = args.epochs or 50
    x16 = torch.as_tensor(entry.sanity_images(args.seed)[:16])

    def on_epoch(epoch, loss, model):
        if epoch % 10 == 0 or epoch == epochs - 1:
            with torch.no_grad():
                recon = model(x16.to(args.device)).cpu().numpy()
            utils.plot_sample_grid(recon.reshape(-1, 28, 28), args.ckpt_dir,
                                   f"sanity_recon_epoch{epoch}")
            print(f"epoch {epoch}: mse {loss:.5f}")

    entry.sanity_check(args.device, epochs=epochs, seed=args.seed,
                       on_epoch=on_epoch)
    return 0


# ---------------------------------------------------------------------------
# serving and attribution

def _load_torch_ckpt(path: str, model: torch.nn.Module) -> None:
    """Load a reference-layout combined ``MultimodalModel`` state dict
    (.pt: bare, or under ``model`` / ``state_dict`` / ``model_state_dict``)
    into ``model`` with ``strict=True``; BatchNorm's
    ``num_batches_tracked`` counters carry no weights and are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "fc1.weight" not in sd:
        for key in ("model", "state_dict", "model_state_dict"):
            if key in sd:
                sd = sd[key]
                break
    sd = {k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)
    print(f"imported torch multimodal checkpoint: {path}")


def _restore(args, model, fresh_ok: bool) -> bool:
    """Weights for ``model``: ``--torch-ckpt``, else the best
    ``train-multimodal`` checkpoint under ``<ckpt-dir>/multimodal``.
    Without one: seeded weights when ``fresh_ok`` (with a note), else
    False."""
    from .models import seeded_state_dict
    from .train import CheckpointManager

    if args.torch_ckpt:
        _load_torch_ckpt(args.torch_ckpt, model)
        return True
    mdir = os.path.join(args.ckpt_dir, "multimodal")
    best = os.path.join(mdir, "best-kldiv")
    if os.path.isdir(best):
        model.load_state_dict(CheckpointManager(mdir).load("best-kldiv")
                              ["model"])
        print("restored best multimodal checkpoint")
        return True
    if not fresh_ok:
        print(f"error: no multimodal checkpoint under {mdir} — run "
              "train-multimodal first")
        return False
    print("no checkpoint restored; using fresh init — train with "
          "`train-multimodal` first for meaningful attributions")
    model.load_state_dict(seeded_state_dict(model, args.seed))
    return True


def eval_metrics(probs: np.ndarray, y: np.ndarray) -> dict:
    """``predict --eval``'s scores of (N, 6) probabilities against (N, 6)
    targets: KL divergence, hard and soft accuracy, macro precision,
    recall and F1 (on log-probabilities clipped at 1e-12), and the (6, 6)
    confusion matrix (rows: true class)."""
    from . import train
    yt = torch.as_tensor(y, dtype=torch.float32)
    logp = torch.log(torch.as_tensor(probs).clamp(1e-12, 1.0))
    pred_c, true_c = logp.argmax(-1), yt.argmax(-1)
    prec, rec, f1 = train.macro_precision_recall_f1(pred_c, true_c, 6)
    return {"kldiv": float(train.kldiv_with_log_probs(logp, yt)),
            "accuracy": float(train.hard_accuracy(logp, yt)),
            "soft_accuracy": float(train.soft_accuracy(logp, yt)),
            "precision": float(prec), "recall": float(rec), "f1": float(f1),
            "confusion_matrix": train.confusion_matrix(pred_c, true_c,
                                                       6).numpy()}


def cmd_predict(args) -> int:
    """Batch inference with the trained multimodal model, the serving
    path: every row (or ``--limit``) through the device preprocess and
    forward in batches of a fixed size (the tail padded: on the card one
    captured CUDA graph, ``entry.capture_forward``) → ``predictions.csv``
    with each class's probability and the argmax class; ``--eval`` scores
    them against the rows' labels."""
    from . import config as C, entry
    from .data import (multimodal_source, synthetic_raw_eeg,
                       synthetic_raw_spectrogram)
    from .models import seeded_state_dict

    cfg = _load_cfg(args)
    dev = args.device
    bs = args.batch_size or (8 if args.demo else cfg.trainer.batch_size)
    if args.demo:
        rng = np.random.default_rng(args.seed)
        n = 12
        sig = C.SignalConfig(fixed_length=600, image_size=(80, 60))
        raw_eeg = synthetic_raw_eeg(n, rng, n_points=2000)
        raw_spec = synthetic_raw_spectrogram(n, rng, shape=(80, 60))
        y_demo = np.eye(6, dtype=np.float32)[rng.integers(0, 6, n)]
        ids = np.arange(n)

        def raw_batches():
            for s in range(0, n, bs):
                yield {"eeg": raw_eeg[s:s + bs], "spec": raw_spec[s:s + bs],
                       "y": y_demo[s:s + bs]}

        model = entry.build_model(600, 64 if args.torch_ckpt else 16,
                                  fused_blocks=args.fused_spec)
        if args.torch_ckpt:
            _load_torch_ckpt(args.torch_ckpt, model)
        else:
            model.load_state_dict(seeded_state_dict(model, args.seed))
        finite = False
    else:
        src = multimodal_source(cfg.paths, cache_dir=args.ckpt_dir,
                                n_workers=args.workers,
                                npy_dir=_npy_dir(args), limit=args.limit)
        n = len(src)
        ids = src.meta["eeg_id"]
        sig = cfg.signal

        def raw_batches():
            return src.batches(np.arange(n), bs, shuffle=False,
                               drop_last=False)

        model = entry.build_model(sig.fixed_length,
                                  fused_blocks=args.fused_spec)
        if not _restore(args, model, fresh_ok=False):
            return 1
        finite = True
    model.to(dev)
    forward = entry.make_forward(model, signal=sig, assume_finite=finite)

    def padded(batch):
        eeg_b, spec_b = batch["eeg"], batch["spec"]
        pad = bs - len(eeg_b)
        if pad:                       # static batch shape: pad + slice
            eeg_b = np.concatenate([eeg_b, np.repeat(eeg_b[-1:], pad, 0)])
            spec_b = np.concatenate([spec_b, np.repeat(spec_b[-1:], pad, 0)])
        return (torch.as_tensor(eeg_b).to(dev),
                torch.as_tensor(spec_b).to(dev)), pad

    fwd = entry.capture_forward(forward, padded(next(iter(raw_batches())))[0])
    probs, ys, fwd_ms = [], [], []
    _sync(dev)
    t0 = time.perf_counter()
    for batch in raw_batches():
        xs, pad = padded(batch)
        p, ms = _timed(dev, lambda: fwd(*xs).exp())
        fwd_ms.append(ms)
        p = p.cpu().numpy()
        probs.append(p[:len(p) - pad] if pad else p)
        if args.eval:
            ys.append(np.asarray(batch["y"]))
    probs = np.concatenate(probs)[:n]
    wall = time.perf_counter() - t0
    print(f"predict: {n} rows in {wall:.3f} s ({n / wall:.1f} rows/s end "
          f"to end: gather, copies, preprocess and forward); forward "
          f"{np.mean(fwd_ms):.3f} ms a batch of {bs} "
          f"({'one CUDA graph' if dev.type == 'cuda' else 'eager'})")

    out = os.path.join(args.ckpt_dir, "predictions.csv")
    pred = [C.CLASSES[i] for i in probs.argmax(1)]
    with open(out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["eeg_id", *(f"p_{c}" for c in C.CLASSES),
                    "predicted_class"])
        for i in range(n):
            w.writerow([ids[i], *(str(v) for v in probs[i]), pred[i]])
    print(f"wrote {n} predictions → {out}")
    names, counts = np.unique(pred, return_counts=True)
    for k in np.argsort(-counts, kind="stable"):
        print(f"{names[k]:<8}{counts[k]:>6}")

    if args.eval:
        from . import utils
        m = eval_metrics(probs, np.concatenate(ys)[:n])
        path = utils.plot_confusion_matrix(m["confusion_matrix"], C.CLASSES,
                                           args.ckpt_dir)
        print(f"eval over {n} rows: kldiv {m['kldiv']:.4f}  acc "
              f"{m['accuracy']:.3f}  soft-acc {m['soft_accuracy']:.3f}  "
              f"macro P/R/F1 {m['precision']:.3f}/{m['recall']:.3f}/"
              f"{m['f1']:.3f}")
        print(f"confusion matrix → {path}")
    return 0


def cmd_xai(args) -> int:
    """Attribution report on the multimodal model: saliency over both
    branches, integrated gradients (32 steps) and gradient SHAP (16
    samples) over the EEG branch, the top-10 channels (``--channel-retrain
    N``: a binary model retrained on the top N), LIME (40 segments, 200
    perturbations) over the spectrogram branch, Grad-CAM on the
    spectrogram CNN.  ``--demo``: synthetic data and seeded weights (or
    ``--torch-ckpt``); else the fold-0 validation rows (``--limit``, 32)
    explained against up to 100 training rows, with the best
    ``train-multimodal`` checkpoint (seeded weights, with a note, when
    there is none).  Plots and ``xai_report.json`` (times in ms, channels,
    LIME label) go to ``--ckpt-dir``."""
    from . import config as C, entry, utils, xai
    from .data import (multimodal_source, synthetic_raw_eeg,
                       synthetic_raw_spectrogram)
    from .ops import hms_eeg_preprocess, preprocess_multimodal
    from .train import stratified_kfold
    from .xai.callbacks import spectrogram_predict_fn

    dev = args.device
    rng = np.random.default_rng(args.seed)
    on = lambda a: torch.as_tensor(a).to(dev)
    if args.demo:
        sig = C.SignalConfig(fixed_length=600, image_size=(80, 60))
        raw_eeg = synthetic_raw_eeg(8, rng, n_points=2000)
        raw_spec = synthetic_raw_spectrogram(8, rng, shape=(80, 60))
        bg_raw = synthetic_raw_eeg(32, rng, n_points=2000)
        with torch.no_grad():
            eeg_in, spec_in = preprocess_multimodal(on(raw_eeg),
                                                    on(raw_spec), signal=sig)
            eeg_bg = hms_eeg_preprocess(on(bg_raw), signal=sig)
        y_in = np.eye(6, dtype=np.float32)[np.arange(8) % 6]
        y_bg = np.eye(6, dtype=np.float32)[np.arange(32) % 6]
        model = entry.build_model(600, 64 if args.torch_ckpt else 16,
                                  fused_blocks=args.fused_spec)
    else:
        cfg = _load_cfg(args)
        sig = cfg.signal
        src = multimodal_source(cfg.paths, cache_dir=args.ckpt_dir,
                                n_workers=args.workers,
                                npy_dir=_npy_dir(args))
        labels = np.asarray([C.NAME2LABEL[c]
                             for c in src.meta["expert_consensus"]])
        tr_idx, va_idx = stratified_kfold(labels, n_splits=cfg.n_folds,
                                          seed=args.seed)[0]
        n = min(args.limit or 32, len(va_idx))
        batch = src.gather(np.asarray(va_idx[:n]))
        bg = src.gather(np.asarray(tr_idx[:min(100, len(tr_idx))]),
                        want=("eeg",))
        with torch.no_grad():
            eeg_in, spec_in = preprocess_multimodal(
                on(batch["eeg"]), on(batch["spec"]), signal=sig,
                assume_finite=True)
            eeg_bg = hms_eeg_preprocess(on(bg["eeg"]), signal=sig,
                                        assume_finite=True)
        y_in, y_bg = batch["y"], bg["y"]
        model = entry.build_model(sig.fixed_length,
                                  fused_blocks=args.fused_spec)
    if args.demo and not args.torch_ckpt:
        from .models import seeded_state_dict
        model.load_state_dict(seeded_state_dict(model, args.seed))
    else:
        _restore(args, model, fresh_ok=True)
    model.to(dev).requires_grad_(False)
    times = {}
    names = xai.channel_select.channel_names_37()

    (ge, gs), times["saliency"] = _timed(
        dev, lambda: xai.multimodal_saliency(model, eeg_in, spec_in))
    utils.plot_saliency_heatmap(ge[0, 0].cpu().numpy(), args.ckpt_dir,
                                "eeg_saliency", names)
    ig, times["integrated_gradients"] = _timed(
        dev, lambda: xai.integrated_gradients(model.forward_eeg, eeg_in[:2],
                                              steps=32))
    gen = torch.Generator(device=dev).manual_seed(0)
    shap_vals, times["gradient_shap"] = _timed(
        dev, lambda: xai.gradient_shap_values(model.forward_eeg, eeg_in[:2],
                                              eeg_bg, gen, nsamples=16))
    comp = float(ig.reshape(len(ig), -1).abs().sum() / len(ig))
    print(f"IG: mean |attr| mass per sample {comp:.4f} "
          f"(completeness-tested quadrature)")
    shap_np = shap_vals.cpu().numpy()
    idx, _ = xai.get_top_n_channels(shap_np, n=10)
    print("top-10 channels:", [names[i] for i in idx])

    if args.channel_retrain:
        eeg_all = np.concatenate([eeg_in.cpu().numpy(),
                                  eeg_bg.cpu().numpy()])
        y_all = np.concatenate([np.asarray(y_in), np.asarray(y_bg)])
        rep = xai.retrain_on_top_channels(
            eeg_all, y_all, shap_np, n_channels=args.channel_retrain,
            positive_class=args.channel_class, epochs=args.epochs or 2,
            batch_size=args.batch_size or 8, seed=args.seed,
            model_kwargs=dict(samples=int(eeg_in.shape[-1]),
                              kern_length=16 if args.demo else 64),
            ckpt_dir=os.path.join(args.ckpt_dir, "channel_retrain"),
            device=dev)
        print(f"channel-retrain: top-{args.channel_retrain} channels "
              f"{[names[i] for i in rep['top_channels']]} "
              f"(class {rep['positive_class']} one-vs-rest): "
              f"fresh kldiv {rep['fresh']['kldiv']:.4f} / "
              f"acc {rep['fresh']['accuracy']:.3f} → retrained "
              f"{rep['retrained']['kldiv']:.4f} / "
              f"acc {rep['retrained']['accuracy']:.3f}")

    img = spec_in[0].permute(1, 2, 0).cpu().numpy()
    seg, times["lime_slic"] = _timed(
        dev, lambda: xai.slic_segments(img, 40))
    res, times["lime_forwards"] = _timed(
        dev, lambda: xai.lime_explain(spectrogram_predict_fn(model, dev),
                                      img, segments=seg, num_samples=200,
                                      seed=args.seed))
    xai.plot_lime_overlay(img, res, args.ckpt_dir)
    print(f"LIME top label {res['label']}; "
          f"{int(res['mask'].sum())} px in top segments "
          f"(overlay → {args.ckpt_dir}/lime_overlay.png)")

    cam, times["grad_cam"] = _timed(
        dev, lambda: xai.grad_cam(model.spectrogram_model, spec_in[:2],
                                  upsample_to=tuple(spec_in.shape[-2:])))
    utils.plot_saliency_heatmap(cam[0].cpu().numpy(), args.ckpt_dir,
                                "spec_gradcam")
    print(f"Grad-CAM heatmap {tuple(cam.shape)} saved")
    print("xai times (ms): " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in times.items()))
    with open(os.path.join(args.ckpt_dir, "xai_report.json"), "w") as f:
        json.dump({"times_ms": times, "top_channels": [names[i] for i in idx],
                   "ig_mass": comp, "lime_label": res["label"],
                   "lime_segments": int(seg.max()) + 1,
                   "explained": int(len(eeg_in))}, f)
    return 0


# ---------------------------------------------------------------------------
# host commands and the commands not ported yet

def cmd_dump_config(args) -> int:
    """The effective configuration (defaults + ``--config`` + ``--set``)
    as YAML that ``--config`` reads back."""
    from . import config as C
    print(C.dump_yaml(_load_cfg(args)), end="")
    return 0


def cmd_cache_build(args) -> int:
    """Crop every ``train.csv`` recording into the window cache
    ``<ckpt-dir>/eeg_cache.npz`` (reads parquet: needs pandas)."""
    from .data import EEGRecordCache, load_train_metadata
    from .data.hms import unique_in_order

    cfg = _load_cfg(args)
    meta = load_train_metadata(cfg.paths.train_csv)
    cache = EEGRecordCache(os.path.join(args.ckpt_dir, "eeg_cache.npz"))
    cache.build(cfg.paths.train_eegs, unique_in_order(meta["eeg_id"]),
                n_workers=args.workers)
    cache.save()
    print(f"cached {len(cache)} records")
    return 0


def _convert_one(fname: str, src: str, dst: str) -> int:
    from .data import load_spectrogram_parquet
    arr = load_spectrogram_parquet(os.path.join(src, fname))
    arr = np.nan_to_num(arr, nan=0.0).T.astype(np.float32)  # (Freq, Time)
    np.save(os.path.join(dst, fname.replace(".parquet", ".npy")), arr)
    return 1


def cmd_convert_spectrograms(args) -> int:
    """Every spectrogram parquet under ``paths.train_spectr`` → ``.npy``
    (NaN → 0, stored (Freq, Time)) in ``<ckpt-dir>/spectrograms_npy``
    (needs pandas): the first file in this process, so that a missing
    pandas stops the command with the loader's error before any worker
    starts, the rest by a pool of ``--workers`` spawned processes."""
    import multiprocessing as mp
    from functools import partial

    cfg = _load_cfg(args)
    src = cfg.paths.train_spectr
    dst = os.path.join(args.ckpt_dir, "spectrograms_npy")
    os.makedirs(dst, exist_ok=True)
    files = sorted(f for f in os.listdir(src) if f.endswith(".parquet"))
    one = partial(_convert_one, src=src, dst=dst)
    n = sum(one(f) for f in files[:1])
    if files[1:]:
        with mp.get_context("spawn").Pool(max(1, args.workers)) as pool:
            n += sum(pool.map(one, files[1:]))
    print(f"converted {n} spectrograms → {dst}")
    return 0


def _not_ported(what: str, by: str) -> int:
    print(f"error: {what} is not ported yet: {by} brings it",
          file=sys.stderr)
    return 2


def cmd_long_eeg(args) -> int:
    """The long-EEG sequence-parallel demo: not ported yet."""
    return _not_ported("long-eeg", PARALLEL_SLICE)


def cmd_bench(args) -> int:
    """The throughput benchmark: not ported yet."""
    return _not_ported("bench", BENCH_SLICE)


COMMANDS = {
    "train-wavenet": cmd_train_wavenet,
    "train-multimodal": cmd_train_multimodal,
    "train-eeg": cmd_train_eeg,
    "train-spectrogram": cmd_train_spectrogram,
    "train-diffeeg": cmd_train_diffeeg,
    "generate": cmd_generate,
    "predict": cmd_predict,
    "xai": cmd_xai,
    "cache-build": cmd_cache_build,
    "long-eeg": cmd_long_eeg,
    "convert-spectrograms": cmd_convert_spectrograms,
    "grid-search": cmd_grid_search,
    "sanity-check": cmd_sanity_check,
    "bench": cmd_bench,
    "dump-config": cmd_dump_config,
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="multimodal_brain_pattern_identification_xai_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name in COMMANDS:
        _add_common(sub.add_parser(name))
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    from . import resolve_device

    args = build_parser().parse_args(argv)
    if args.mesh > 1:
        return _not_ported(f"--mesh {args.mesh}", PARALLEL_SLICE)
    if args.cmd not in HOST_COMMANDS + ("long-eeg", "bench"):
        try:
            args.device = resolve_device(args.device)
        except RuntimeError as e:
            print(f"error: {e} (--device cpu)", file=sys.stderr)
            return 1
    os.makedirs(args.ckpt_dir, exist_ok=True)
    return COMMANDS[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
