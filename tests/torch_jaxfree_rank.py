"""A rank function for the port's isolation test.  It first records
whether anything of JAX is loaded (the port's launch code has run by
then), then blocks jax, flax and the JAX package in the rank's
interpreter, so that an import of any of them by the parallel modules it
loads next raises.  Importing this module does nothing (the test process
imports it to send the function)."""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "multimodal_brain_pattern_identification_xai_tpu")


def _loaded():
    return sorted(m for m, mod in sys.modules.items()
                  if m.split(".")[0] in FORBIDDEN and mod is not None)


def dp_step_once(dev):
    """One data-parallel step of a small EEGNet on this rank's rows, with
    JAX blocked."""
    loaded_before = _loaded()
    for m in FORBIDDEN:
        sys.modules[m] = None
    import numpy as np
    import torch

    from multimodal_brain_pattern_identification_xai_tpu_torch import (
        config as C, models, parallel, train, xai)
    from multimodal_brain_pattern_identification_xai_tpu_torch.parallel import (
        dryrun, seqparallel, tp)
    del xai, dryrun, seqparallel, tp
    mesh = parallel.make_mesh(C.MeshConfig(data=2), dev)
    model = models.EEGNet(samples=128, kern_length=8)
    model.load_state_dict(models.seeded_state_dict(model, 0))
    state = train.create_train_state(model, train.make_optimizer(1e-3))
    rng = np.random.default_rng(0)
    batch = parallel.shard_batch(mesh, {
        "x": rng.standard_normal((4, 1, 37, 128)).astype(np.float32),
        "y": np.eye(6, dtype=np.float32)[rng.integers(0, 6, 4)]})
    step = parallel.make_parallel_train_step(mesh, state)
    state, m = step(state, batch, torch.Generator().manual_seed(1))
    return {"loaded_before": loaded_before, "loss": float(m["loss"]),
            "nonfinite": bool(m["nonfinite"]), "step": state.step,
            "loaded_after": _loaded()}
