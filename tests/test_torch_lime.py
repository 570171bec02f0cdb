"""The port's LIME (``xai/lime.py``) and its per-epoch snapshot
(``xai/callbacks.py``) against the JAX package on the CPU: SLIC segments
and boundary marks equal to JAX's; ``lime_explain`` with a numpy
``predict_fn`` equal to JAX's (weights 1e-12) and chunked bitwise equal
to one call; through the port's spectrogram CNN and JAX's flax one on
carried weights (probabilities 1e-5, weights 1e-4 of the largest); the
snapshot in a 2-epoch demo ``train_multimodal`` leaves training bitwise
unchanged, restores the model's mode and equals LIME run by hand on the
model in eval mode."""

import jax
import numpy as np
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu.xai import lime as jlime
from multimodal_brain_pattern_identification_xai_tpu_torch import entry
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch.xai import (
    LimeEpochSnapshot, callbacks, lime)

SEED = 42


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(shape, seed):
    """A smooth image with structure for SLIC to find, plus noise."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.sin(6 * yy) * np.cos(5 * xx) + 0.3 * rng.standard_normal((h, w))
    if len(shape) == 3:
        base = base[..., None] * np.linspace(0.5, 1.5, shape[2])
    return ((base - base.min()) / np.ptp(base)).astype(np.float32)


@pytest.mark.parametrize("shape,n_segments", [((40, 30), 12),
                                              ((37, 29, 3), 20),
                                              ((80, 60, 3), 40)])
def test_slic_and_boundaries_equal_jax(shape, n_segments):
    """(37, 29): the grid step does not divide either side."""
    img = _image(shape, SEED)
    seg = lime.slic_segments(img, n_segments)
    np.testing.assert_array_equal(seg, jlime.slic_segments(img, n_segments))
    assert seg.dtype == np.int32 and seg.min() == 0
    np.testing.assert_array_equal(lime.mark_boundaries(img, seg),
                                  jlime.mark_boundaries(img, seg))


def _numpy_predict(shape, seed):
    """A row-wise numpy classifier: six weight maps, softmax."""
    w = np.random.default_rng(seed).standard_normal((6, *shape))

    def predict(batch):
        logits = np.stack([(batch * w[c]).sum(axis=(1, 2, 3))
                           for c in range(6)], axis=1)
        e = np.exp(logits - logits.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)
    return predict


def test_lime_numpy_predict_equals_jax_and_chunks_are_bitwise():
    img = _image((40, 30, 3), 3)
    predict = _numpy_predict(img.shape, 4)
    kw = dict(n_segments=15, num_samples=64, seed=SEED)
    got = lime.lime_explain(predict, img, chunk=None, **kw)
    want = jlime.lime_explain(predict, img, **kw)
    np.testing.assert_array_equal(got["segments"], want["segments"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    assert got["label"] == want["label"]
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-12)
    calls = []
    chunked = lime.lime_explain(lambda b: calls.append(len(b)) or predict(b),
                                img, chunk=7, **kw)
    assert max(calls) == 7 and sum(calls) == 64
    for k in ("segments", "weights", "heatmap", "mask", "probs"):
        np.testing.assert_array_equal(chunked[k], got[k])
    assert chunked["label"] == got["label"]


def test_lime_through_the_spectrogram_branch_matches_flax():
    """LIME over the port's ``SpectrogramCNN`` and JAX's on the same
    weights (flax's init, carried by ``jax_variables_to_state_dict``),
    80×60, 20 segments, 32 perturbations."""
    img = _image((80, 60, 3), 5)
    fm = jm.SpectrogramCNN()
    variables = fm.init(jax.random.PRNGKey(11),
                        np.zeros((1, 3, 80, 60), np.float32))
    apply = jax.jit(lambda x: jax.numpy.exp(fm.apply(variables, x)))
    jpredict = lambda b: np.asarray(apply(b.transpose(0, 3, 1, 2)))
    model = tm.SpectrogramCNN()
    model.load_state_dict(tm.jax_variables_to_state_dict(variables))
    model.eval()
    holder = type("M", (), {"forward_spectrogram": model})
    kw = dict(n_segments=20, num_samples=32, seed=SEED)
    got = lime.lime_explain(callbacks.spectrogram_predict_fn(
        holder, torch.device("cpu")), img, **kw)
    jprobs = []
    want = jlime.lime_explain(lambda b: jprobs.append(jpredict(b))
                              or jprobs[-1], img, **kw)
    top2 = np.sort(got["probs"][0])[-2:]
    assert top2[1] - top2[0] > 1e-3          # the label is not a tie
    np.testing.assert_allclose(got["probs"], np.concatenate(jprobs),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["segments"], want["segments"])
    assert got["label"] == want["label"]
    np.testing.assert_array_equal(got["mask"], want["mask"])
    scale = np.abs(want["weights"]).max()
    np.testing.assert_allclose(got["weights"], want["weights"], rtol=0,
                               atol=1e-4 * scale)


class _Record:
    """An epoch callback keeping the model's state and mode."""

    def __init__(self, set_train=False):
        self.states, self.modes, self.set_train = [], [], set_train

    def __call__(self, trainer, epoch, val_result):
        model = trainer.state.model
        if self.set_train:
            model.train()
        self.modes.append(model.training)
        self.states.append({k: v.clone()
                            for k, v in model.state_dict().items()})


def test_lime_snapshot_leaves_training_bitwise(tmp_path):
    """Two demo epochs with the snapshot (and the model put in training
    mode before it) against two without: every epoch's parameters and
    BatchNorm buffers and the final ones bitwise equal; the mode restored;
    each snapshot's weights those of LIME run by hand on that epoch's
    model in eval mode."""
    before, after = _Record(set_train=True), _Record()
    sample = np.random.default_rng(3).random((3, 80, 60)).astype(np.float32)
    snap = LimeEpochSnapshot(sample, str(tmp_path / "lime"), n_segments=12,
                             num_samples=24, seed=SEED)
    tr_a, best_a = entry.train_multimodal(
        str(tmp_path / "a"), device="cpu", epochs=2, batch_size=24,
        seed=SEED, epoch_callbacks=[before, snap, after])
    plain = _Record()
    tr_b, best_b = entry.train_multimodal(
        str(tmp_path / "b"), device="cpu", epochs=2, batch_size=24,
        seed=SEED, epoch_callbacks=[plain])
    assert len(snap.results) == 2 and best_a == best_b
    assert before.modes == after.modes == [True, True]
    for sa, sb in zip(before.states, plain.states):
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    fa = tr_a.state.model.state_dict()
    fb = tr_b.state.model.state_dict()
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    model = entry.build_train_model(samples=600, kern_length=16)
    for state, res in zip(before.states, snap.results):
        model.load_state_dict(state)
        model.eval()
        want = lime.lime_explain(
            callbacks.spectrogram_predict_fn(model, torch.device("cpu")),
            sample.transpose(1, 2, 0), n_segments=12, num_samples=24,
            seed=SEED)
        assert res["label"] == want["label"]
        np.testing.assert_array_equal(res["weights"], want["weights"])
