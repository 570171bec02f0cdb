"""The port's grid search against the JAX package's: the step over stacked
candidates (``make_grid_step``, a loop over the candidates) from carried
weights against optax ``inject_hyperparams(adam)`` vmapped over the same
candidates (float64 on both sides, rel 1e-5) and bitwise against each
candidate's ``make_train_step``, and ``parallel_grid_search``'s ranked
output, which has the JAX function's shape."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_brain_pattern_identification_xai_tpu import models as jm
from multimodal_brain_pattern_identification_xai_tpu import train as jt
from multimodal_brain_pattern_identification_xai_tpu_torch import models as tm
from multimodal_brain_pattern_identification_xai_tpu_torch import train as tt
from multimodal_brain_pattern_identification_xai_tpu_torch.data import (
    batch_iterator)

SMALL = dict(block_layers=(1,), block_dims=(8,))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these small programs gain nothing from more,
    and beside other test processes more threads only contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=4, length=128, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, length, 8)).astype(np.float32)
    y = rng.random((n, 6)).astype(np.float32)
    return x, y / y.sum(1, keepdims=True)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def candidate(tree, g):
    """Candidate g's parameters of a stacked flax tree as a state dict."""
    return tm.jax_variables_to_state_dict(
        {"params": jax.tree_util.tree_map(lambda a: a[g], tree)})


def test_grid_step_matches_optax_vmapped():
    """Two candidates (lr 1e-3 and 1e-2) for two steps on two batches: each
    candidate's losses, parameters, Adam moments, step count and injected
    learning rate against the JAX package's step (``inject_hyperparams(
    adam)`` with the candidate's ``learning_rate``, vmapped)."""
    model = jm.DilatedInceptionWaveNet(**SMALL)
    x, y = _data(8)
    hp = np.array([[1e-3], [1e-2]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    params0 = jax.jit(jax.vmap(lambda k: model.init(
        {"params": k}, jnp.asarray(x[:2]))["params"]))(keys)
    with jax.enable_x64(True):
        tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                   params0)
        o = jax.vmap(tx.init)(p)

        @jax.jit
        def step_all(p, o, hp, bx, by):
            def one(pi, oi, hi):
                li, gi = jax.value_and_grad(lambda q: jt.kldiv_with_logits(
                    model.apply({"params": q}, bx, True), by))(pi)
                oi.hyperparams["learning_rate"] = hi[0]
                u, oi = tx.update(gi, oi, pi)
                return optax.apply_updates(pi, u), oi, li
            return jax.vmap(one)(p, o, hp)

        want_losses = []
        for s in (0, 4):
            p, o, li = step_all(p, o, jnp.asarray(hp, jnp.float64),
                                jnp.asarray(x[s:s + 4], jnp.float64),
                                jnp.asarray(y[s:s + 4], jnp.float64))
            want_losses.append(np.asarray(li))
        p, o = jax.tree_util.tree_map(np.asarray, (p, o))

    port = tm.DilatedInceptionWaveNet(**SMALL).double()
    sds = [candidate(params0, g) for g in range(2)]
    params = {n: torch.stack([sd[n] for sd in sds]).double()
              for n, _ in port.named_parameters()}
    _, opt = tt.init_candidates(port, 2)
    step = tt.make_grid_step(port, tt.kldiv_with_logits, lr_col=0)
    for k, s in enumerate((0, 4)):
        params, opt, losses = step(
            params, opt, torch.tensor(hp, dtype=torch.float64),
            torch.tensor(x[s:s + 4]).double(),
            torch.tensor(y[s:s + 4]).double())
        assert rel(losses.detach(), want_losses[k]) < 1e-5
    assert opt["count"].tolist() == [2, 2]
    assert opt["lr"].tolist() == pytest.approx([1e-3, 1e-2])
    np.testing.assert_allclose(np.asarray(o.hyperparams["learning_rate"]),
                               [1e-3, 1e-2], rtol=1e-6)
    for g in range(2):
        want, mu = candidate(p, g), candidate(o.inner_state[0].mu, g)
        off = 0
        for name, prm in port.named_parameters():
            assert rel(params[name][g].detach(), want[name]) < 1e-5, name
            n = prm.numel()
            got_mu = opt["mu"][g, off:off + n].view_as(prm)
            assert rel(got_mu, mu[name]) < 1e-5, name
            off += n


def test_parallel_grid_search_ranks_and_has_jax_shape():
    """A 2 × 2 grid (``lr`` and a carried-through ``gamma``): four results
    of the grid values and ``loss``, the keys and order of the JAX
    function's, ranked by the last step's loss, the best first; each
    candidate's loss is the one it reaches trained alone with the port's
    Adam (rel 1e-4)."""
    x, y = _data(4, seed=1)
    grid = {"lr": [1e-3, 1e-2], "gamma": [0.5, 0.9]}

    def batches():
        return batch_iterator({"x": x, "y": y}, 2, shuffle=True, seed=4)

    port = tm.DilatedInceptionWaveNet(**SMALL)
    best, results = tt.parallel_grid_search(
        port, (torch.from_numpy(x[:2]),), batches, grid,
        tt.kldiv_with_logits, epochs=2, seed=7)
    jbest, jresults = jt.parallel_grid_search(
        jm.DilatedInceptionWaveNet(**SMALL), (x[:2],), batches, grid,
        jt.kldiv_with_logits, epochs=2, seed=7)
    assert len(results) == len(jresults) == 4
    assert [list(r) for r in results] == [list(r) for r in jresults]
    assert list(best) == list(jbest) == ["lr", "gamma", "loss"]
    assert best == results[0]
    assert [r["loss"] for r in results] == sorted(r["loss"] for r in results)
    assert sorted((r["lr"], r["gamma"]) for r in results) == sorted(
        (r["lr"], r["gamma"]) for r in jresults)
    combos = [(lr, g) for lr in grid["lr"] for g in grid["gamma"]]
    for k, (lr, g) in enumerate(combos):
        m = tm.DilatedInceptionWaveNet(**SMALL)
        m.load_state_dict(tm.seeded_state_dict(m, 7 + k))
        state = tt.create_train_state(m, tt.make_optimizer(np.float32(lr)))
        step = tt.make_train_step()
        for _ in range(2):
            for b in batches():
                state, metrics = step(state, {k2: torch.from_numpy(v)
                                              for k2, v in b.items()})
        got = next(r for r in results
                   if (r["lr"], r["gamma"]) == pytest.approx((lr, g)))
        assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-4)


@pytest.mark.parametrize("lr_col", [0, None])
def test_grid_step_is_the_train_step_per_candidate(lr_col):
    """The step over the stacked candidates runs each candidate through
    the arithmetic of ``train.make_train_step``: three candidates, two
    steps, each candidate's losses, parameters and Adam state bitwise equal
    to the same candidate trained alone at its learning rate (the
    optimizer's 1e-3 when ``lr_col`` is None); the stacks given to a step
    are left as they were."""
    x, y = _data(8, seed=2)
    hp = np.array([[1e-3], [3e-3], [1e-2]], np.float32)
    port = tm.DilatedInceptionWaveNet(**SMALL)
    params, opt = tt.init_candidates(port, 3, seed=5)
    step = tt.make_grid_step(port, tt.kldiv_with_logits, lr_col=lr_col)
    batches = [(torch.from_numpy(x[s:s + 4]), torch.from_numpy(y[s:s + 4]))
               for s in (0, 4)]
    losses = []
    for bx, by in batches:
        kept = {n: v.clone() for n, v in params.items()}
        new, opt, loss = step(params, opt, torch.from_numpy(hp), bx, by)
        assert all(torch.equal(params[n], kept[n]) for n in params)
        params = new
        losses.append(loss)
    for g in range(3):
        m = tm.DilatedInceptionWaveNet(**SMALL)
        m.load_state_dict(tm.seeded_state_dict(m, 5 + g))
        lr = hp[g, 0] if lr_col is not None else 1e-3
        state = tt.create_train_state(m, tt.make_optimizer(lr))
        one = tt.make_train_step()
        for k, (bx, by) in enumerate(batches):
            state, metrics = one(state, {"x": bx, "y": by})
            assert torch.equal(losses[k][g], metrics["loss"])
        for name, prm in m.named_parameters():
            assert torch.equal(params[name][g], prm.detach()), name
        for key in ("mu", "nu", "count"):
            assert torch.equal(opt[key][g], state.opt_state[key]), key
