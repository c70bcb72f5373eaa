"""The port's ``ResilientRunner`` (``mma_tpu_torch.train.resilience``): the
three ``TestResilience`` cases of ``tests/test_training.py``, ported, and
the same fault schedule through the JAX package's runner and the port's.

The step is the JAX test's: Adam at lr 1e-2 on ``mean((batch @ w)²)``,
over numpy-seeded batches. The port's step is a function of its payload
``{"w", "opt"}`` (the weights and Adam's ``state_dict``), as the runner
asks: it loads copies of both, steps, and returns the new ones.
"""

import copy

import numpy as np
import pytest
import torch

from mma_tpu_torch.train import FailureRecord, ResilientRunner

LR = 1e-2


def _batches():
    rs = np.random.RandomState(0)
    w0 = rs.randn(8, 4).astype(np.float32)
    return w0, [rs.randn(16, 8).astype(np.float32) for _ in range(8)]


def _step(state, batch):
    # Optimizer.load_state_dict keeps the given moment tensors, which the
    # step then updates in place: load a copy, so the payload stays as given.
    w = state["w"].clone().requires_grad_()
    opt = torch.optim.Adam([w], lr=LR)
    opt.load_state_dict(copy.deepcopy(state["opt"]))
    loss = ((torch.from_numpy(batch) @ w) ** 2).mean()
    opt.zero_grad()
    loss.backward()
    opt.step()
    return {"w": w.detach(), "opt": opt.state_dict()}, loss.detach()


def _setup():
    w0, batches = _batches()
    w = torch.from_numpy(w0)
    opt = torch.optim.Adam([w.clone().requires_grad_()], lr=LR)
    return {"w": w, "opt": opt.state_dict()}, batches


def _schedule():
    visits = {}

    def inject(i):
        visits[i] = visits.get(i, 0) + 1
        if i == 3 and visits[i] <= 2:
            return "injected"  # a deterministic bad batch: skipped
        if i == 5 and visits[i] == 1:
            return "injected"  # transient: retried once, succeeds
        return None

    return inject


def test_recovers_from_injected_faults(tmp_path):
    state0, batches = _setup()
    runner = ResilientRunner(str(tmp_path / "ckpt"), checkpoint_every=2, max_restarts=5,
                             inject_fault=_schedule())
    final = runner.run(_step, state0, batches)
    assert [(f.step, f.kind, f.restored_step) for f in runner.failures] == [
        (3, "injected", 2), (3, "injected", 2), (5, "injected", 2)]
    # The recovered run equals a clean run over the same batches with the
    # deterministically bad batch removed.
    expect = ResilientRunner(str(tmp_path / "clean"), checkpoint_every=0).run(
        _step, state0, [b for i, b in enumerate(batches) if i != 3])
    torch.testing.assert_close(final["w"], expect["w"], rtol=0, atol=1e-6)


def test_recovers_from_raised_and_nonfinite_steps(tmp_path):
    """A step that raises and a step whose loss is NaN are caught, retried
    once from the last checkpoint, and the run goes on."""
    state0, batches = _setup()
    calls = {}

    def step(state, batch):
        i = next(j for j, b in enumerate(batches) if b is batch)
        calls[i] = calls.get(i, 0) + 1
        if i == 1 and calls[i] == 1:
            raise RuntimeError("device lost")
        new, loss = _step(state, batch)
        return new, (torch.tensor(float("nan")) if i == 4 and calls[i] == 1 else loss)

    runner = ResilientRunner(str(tmp_path / "ckpt"), checkpoint_every=2)
    final = runner.run(step, state0, batches)
    assert [(f.step, f.kind) for f in runner.failures] == [(1, "exception"),
                                                           (4, "nonfinite-loss")]
    assert "device lost" in runner.failures[0].detail
    expect = ResilientRunner(str(tmp_path / "clean"), checkpoint_every=0).run(
        _step, state0, batches)
    torch.testing.assert_close(final["w"], expect["w"], rtol=0, atol=0)


def test_crash_loop_raises(tmp_path):
    state0, batches = _setup()
    runner = ResilientRunner(str(tmp_path / "ckpt"), checkpoint_every=1, max_restarts=2,
                             inject_fault=lambda i: "injected" if i >= 1 else None)
    with pytest.raises(RuntimeError, match="max_restarts"):
        runner.run(_step, state0, batches)


def test_resume_from_disk(tmp_path):
    state0, batches = _setup()
    d = str(tmp_path / "ckpt")
    ResilientRunner(d, checkpoint_every=2).run(_step, state0, batches[:4])
    # A "new process" resumes from the checkpoint on disk and finishes the
    # remaining batches.
    final = ResilientRunner(d, checkpoint_every=2).run(_step, state0, batches)
    expect = ResilientRunner(str(tmp_path / "clean"), checkpoint_every=0).run(
        _step, state0, batches)
    torch.testing.assert_close(final["w"], expect["w"], rtol=0, atol=1e-6)


def test_same_schedule_as_the_jax_runner(tmp_path):
    """The fault schedule through both runners: equal ``FailureRecord``
    lists, and the final weights within the rule of
    ``tests/test_torch_training.py::test_adam_steps_match_jax`` (1e-5 where
    the first gradient is not rounding noise, 2·lr·steps elsewhere)."""
    import jax
    import jax.numpy as jnp
    import optax

    from mma_tpu.train.resilience import ResilientRunner as JaxResilientRunner

    w0, batches = _batches()
    opt = optax.adam(LR)

    def loss_fn(p, b):
        return jnp.mean((b @ p) ** 2)

    @jax.jit
    def jstep(state, batch):
        params, opt_state = state
        loss, g = jax.value_and_grad(loss_fn)(params, batch)
        updates, opt_state = opt.update(g, opt_state, params)
        return (optax.apply_updates(params, updates), opt_state), loss

    jw0 = jnp.asarray(w0)
    jrunner = JaxResilientRunner(str(tmp_path / "jax"), checkpoint_every=2, max_restarts=5,
                                 inject_fault=_schedule())
    jfinal = jrunner.run(jstep, (jw0, opt.init(jw0)), [jnp.asarray(b) for b in batches])
    state0, _ = _setup()
    runner = ResilientRunner(str(tmp_path / "port"), checkpoint_every=2, max_restarts=5,
                             inject_fault=_schedule())
    final = runner.run(_step, state0, batches)

    assert runner.failures == [FailureRecord(**vars(f)) for f in jrunner.failures]
    g1 = np.abs(np.asarray(jax.grad(loss_fn)(jw0, jnp.asarray(batches[0]))))
    sure = g1 > 1e-3 * g1.max()
    diff = np.abs(final["w"].numpy() - np.asarray(jfinal[0]))
    steps = len(batches) - 1  # the bad batch is skipped
    assert diff[sure].max(initial=0.0) <= 1e-5
    assert diff.max() <= 2 * LR * steps
