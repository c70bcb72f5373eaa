"""Failure detection and a checkpoint-restart step loop.

The port of the JAX package's ``mma_tpu/train/resilience.py`` (the
reference has no failure story: a crash loses the run):

- **failure detection**: every step's loss is checked for finiteness
  (NaN/Inf: divergence, a bad batch, silent data corruption) and the step
  is guarded against exceptions (a device error, out of memory);
- **checkpoint-restart**: periodic checkpoints of the whole training
  payload (:mod:`mma_tpu_torch.train.checkpoint`); on a failure the runner
  restores the last good checkpoint and replays from the batch after it,
  with bounded retries so that a crash loop fails loudly;
- **fault injection**: the ``inject_fault`` hook forces a failure at a
  chosen step, for tests and chaos drills.

Usage::

    runner = ResilientRunner(ckpt_dir, checkpoint_every=50)
    state = runner.run(step_fn, state, batches)

``step_fn(state, batch) -> (state, loss)`` must be a function of its
arguments, as a jitted JAX step is: restoring a checkpoint and replaying
the later batches is then exactly the computation an uninterrupted run
would have done from that point. In PyTorch that has a consequence for
in-place state: **the payload is the state, not the module.** The runner
rebinds ``state`` to what each restore returns, and a module or optimizer
that a failed step updated in place is not rolled back with it. So
``step_fn`` loads the model's and optimizer's state from ``state`` at
every call (``load_state_dict``), and returns a new payload that shares no
tensor with the live module (clones), which ``save_checkpoint`` can hold.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterable, Optional, Tuple

from mma_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint


@dataclasses.dataclass
class FailureRecord:
    step: int
    kind: str  # "nonfinite-loss" | "exception" | "injected"
    detail: str
    restored_step: Optional[int]


@dataclasses.dataclass
class ResilientRunner:
    """Checkpoint-restart step loop with failure detection.

    ``checkpoint_every``: save the payload every N successful steps (step 0
    is always saved, so that a first-step failure can restore).
    ``max_restarts``: the failures tolerated before raising: a crash loop
    (a deterministic NaN, say) should fail loudly, not spin forever.
    """

    ckpt_dir: str
    checkpoint_every: int = 50
    max_restarts: int = 3
    inject_fault: Optional[Callable[[int], Optional[str]]] = None

    def __post_init__(self):
        self.failures = []  # FailureRecord log, inspectable after run

    def _detect(self, step: int, loss) -> Optional[str]:
        if self.inject_fault is not None:
            kind = self.inject_fault(step)
            if kind:
                return kind
        if loss is not None and not math.isfinite(float(loss)):
            return "nonfinite-loss"
        return None

    def _restore(self, step: int) -> Any:
        # The payload comes back as it was saved (on the devices it was
        # saved from): a step's structure may grow, as an optimizer's
        # state does at its first step, so no fixed target describes it.
        return restore_checkpoint(self.ckpt_dir, step)[1]

    def run(
        self,
        step_fn: Callable[[Any, Any], Tuple[Any, Any]],
        state: Any,
        batches: Iterable[Any],
        *,
        resume: bool = True,
    ) -> Any:
        """Drive ``step_fn`` over ``batches`` with detection and restart.

        ``batches`` is taken as a list: a restart resumes from the batch
        after the restored checkpoint's step. ``resume=True`` first
        restores the latest checkpoint in ``ckpt_dir``, if any, and goes on
        from there. Returns the final state.
        """
        # Checkpoint key invariant: key N = the state after N COMPLETED
        # steps (key 0 = the initial state, always saved so that a
        # first-step failure can restore).
        batches = list(batches)
        completed = 0
        if resume:
            prev = latest_step(self.ckpt_dir)
            if prev is not None:
                state = self._restore(prev)
                completed = prev
        if completed == 0:
            save_checkpoint(self.ckpt_dir, 0, state)
        good = completed

        restarts = 0
        fail_counts = {}
        skip = set()
        while completed < len(batches):
            i = completed
            if i in skip:
                completed += 1
                continue
            failure = None
            try:
                new_state, loss = step_fn(state, batches[i])
                failure = self._detect(i, loss)
            except Exception as e:  # runtime/dispatch errors
                failure = f"exception: {type(e).__name__}: {e}"
            if failure is None:
                state = new_state
                completed += 1
                if self.checkpoint_every > 0 and completed % self.checkpoint_every == 0:
                    save_checkpoint(self.ckpt_dir, completed, state)
                    good = completed
                continue

            restarts += 1
            self.failures.append(FailureRecord(
                step=i, kind=failure.split(":")[0], detail=failure, restored_step=good,
            ))
            if restarts > self.max_restarts:
                raise RuntimeError(
                    f"step {i}: {failure} — exceeded max_restarts={self.max_restarts} "
                    f"(crash loop); last good checkpoint: {good} completed steps in "
                    f"{self.ckpt_dir}"
                )
            # Restore the last good payload and REPLAY from there: the steps
            # are functions of the payload, so the replay reproduces the
            # uninterrupted computation. A transient fault gets one retry of
            # its batch; a batch that fails twice (a deterministically bad
            # batch) is skipped.
            fail_counts[i] = fail_counts.get(i, 0) + 1
            if fail_counts[i] >= 2:
                skip.add(i)
            state = self._restore(good)
            completed = good
        save_checkpoint(self.ckpt_dir, len(batches), state)
        return state
