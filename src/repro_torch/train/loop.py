"""Fault-tolerant training loop (the port's ``train/loop.py``).

  * checkpoint/restart: atomic saves every ``ckpt_every`` steps (keep-k
    retention, integrity hashes); on start the loop resumes from the newest
    checkpoint and replays the data stream (``data.pipeline`` seeds by
    (run seed, step)).  A newest checkpoint whose leaves differ from the
    model's is refused before any step (``checkpoint.manager.check_fits``);
  * straggler watchdog: an EMA of step wall time; a step slower than
    ``straggler_factor`` x EMA writes an emergency checkpoint and raises
    :class:`StragglerEvent`;
  * preemption hook: SIGTERM makes the loop checkpoint after the current
    step and stop;
  * a non-finite loss raises ``FloatingPointError``;
  * under a mesh (``mesh=``) the state is DTensors laid out by
    ``launch.step.make_sharded_train_step``, batches are sharded on the
    data axes, and the loop runs under ``parallel.ctx.use_mesh``, so every
    kernel runs per shard (``kernels/shmap.py``).  Checkpoints are written
    whole and re-sharded on resume (the elastic restart).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass

import numpy as np

from repro_torch import resolve_device
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data.pipeline import DataConfig, device_batch
from repro_torch.models import get_model
from repro_torch.optim import adamw


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    keep: int = 3
    straggler_factor: float = 3.0
    ema_decay: float = 0.8


class StragglerEvent(RuntimeError):
    pass


def _init_state(model, opt_cfg, seed, device):
    params = model.init(seed, device=device)
    return {"params": params, "opt": adamw.init_state(params, opt_cfg)}


def train(cfg, opt_cfg: adamw.OptConfig, data_cfg: DataConfig,
          loop_cfg: TrainLoopConfig, ckpt_dir: str, device=None, log=print,
          train_step=None, mesh=None):
    """Run (or resume) a training job on ``device`` (default ``cuda``);
    returns ``(state, history)``, one ``{"step", "loss", "time_s"}`` a
    step.  Fresh parameters come from ``data_cfg.seed``; ``train_step``
    (default ``launch.step.make_train_step``) maps ``(state, batch)`` to
    ``(state, metrics)``.  With ``mesh`` (a ``DeviceMesh``, JAX :51-89)
    the default step is ``launch.step.make_sharded_train_step``'s, the
    state is laid out by its shardings and each batch by its sharder, and
    the loop runs under ``parallel.ctx.use_mesh``."""
    device = resolve_device(device)
    model = get_model(cfg)
    state_sh = batch_sharder = None
    if mesh is not None:
        from repro_torch.launch.step import make_sharded_train_step
        step_fn, state_sh, batch_sharder = make_sharded_train_step(
            cfg, opt_cfg, mesh)
        train_step = train_step or step_fn
    elif train_step is None:
        from repro_torch.launch.step import make_train_step
        train_step = make_train_step(cfg, opt_cfg)
    if mesh is None:
        return _run(cfg, opt_cfg, data_cfg, loop_cfg, ckpt_dir, device, log,
                    train_step, model, None, None)
    from repro_torch.parallel import ctx
    from repro_torch.parallel import sharding as shd
    with ctx.use_mesh(mesh, shd.batch_axes(cfg, mesh)):
        return _run(cfg, opt_cfg, data_cfg, loop_cfg, ckpt_dir, device, log,
                    train_step, model, state_sh, batch_sharder)


def _run(cfg, opt_cfg, data_cfg, loop_cfg, ckpt_dir, device, log,
         train_step, model, state_sh, batch_sharder):

    # ---- resume or init ---------------------------------------------------
    start = ckpt.latest_step(ckpt_dir)
    if start is not None:
        like = _init_state(model, opt_cfg, 0, "meta")
        state = ckpt.restore(ckpt_dir, start, like, device=device,
                             shardings=state_sh)
        log(f"[resume] restored step {start} from {ckpt_dir}"
            + (f"; total_steps {loop_cfg.total_steps} already reached, "
               "nothing to run" if start >= loop_cfg.total_steps else ""))
        step0 = start
    else:
        state = _init_state(model, opt_cfg, data_cfg.seed, device)
        if state_sh is not None:
            from repro_torch.parallel.sharding import shard_tree
            state = shard_tree(state, state_sh)
        step0 = 0

    # ---- preemption hook -------------------------------------------------
    interrupted = {"flag": False}

    def _sigterm(signum, frame):
        interrupted["flag"] = True
    old_handler = signal.signal(signal.SIGTERM, _sigterm)

    history = []
    ema = None
    try:
        for step in range(step0, loop_cfg.total_steps):
            batch = device_batch(cfg, data_cfg, step, device)
            if batch_sharder is not None:
                batch = batch_sharder(batch)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])      # waits for the step
            dt = time.time() - t0
            history.append({"step": step + 1, "loss": loss, "time_s": dt})

            # straggler watchdog
            if ema is not None and dt > loop_cfg.straggler_factor * ema \
                    and step > step0 + 3:
                ckpt.save(ckpt_dir, step + 1, state)
                ckpt.retain(ckpt_dir, loop_cfg.keep)
                raise StragglerEvent(
                    f"step {step+1} took {dt:.3f}s vs EMA {ema:.3f}s — "
                    f"emergency checkpoint written")
            ema = dt if ema is None else (loop_cfg.ema_decay * ema
                                          + (1 - loop_cfg.ema_decay) * dt)

            if (step + 1) % loop_cfg.ckpt_every == 0 or interrupted["flag"]:
                ckpt.save(ckpt_dir, step + 1, state)
                ckpt.retain(ckpt_dir, loop_cfg.keep)
                log(f"[ckpt] step {step+1} loss {loss:.4f}")
            if interrupted["flag"]:
                log("[preempt] SIGTERM — emergency checkpoint done")
                break
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at {step+1}")
    finally:
        signal.signal(signal.SIGTERM, old_handler)
    return state, history
