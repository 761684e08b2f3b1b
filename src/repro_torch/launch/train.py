"""Training loop: ``python -m repro_torch.launch.train --arch <id> [...]``.

The JAX package's fault-tolerant loop: checkpoint restore (``--resume``)
-> a batch a step from the arch's ``smoke_batch``, seeded by the step
(``1234 + step``), so that a resumed run replays the stream exactly ->
one AdamW step (lr 1e-3, every arch, as the JAX package's loop) -> an
asynchronous checkpoint every ``--ckpt-every`` steps -> straggler
monitoring -> on SIGTERM, a drain with a final blocking save.  The exit
code is 1 if the loss of a run of more than 10 steps ends non-finite.

It runs the arch's reduced smoke config unless ``--full`` (the published
config; only the batch stays the smoke batch), on the GPU unless
``--device cpu``.  Weights come from ``torch.Generator`` seed 0.
Checkpoints go to ``--ckpt-dir`` (default ``build/train_ckpt`` at the
repository root).
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def synthetic_batch(spec, cfg, step: int, device="cpu"):
    """The step's batch from the arch's ``smoke_batch``, seeded by the step
    (numpy's generator, so that it is the JAX package's batch)."""
    return spec.smoke_batch(cfg, np.random.default_rng(1234 + step), device)


def run(argv=None) -> dict:
    """The loop; returns dict(rc, losses {step: loss}, start_step,
    stragglers)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published config instead of the smoke one")
    args = ap.parse_args(argv)

    from ..configs import get_arch
    from ..device import generator, resolve_device
    from ..optim.adam import AdamConfig, adam_update, init_adam
    from .checkpoint import CheckpointManager
    from .steps import family_init, family_loss, value_and_grad

    dev = resolve_device(args.device)
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.smoke_config
    loss_fn = family_loss(replace(spec, config=cfg))
    params = family_init(spec, cfg_override=cfg)(generator(0, dev))
    opt = init_adam(params)
    ocfg = AdamConfig(lr=1e-3)

    def step_fn(params, opt, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt, m = adam_update(ocfg, params, grads, opt)
        return params, opt, loss, m["grad_norm"]

    ckpt = CheckpointManager(args.ckpt_dir)
    start_step = 0
    if args.resume:
        restored, rstep = ckpt.restore((params, opt))
        if restored is not None:
            params, opt = restored
            start_step = rstep + 1
            print(f"[train] resumed from step {rstep}", flush=True)

    stop = {"flag": False}
    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        before = signal.signal(signal.SIGTERM,
                               lambda signum, frame: stop.update(flag=True))
    try:
        losses, mon = _loop(args, spec, cfg, dev, step_fn, params, opt, ckpt,
                            start_step, stop)
    finally:
        if on_main:
            signal.signal(signal.SIGTERM, before)
    out = dict(rc=0, losses=losses, start_step=start_step,
               stragglers=mon.flagged)
    seen = list(losses.values())
    if len(seen) > 10 and not np.isfinite(seen[-1]):
        print("[train] FAILED: non-finite loss", flush=True)
        return dict(out, rc=1)
    if seen:
        print(f"[train] done: first loss {seen[0]:.4f} -> last "
              f"{seen[-1]:.4f} (stragglers flagged: {mon.flagged})",
              flush=True)
    return out


def _loop(args, spec, cfg, dev, step_fn, params, opt, ckpt, start_step,
          stop):
    """The steps from ``start_step``, then the final blocking save; returns
    (losses by step, the straggler monitor)."""
    from .elastic import StragglerMonitor

    mon = StragglerMonitor()
    losses = {}
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = synthetic_batch(spec, cfg, step, dev)
        params, opt, loss, gnorm = step_fn(params, opt, batch)
        loss = losses[step] = float(loss)
        dt = time.perf_counter() - t0
        straggler = mon.record(dt)
        if step % args.log_every == 0 or straggler:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(gnorm):.3f} {dt * 1e3:.0f}ms"
                  + (" STRAGGLER" if straggler else ""), flush=True)
        if step and step % args.ckpt_every == 0:
            ckpt.save(step, (params, opt))
        if stop["flag"]:
            print("[train] SIGTERM: draining with final checkpoint",
                  flush=True)
            break
    ckpt.save(args.steps - 1, (params, opt), blocking=True)
    return losses, mon


def main(argv=None) -> int:
    return run(argv)["rc"]


if __name__ == "__main__":
    sys.exit(main())
