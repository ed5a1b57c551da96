"""Training CLI.

  python -m repro_torch.launch.train --arch qwen3-0.6b [--smoke] \\
      --steps 100 --ckpt-dir DIR [--policy tcec_bf16x6] [--device cuda] \\
      [--numerics KEY=VALUE ...] [--trace t.json] [--metrics-out m.json] \
      [--mesh-model N [--backend gloo]]

Parameters start random, from ``--seed``; the data is the synthetic
stream of ``data.pipeline``.  A run resumes from the newest checkpoint in
``--ckpt-dir`` (by default ``repro_torch_ckpt`` in the temporary
directory); a checkpoint there whose leaf paths or shapes differ from the
requested config's (another arch's run) is refused before any step, with
a ``ValueError`` that names the first leaf that differs.  It runs on
``cuda`` unless ``--device cpu`` is given.  ``--numerics KEY=VALUE``
(repeatable) sets fields of the numerics config the run uses; the backward
runs under it too.  ``--trace`` / ``--metrics-out`` export the run's spans
and metrics snapshot (``repro_torch.obs``) and print the dispatch-explain
summary; the spans are each step's ``train.forward``, ``train.backward``
and ``train.optimizer`` (``launch/step.py``), with their ``device_us``
edges on the card.  ``--mesh-model N`` trains under a ``(world / N, N)`` mesh
(``train.loop.train(mesh=)``: parameters sharded by
``parallel.sharding.param_specs``, batches on the data axes, every kernel
per shard), in the world ``torchrun`` gives or in this process alone; rank
0 prints the mesh and the losses (see ``launch/serve.py`` for
``--backend``).
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch import numerics, obs, resolve_device
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.serve import add_mesh_flags, cli_mesh
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainLoopConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--policy", default=None,
                    help="GEMM precision policy override")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    add_mesh_flags(ap)
    numerics.add_cli_overrides(ap)
    obs.add_cli_flags(ap)
    args = ap.parse_args(argv)
    with numerics.cli_context(args), obs.cli_session(args):
        _main(args)


def _main(args):
    device = resolve_device(args.device)
    mesh, say = cli_mesh(args, device)
    if mesh is not None:
        device = resolve_device(device.type)    # this rank's card
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if args.policy:
        cfg = cfg.replace(policy=args.policy)
    opt = adamw.OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                          total_steps=args.steps)
    data = DataConfig(seed=args.seed, global_batch=args.batch,
                      seq_len=args.seq)
    loop = TrainLoopConfig(total_steps=args.steps,
                           ckpt_every=args.ckpt_every)

    def log(msg):
        say(msg, flush=True)

    state, hist = train(cfg, opt, data, loop, args.ckpt_dir, device=device,
                        log=log, mesh=mesh)
    for h in hist[:: max(len(hist) // 20, 1)]:
        say(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"{h['time_s']*1e3:7.1f} ms")
    if hist:
        say(f"final loss: {hist[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
