"""End-to-end training driver of the port (same CLI as
``repro.launch.train``, plus ``--device``).

Replicas are logical slots on the one device: ``--virtual-devices`` sets how
many slots exist (0 = as many as ``--devices`` and ``--rescale-at`` need),
``--devices`` how many the job starts on (0 = all).

``--arch`` takes every config the port builds (``configs.list_archs()``:
the dense yi-6b, yi-9b, starcoder2-7b, minitron-4b and chameleon-34b, the
granite-moe-3b-a800m MoE, the deepseek-v2-236b MLA + MoE model,
mamba2-1.3b, the jamba-v0.1-52b hybrid and the seamless-m4t-large-v2
encoder-decoder, whose stream adds ``--seq-len`` float32 encoder frames a
sequence), each with ``--smoke``.  A Mamba-2 or jamba ``--seq-len`` must
be a multiple of the SSD chunk (8 in the smoke configs, 128 at full size)
or shorter than it.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
      --steps 50 --global-batch 8 --seq-len 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-3b-a800m \
      --smoke --steps 20 --devices 4 --rescale-at 10:2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \
      --smoke --steps 8 --devices 4 --rescale-at 3:2 --seq-len 32 --device cpu
"""
import argparse

from repro_torch.configs.base import list_archs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--devices", type=int, default=0,
                    help="replica slots to start on (0 = all slots)")
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="logical replica slots on the device (0 = as many "
                         "as --devices and --rescale-at need)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--rescale-at", action="append", default=[],
                    help="step:new_replica_count (repeatable)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--restart", action="store_true",
                    help="resume from the latest disk checkpoint")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import DiskCheckpointStore
    from repro_torch.checkpoint.reshard import tree_leaves
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.core.elastic import (ElasticTrainer, TrainJobConfig,
                                          local_slots)

    rescales = {}
    for spec in args.rescale_at:
        s, r = spec.split(":")
        rescales[int(s)] = int(r)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    n_slots = args.virtual_devices or max([args.devices, 1, *rescales.values()])
    slots = local_slots(n_slots)
    start = slots[:args.devices] if args.devices else slots

    job = TrainJobConfig(global_batch=args.global_batch, seq_len=args.seq_len,
                         total_steps=args.steps, seed=args.seed,
                         peak_lr=args.lr, dtype=args.dtype)
    trainer = ElasticTrainer(cfg, job, start, device=args.device)
    n_params = sum(p.numel() for p in tree_leaves(trainer.params))
    print(f"[train] arch={cfg.name} params={n_params:,} device={trainer.device} "
          f"replicas={trainer.replicas} startup={trainer.startup_time:.2f}s")

    store = None
    if args.checkpoint_dir:
        store = DiskCheckpointStore(args.checkpoint_dir)
        if args.restart:
            try:
                step = trainer.restore_disk(store, cfg.name)
                print(f"[train] restarted from disk checkpoint at step {step}")
            except FileNotFoundError:
                print("[train] no checkpoint found; starting fresh")

    while not trainer.done:
        if trainer.step_idx in rescales:
            new_r = rescales[trainer.step_idx]
            t = trainer.rescale(slots[:new_r])
            print(f"[train] rescale -> {new_r} replicas ({t.path}): "
                  + " ".join(f"{k}={v:.3f}s" for k, v in t.as_dict().items()))
        m = trainer.step()
        if trainer.step_idx % args.log_every == 0 or trainer.done:
            print(f"[train] step {m['step']:5d} loss={m['loss']:.4f} "
                  f"grad_norm={m['grad_norm']:.3f} replicas={m['replicas']}")
        if store and args.checkpoint_every and \
                trainer.step_idx % args.checkpoint_every == 0:
            dt = trainer.save_disk(store, cfg.name)
            print(f"[train] disk checkpoint @ step {trainer.step_idx} "
                  f"({dt:.2f}s)")

    losses = [m["loss"] for m in trainer.metrics_log]
    if losses:
        print(f"[train] done. loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"[train] done. nothing to run past step {trainer.step_idx}")
    return trainer


if __name__ == "__main__":
    main()
