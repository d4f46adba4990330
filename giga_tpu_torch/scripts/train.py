#!/usr/bin/env python3
"""Train any preset on a processed dataset (counterpart of scripts/train.py;
reference scripts/train_{giga,giga_aff,giga_geo,vgn}.py unified).

    python3 -m giga_tpu_torch.scripts.train --dataset DIR [--dataset_raw DIR]
        [--net giga] [--epochs 10] [--batch-size 32] [--lr 2e-4]
        [--clip-norm 0] [--val-split 0.1] [--augment] [--load-path CKPT]
        [--seed 0] [--bf16] [--orbax] [--workers 4] [--device cuda] [--dp]

    torchrun --nproc-per-node N -m giga_tpu_torch.scripts.train --dp --dataset DIR ...

Run from the repository root. Defaults match the reference: Adam lr 2e-4,
batch 32, 10 epochs, 0.9/0.1 split. The weights start from
``reference_init(net, seed)`` (the JAX package's ``net.init`` rules) or from
``--load-path`` (.msgpack or the reference's .pt). ``--orbax`` keeps the
params, optimizer state and epoch for resuming (Trainer's ``save_state``).
Training runs on the card unless ``--device`` says otherwise.

``--dp`` trains data-parallel, one process per card (``torchrun`` starts
them and names each one's rank): every rank loads the same global batches
and keeps its shard, the gradients are averaged across ranks each step,
and rank 0 alone writes the logs and checkpoints. ``--device cpu`` runs the
ranks on the CPU over gloo. Without a launcher ``--dp`` raises.
"""

from __future__ import annotations

import argparse
import sys
from datetime import datetime
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NETS = ["giga", "giga_aff", "giga_geo", "giga_detach", "giga_grid", "vgn"]
DP_LAUNCH = ("--dp runs one process per card: start it with torchrun --nproc-per-node N "
             "-m giga_tpu_torch.scripts.train --dp ...")


def main(args) -> None:
    import torch

    from giga_tpu_torch.core.config import TrainConfig
    from giga_tpu_torch.models.registry import get_network, load_network, reference_init
    from giga_tpu_torch.train.data import (
        PrefetchLoader,
        create_train_val_loaders,
        create_vgn_train_val_loaders,
    )
    from giga_tpu_torch.parallel import distributed
    from giga_tpu_torch.train.trainer import Trainer, create_train_state

    mesh, device = None, args.device
    if args.dp:
        if not distributed.initialize(device=args.device):
            raise RuntimeError(DP_LAUNCH)
        from giga_tpu_torch.parallel.mesh import make_mesh

        device = distributed.local_device(args.device)
        mesh = make_mesh(device=device)
        print(f"data parallel over {mesh.size()} processes (this one on {device})")
    if args.load_path:
        net, model_cfg = load_network(args.load_path, args.net)
    else:
        net, model_cfg = get_network(args.net)
        reference_init(net, args.seed)
    train_cfg = TrainConfig(net=args.net, batch_size=args.batch_size, lr=args.lr,
                            epochs=args.epochs, val_split=args.val_split, augment=args.augment,
                            seed=args.seed)
    if args.savedir:
        logdir = Path(args.savedir)
    else:
        stamp = datetime.now().strftime("%y-%m-%d-%H-%M")
        name = (f"{stamp}_dataset={Path(args.dataset).name},augment={args.augment},"
                f"net={args.net},batch_size={args.batch_size},lr={args.lr:.0e}")
        logdir = args.logdir / name
    if mesh is not None:  # rank 0's stamp: the ranks may start in different minutes
        import torch.distributed as dist

        names = [str(logdir)]
        dist.broadcast_object_list(names, src=0)
        logdir = Path(names[0])
    if args.net == "vgn":
        train_loader, val_loader = create_vgn_train_val_loaders(
            args.dataset, args.batch_size, args.val_split, args.augment, seed=args.seed)
    else:
        train_loader, val_loader = create_train_val_loaders(
            args.dataset, args.dataset_raw, args.batch_size, args.val_split, args.augment,
            load_occ=args.net != "giga_aff", seed=args.seed)
    state = create_train_state(net, lr=args.lr,
                               clip_norm=args.clip_norm if args.clip_norm > 0 else None,
                               device=device)
    if mesh is not None:  # every rank starts from rank 0's weights
        from giga_tpu_torch.parallel.mesh import replicate

        with torch.no_grad():
            for k, v in replicate(mesh, state.params).items():
                state.params[k].copy_(v)
    if args.workers > 0:
        train_loader = PrefetchLoader(train_loader, num_workers=args.workers)
        val_loader = PrefetchLoader(val_loader, num_workers=args.workers)
    trainer = Trainer(net, model_cfg, train_cfg, mesh=mesh, logdir=logdir,
                      save_state=args.orbax, dtype=torch.bfloat16 if args.bf16 else None)
    try:
        trainer.fit(state, train_loader, val_loader, epochs=args.epochs)
    finally:
        if mesh is not None:
            distributed.shutdown()


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--net", default="giga", choices=NETS)
    p.add_argument("--dataset", type=Path, required=True)
    p.add_argument("--dataset_raw", type=Path, default=None,
                   help="raw root with grasps.csv/occ (unused for --net vgn)")
    p.add_argument("--logdir", type=Path, default=Path("data/runs"))
    p.add_argument("--savedir", type=str, default="")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clip; 0 (default) = off, matching the "
                        "reference's plain Adam")
    p.add_argument("--val-split", type=float, default=0.1)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--load-path", type=str, default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", action="store_true",
                   help="data-parallel, one process per card, under torchrun")
    p.add_argument("--bf16", action="store_true",
                   help="mixed-precision training (bf16 compute, fp32 state)")
    p.add_argument("--orbax", action="store_true",
                   help="full-state checkpointing (params, optimizer, epoch) with auto-resume")
    p.add_argument("--workers", type=int, default=4,
                   help="prefetch worker threads (0 = synchronous)")
    p.add_argument("--device", type=str, default=None,
                   help="where training runs (default: the card)")
    return p


if __name__ == "__main__":
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    main(parser().parse_args())
