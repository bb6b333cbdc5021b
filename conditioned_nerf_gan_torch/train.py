"""Train CLI of the port: `python -m conditioned_nerf_gan_torch.train`.

The flags of the JAX package's train.py (`-o/-s/-p/-e/-l`,
--load_curriculum, --n_epochs, --stop_step, --config, --config_base,
--seed, --profile_dir, --smoke, --native_loader), with `--device` in place
of `--platform`: it trains on `cuda` unless given `--device cpu`, and exits
2 without a card. `--smoke` writes a small synthetic dataset into the
output directory and trains the `smoke` config base on it (the reference's
`python train.py -o test -p 1` check).

Multi-GPU training runs one process a card: launch the CLI N times with
`--coordinator host:port --num_processes N --process_id i` (or the
CNG_COORDINATOR / CNG_NUM_PROCESSES / CNG_PROCESS_ID variables, or
`--distributed` under `torchrun`). Each rank takes card `local_rank %
torch.cuda.device_count()`, its index among the ranks on its host (on one
host its process_id), unless `--device` names one; it seeds
`random` and `np.random` with seed + its rank, and under `--smoke` reads
the dataset that rank 0 writes (the others wait at a barrier).
"""

from __future__ import annotations

import argparse
import importlib
import os
import random
import sys
from datetime import datetime
from pathlib import Path

import numpy as np

# flag -> why it is refused
_NOT_PORTED = {
    "platform": "--platform picks a JAX backend; the port takes --device",
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Train conditioned NeRF-GAN (PyTorch port)")
    parser.add_argument("-s", "--sampling_interval", type=int, default=200,
                        help="step interval between sample-image dumps")
    parser.add_argument("-p", "--print_freq", type=int, default=100,
                        help="step interval between stats prints")
    parser.add_argument("-e", "--eval_freq", type=int, default=5000,
                        help="step interval between checkpoints (and, with A9, eval)")
    parser.add_argument("-o", "--output_dir", type=str, required=True,
                        help="output directory (also the resume anchor)")
    parser.add_argument("-l", "--load_dir", type=str, default="",
                        help="path to a port checkpoint (.pt)")
    parser.add_argument("--load_curriculum", type=str, default="",
                        help="explicit curriculum JSON (overrides all other sources)")
    parser.add_argument("--n_epochs", type=int, default=3000)
    parser.add_argument("--stop_step", type=int, default=None)
    parser.add_argument("--config", type=str, default=None,
                        help="experiment config name within the config base")
    parser.add_argument("--config_base", type=str, default="thousand")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of steps 10-14 here, "
                             "with the port's spans (train.step, train.d_step, ...)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (cuda, cuda:1, ..., or cpu)")
    parser.add_argument("--platform", type=str, default=None)
    parser.add_argument("--smoke", action="store_true",
                        help="generate a tiny synthetic dataset and train on it")
    parser.add_argument("--native_loader", action="store_true",
                        help="decode PNGs/EXRs through the C++ thread-pool loader "
                             "(native/fastload.cc; env: CNG_NATIVE_LOADER=1)")
    # multi-process execution: launch this CLI once per card
    parser.add_argument("--distributed", action="store_true",
                        help="start torch.distributed (without --coordinator: from "
                             "torchrun's environment)")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="rank 0's address host:port (implies --distributed; "
                             "env: CNG_COORDINATOR)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="total process count (env: CNG_NUM_PROCESSES)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (env: CNG_PROCESS_ID)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    refused = [f"--{flag}: {why}" for flag, why in _NOT_PORTED.items()
               if getattr(args, flag) not in (None, False)]
    if refused:
        print("not ported yet:\n  " + "\n  ".join(refused), file=sys.stderr)
        return 2

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA GPU is available; pass --device cpu "
              "to train on the CPU (the plain fp32 path, no kernels)", file=sys.stderr)
        return 2
    os.makedirs(os.path.join(args.output_dir, "logs"), exist_ok=True)
    if args.native_loader:
        os.environ["CNG_NATIVE_LOADER"] = "1"

    from .parallel import distributed_requested, initialize_distributed, shutdown_distributed

    if not distributed_requested(args):
        return _train(args, 0)
    context = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device)
    args.device = str(context.device)
    try:
        return _train(args, context.rank)
    finally:
        shutdown_distributed()


def _train(args, process_index: int) -> int:
    import torch

    from .parallel import sync_processes

    if args.smoke:
        from .data.synthetic import make_synthetic_shapenet

        data_root = Path(args.output_dir) / "synthetic_data"
        ds_root = data_root / "ShapeNetCar"
        if process_index == 0 and not ds_root.exists():
            print("Generating synthetic smoke dataset ...")
            make_synthetic_shapenet(data_root, n_cars=6, n_views=8, img_size=64,
                                    n_points=2048, device=args.device)
        sync_processes("smoke_data_written")
        os.environ["CNG_DATASET_PATH"] = str(ds_root)
        if args.config_base == "thousand":
            args.config_base = "smoke"
        # the preset reads the dataset path when it is imported
        importlib.reload(importlib.import_module(
            f"conditioned_nerf_gan_torch.config.presets.{args.config_base}"))

    random.seed(args.seed + process_index)
    np.random.seed(args.seed + process_index)
    torch.manual_seed(args.seed)

    from .training.trainer import Trainer

    print(f"Device: {args.device}"
          + (f" ({torch.cuda.get_device_name(torch.device(args.device))})"
             if torch.device(args.device).type == "cuda" else ""))
    print(datetime.now().strftime("%d--%H:%M"))
    print("---------------- Start training ----------------", flush=True)
    trainer = Trainer(args)  # its rank and world size: the process group's
    trainer.load_models()
    trainer.train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
