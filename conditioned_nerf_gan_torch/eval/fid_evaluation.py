"""The in-training evaluation (port of
conditioned_nerf_gan_tpu/eval/fid_evaluation.py).

  * `setup_evaluation` writes the real images of the `fid` subset once per
    (dataset, subset, size), under CNG_EVAL_IMAGES or next to the dataset;
  * `output_images` renders this process's shard of the subset (the
    loader's `process_index` / `process_count`) at `fid.target_size`
    through the trainer's `encode_batch` and `generate_img` and writes
    `{car}_{view}.png` files, the names `compute_metrics_from_dirs` pairs;
  * `evaluate_trainer` has rank 0 write the real images, every rank its
    image shard, and rank 0 score the two directories on its device, with
    the JAX package's three barriers between (`eval_setup_done`,
    `eval_image_shards_written`, `eval_metrics_done`; no-ops in one
    process).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from ..data import DataLoader, ShapeNetDataset
from ..utils.image import to_uint8
from ..utils.png import write_png
from ..parallel import sync_processes
from .metrics import compute_fid_from_dirs, compute_metrics_from_dirs
from .weights import stamp_metric_log


def _img_name(img_path: str) -> str:
    parts = Path(img_path).parts
    return f"{parts[-3]}_{parts[-1]}"  # {car}_{view:04}.png


def _save_png(img01: np.ndarray, path: Path) -> None:
    write_png(path, to_uint8(img01))


def setup_evaluation(metadata: dict) -> str:
    """Write the real eval images once; returns their directory."""
    dataset_path = Path(metadata["dataset"]["path"])
    root = os.environ.get("CNG_EVAL_IMAGES", str(dataset_path.parent / "EvalImages"))
    fid = metadata["fid"]
    real_dir = Path(root) / dataset_path.stem / f"{fid['subset']}_{fid['target_size']}"
    if not real_dir.exists():
        real_dir.mkdir(parents=True)
        dataset = ShapeNetDataset(dataset_path, fid["target_size"], fid["subset"], metadata,
                                  load_voxel=False, load_pcl=False, dataset_mode="test",
                                  load_depth=False, load_cam=False, shuffle=False)
        print("Outputting real images...")
        chunk = 32
        for start in range(0, len(dataset), chunk):
            batch = dataset.get_batch(list(range(start, min(start + chunk, len(dataset)))))
            for img, path in zip(batch["img"], batch["img_path"]):
                _save_png(img * 0.5 + 0.5, real_dir / _img_name(path))
        print("...done")
    return str(real_dir)


def output_images(trainer, metadata: dict, output_dir: str | Path, process_index: int = 0,
                  process_count: int = 1) -> None:
    """Render this process's shard of the trainer's `fidset` at
    `fid.target_size` with `metadata["num_steps"]` samples a ray,
    `fid.render_batch` views a render (else the reference's 2 above 48
    samples, 8 below), and write the PNGs."""
    dataset = trainer.fidset
    img_size = metadata["fid"]["target_size"]
    num_steps = metadata["num_steps"]
    render_batch = metadata["fid"].get("render_batch")
    if render_batch is not None and render_batch < 1:
        raise ValueError(f"fid.render_batch must be >= 1, got {render_batch}")
    batch_size = render_batch if render_batch is not None else (2 if num_steps > 48 else 8)
    loader = DataLoader(dataset, batch_size, shuffle=False, drop_last=False,
                        process_index=process_index, process_count=process_count)
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    print(f"Generating {len(dataset)} images at {out}")
    for batch in loader:
        cond = {k: torch.as_tensor(v, device=trainer.device) for k, v in batch.items()
                if k in ("pcl", "voxel")}
        z = trainer.encode_batch(cond)
        cams = torch.as_tensor(batch["cam2world"], device=trainer.device)
        rgb, _ = trainer.generate_img(z, cams, img_size=img_size, num_steps=num_steps)
        rgb01 = rgb.cpu().numpy() * 0.5 + 0.5
        for idx, img in enumerate(rgb01):
            _save_png(img, out / _img_name(batch["img_path"][idx]))


def append_fid_line(path, step: int, fid, ofid, lpips_score, psnr) -> None:
    """Append one metric line in the reference's fid.txt format, stamping
    the file first when a metric net has random weights."""
    stamp_metric_log(path)
    with open(path, "a") as f:
        f.write(f"\n{step} {fid} {ofid} {lpips_score} {psnr}")


def evaluate_trainer(trainer, metadata: dict):
    """One eval pass; returns (fid, ofid, lpips, psnr) on rank 0 and None on
    the others. Without a val.lst next to the dataset only FID is scored
    (the others NaN)."""
    real_dir = setup_evaluation(metadata) if trainer.is_main else None
    # rank 0 must not score the directory before every shard is on disk,
    # and the others wait out its scoring before their next step
    sync_processes("eval_setup_done")
    output_images(trainer, metadata, trainer.evaluation_path, trainer.process_index,
                  trainer.process_count)
    sync_processes("eval_image_shards_written")
    results = None
    if trainer.is_main:
        val_lst = Path(metadata["dataset"]["path"]).parent / "val.lst"
        if not val_lst.exists():
            print(f"val.lst not found at {val_lst}; skipping paired metrics")
            fid = compute_fid_from_dirs(real_dir, trainer.evaluation_path,
                                        device=trainer.device)
            results = (fid, float("nan"), float("nan"), float("nan"))
        else:
            results = compute_metrics_from_dirs(real_dir, trainer.evaluation_path, val_lst,
                                                device=trainer.device)
    sync_processes("eval_metrics_done")
    return results
