"""Trainer: the end-to-end training runtime (port of
conditioned_nerf_gan_tpu/training/trainer.py).

  * output-dir contract: checkpoints/, logs/, samples/{trainview,valview,
    testview}/, evaluation/, curriculum.json and train_spec.txt
  * the train, val (held-out view) and test (unseen cars) datasets
  * curriculum precedence (--load_curriculum, the run's curriculum.json,
    the checkpoint's, the presets) and its JSON persistence
  * `load_models`: resume from the newest checkpoint in checkpoints/, else
    from --load_dir, else fresh weights from `torch.Generator().manual_seed(seed)`
  * per-step metadata refresh; at a milestone the step is rebuilt and the
    optimizers' learning rates are set in place (their Adam moments and
    step counts carry on, as the JAX package's optax state does); a
    milestone that changes the data (batch, image size, points, voxels)
    also restarts the epoch on a new loader
  * fade-in alpha and density-noise schedules of the step counter
  * per-step randomness a pure function of (seed, step): each step draws
    from a `torch.Generator` on the batch's device seeded from
    (1000 + seed, step), the counterpart of the JAX step's
    `fold_in(rng, state.step)`; with the loader position (epoch, offset)
    saved in each checkpoint, a resumed run replays the uninterrupted one
  * the stats table every print_freq, sample grids and val/test losses
    every sampling_interval, a checkpoint and the eval metrics (FID, oFID,
    LPIPS, PSNR of the `fid` subset, `eval/`) every eval_freq, appended to
    fid.txt and fid_history, a checkpoint at the end, and a torch.profiler
    trace of steps 10-15 with --profile_dir.

Not ported, each a workaround or a later item:
  * `steps_per_dispatch` chaining, its window clamp and its starvation
    warning (`trainer.py:414-495`, `:785-856`): they amortise the TPU's
    host round trip a dispatch; here each step is launched from the host;
  * the mesh trim and regrow, `_local_params` and multi-process runs: one
    GPU here, data parallelism is ROADMAP A14;
  * `utils/cache.py` (XLA's compile cache): nothing is compiled ahead here
    but the CUDA kernels, which `ops/kernels/build.py` caches.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import random
import time
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..config import curriculum_to_json, extract_metadata, last_upsample_step, load_curriculum
from ..data import DataLoader, ShapeNetDataset
from ..eval.fid_evaluation import append_fid_line, evaluate_trainer
from ..infer.inference import build_models, compute_dtype
from ..models.discriminators import make_discriminator
from ..models.generator import RenderConfig
from ..models.pointnet import encode_pcl
from ..utils.image import save_image_grid
from ..utils.resize import resize
from .checkpoints import find_newest_checkpoint, restore_checkpoint, save_checkpoint
from .schedules import fade_alpha, nerf_noise_schedule
from .train_step import TrainState, TrainStepConfig, create_train_state, make_train_step

HISTORY_KEYS = (
    "generator_losses",
    "discriminator_losses",
    "photometry_losses",
    "depth_losses",
    "photometry_losses_val",
    "depth_losses_val",
    "photometry_losses_test",
    "depth_losses_test",
    "fid_history",
)


def step_seed(seed: int, step: int) -> int:
    """The seed of step `step`'s random numbers in a run seeded `seed`."""
    return ((1000 + seed) << 32) + step


def set_learning_rates(state: TrainState, config: TrainStepConfig) -> None:
    """Give the three optimizers `config`'s learning rates (the mapping
    network's group at `mapping_lr_mult` x gen_lr), betas, weight decay and
    clip, in place: their moments and step counts are kept."""
    for opt, lr, mult in ((state.opt_G, config.gen_lr, config.mapping_lr_mult),
                          (state.opt_E, config.enc_lr, 1.0),
                          (state.opt_D, config.disc_lr, 1.0)):
        if opt is None:
            continue
        opt.defaults["grad_clip"] = config.grad_clip
        for i, group in enumerate(opt.param_groups):
            group["lr"] = lr * (mult if i == 1 else 1.0)
            group["betas"] = tuple(float(b) for b in config.betas)
            group["weight_decay"] = config.weight_decay


def format_table(rows: list[list]) -> str:
    """A grid of cells with box lines, one row a line."""
    cells = [[str(c) for c in row] for row in rows]
    widths = [max(len(row[i]) for row in cells) for i in range(len(cells[0]))]
    rule = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [rule]
    for row in cells:
        lines.append("| " + " | ".join(c.ljust(w) for c, w in zip(row, widths)) + " |")
        lines.append(rule)
    return "\n".join(lines)


class Trainer:
    # steps whose metrics may stay on the device before the oldest are read
    _MAX_IN_FLIGHT = 4

    def __init__(self, args: Any):
        """`args` holds the train CLI's flags; `args.device` (default cuda)
        is the torch device the nets train on."""
        self.args = args
        self.device = torch.device(getattr(args, "device", "cuda"))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Trainer: device {str(self.device)!r} asked for, but no "
                               "CUDA GPU is available; pass device \"cpu\"")
        self.seed = getattr(args, "seed", 0)
        self.curriculum = load_curriculum(
            output_dir=args.output_dir,
            load_dir=getattr(args, "load_dir", None) or None,
            load_curriculum_path=getattr(args, "load_curriculum", None) or None,
            config_base=getattr(args, "config_base", "thousand"),
            config=getattr(args, "config", None),
        )
        self.metadata = extract_metadata(self.curriculum, 0)
        self._mkdirs()
        self.histories = {k: [] for k in HISTORY_KEYS}
        # device-side metrics not yet read: reading one waits for its step
        self._pending_metrics: collections.deque = collections.deque()
        self.step = 0
        self.epoch = 0
        # the loader's position (epoch being consumed, batches consumed in
        # it), saved in each checkpoint so a resumed run replays the batches
        self._loader_epoch = 0
        self._batch_offset = 0
        self._restored_loader_state: dict | None = None
        self._profiler = None

        ds_meta = self.metadata["dataset"]
        common = dict(
            metadata=self.metadata,
            load_voxel=ds_meta["load_voxel"],
            load_pcl=ds_meta["load_pcl"],
            voxel_resolution=self.metadata.get("voxel_resolution", 64),
        )
        # sample/val sets are read at the sample resolution (reference: 128²)
        sample_size = self.metadata.get("sample_img_size", 128)
        self.trainset = ShapeNetDataset(ds_meta["path"], sample_size, ds_meta["trainset"],
                                        shuffle=True, dataset_mode="train", **common)
        self.valset = ShapeNetDataset(ds_meta["path"], sample_size, ds_meta["trainset"],
                                      shuffle=False, dataset_mode="val", **common)
        self.testset = ShapeNetDataset(ds_meta["path"], sample_size, ds_meta["testset"],
                                       shuffle=False, dataset_mode="test", **common)
        fid = self.metadata["fid"]
        self.fidset = ShapeNetDataset(ds_meta["path"], fid["target_size"], fid["subset"],
                                      dataset_mode="test", load_img=False, load_depth=False,
                                      load_cam=True, shuffle=False, **common)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def _mkdirs(self) -> None:
        out = Path(self.args.output_dir)
        self.checkpoints_path = out / "checkpoints"
        self.logs_path = out / "logs"
        self.samples_train_path = out / "samples" / "trainview"
        self.samples_val_path = out / "samples" / "valview"
        self.samples_test_path = out / "samples" / "testview"
        self.evaluation_path = out / "evaluation"
        for p in (self.checkpoints_path, self.logs_path, self.samples_train_path,
                  self.samples_val_path, self.samples_test_path, self.evaluation_path):
            p.mkdir(parents=True, exist_ok=True)

    def _build_models(self):
        """The nets of the first stage's metadata, fp32 params drawn from
        the run's seed (the JAX package's init schemes), each under the
        metadata's `compute_dtype` policy as the JAX Trainer builds them."""
        init = torch.Generator().manual_seed(self.seed)
        G, E = build_models(self.metadata, generator=init)
        D = (make_discriminator(self.metadata["discriminator"],
                                compute_dtype=compute_dtype(self.metadata), generator=init)
             if self.metadata["enable_discriminator"] else None)
        return G, E, D

    def load_models(self) -> None:
        """Build the nets and optimizers; resume from the newest checkpoint,
        else from --load_dir, else start fresh."""
        G, E, D = self._build_models()
        newest = find_newest_checkpoint(self.checkpoints_path)
        load_path = None
        if newest is not None:
            load_path = newest
        elif getattr(self.args, "load_dir", None):
            load_path = Path(self.args.load_dir)

        self.step = int(load_path.stem) if load_path else 0
        self.metadata = extract_metadata(self.curriculum, self.step)
        self.step_config = self._current_step_config(self.metadata)
        for net in (G, E, D):
            if net is not None:
                net.to(self.device)
        self.state = create_train_state(G, E, D, self.step_config)

        if load_path is not None:
            print(f"Resuming from checkpoint {load_path}")
            try:
                self.state, histories = restore_checkpoint(load_path, self.state)
            except (KeyError, ValueError, RuntimeError) as e:
                # the optimizer state no longer matches the nets (a model
                # change since the checkpoint): the params still load
                import warnings

                warnings.warn(
                    f"full checkpoint restore failed ({e}); falling back to "
                    "params-only resume with FRESH optimizer state — "
                    "momentum/second-moment statistics are reset",
                    stacklevel=2,
                )
                self.state = create_train_state(G, E, D, self.step_config)
                self.state, histories = restore_checkpoint(load_path, self.state,
                                                           params_only=True)
            for k in HISTORY_KEYS:
                self.histories[k] = histories.get(k, [])
            self.step = self.state.step
            self._restored_loader_state = histories.get("loader_state")
        else:
            print("Creating untrained models")
        self._rebuild_step_fn()

    def _stage_dataset(self) -> ShapeNetDataset:
        ds = self.metadata["dataset"]
        multifold = int(self.metadata.get("multifold")
                        or (3000 if ds["trainset"] in ("twenty", "single") else 1))
        return ShapeNetDataset(
            ds["path"], self.metadata["img_size"], ds["trainset"], self.metadata,
            ds["load_voxel"], ds["load_pcl"], shuffle=True, multifold=multifold,
            cond_mode=ds.get("cond_mode") or None,
            voxel_resolution=self.metadata.get("voxel_resolution", 64),
            load_depth=ds.get("load_depth", False) or self.metadata.get("depth_loss", False),
            seed=self.seed,
        )

    def _make_dataloader(self) -> DataLoader:
        return DataLoader(self._stage_dataset(), self.metadata["batch_size"], shuffle=True,
                          drop_last=True, seed=self.seed)

    def _current_step_config(self, metadata: dict) -> TrainStepConfig:
        """The stage's TrainStepConfig with the static density-noise gate:
        the noise schedule is 0 from step 5000 on, and it is monotone, so
        gating on the rebuild step is safe."""
        cfg = TrainStepConfig.from_metadata(metadata)
        if nerf_noise_schedule(self.step) <= 0.0:
            cfg = dataclasses.replace(
                cfg, render=dataclasses.replace(cfg.render, density_noise=False))
        return cfg

    def _rebuild_step_fn(self) -> None:
        self.step_config = self._current_step_config(self.metadata)
        self._step_fn = make_train_step(self.step_config)
        set_learning_rates(self.state, self.step_config)

    def update_metadata(self) -> bool:
        """Refresh the per-step metadata; True if anything the step or the
        loader was built from changed (`_data_changed`: the loader's part).

        The whole TrainStepConfig is compared, so a milestone that changes
        only num_steps, z_reg_weight or a learning rate also rebuilds the
        step; only batch, image size, points, voxels or the dataset restart
        the epoch (reference train.py:84-88)."""
        new_meta = extract_metadata(self.curriculum, self.step)
        self._data_changed = any(
            new_meta.get(k) != self.metadata.get(k)
            for k in ("batch_size", "img_size", "num_points_ratio", "voxel_resolution")
        ) or new_meta["dataset"] != self.metadata["dataset"]
        changed = (self._data_changed
                   or self._current_step_config(new_meta) != self.step_config)
        self.metadata = new_meta
        return changed

    # ------------------------------------------------------------------
    # schedules / bookkeeping
    # ------------------------------------------------------------------
    def set_alpha(self) -> None:
        step_last = last_upsample_step(self.curriculum, self.step)
        self.alpha = float(fade_alpha(self.step, step_last, self.metadata["fade_steps"]))
        self.nerf_noise = float(nerf_noise_schedule(self.step))

    def write_train_settings(self) -> None:
        out = Path(self.args.output_dir)
        with open(out / "train_spec.txt", "w") as f:
            f.write(str(vars(self.args)))
            f.write("\n\n")
            f.write(str(self.curriculum))
            f.write("\n\n")
            f.write(f"generator: {self.state.generator}\n")
            if self.state.discriminator is not None:
                f.write(f"discriminator: {self.state.discriminator}\n")
            f.write(f"encoder: {self.state.encoder}\n")
        curriculum_to_json(self.curriculum, out / "curriculum.json")

    def print_stats(self, steps_elapsed_time: float):
        if (self.step + 1) % self.args.print_freq != 0:
            return None
        self._flush_metrics()  # histories current through this step
        header = ["Time", "Epoch", "Step", "Sec per step", "Alpha",
                  "Img Size", "Batch Size", "Num steps"]
        row = [
            datetime.now().strftime("%d--%H:%M"),
            self.epoch,
            self.step,
            round(steps_elapsed_time / self.args.print_freq, 3),
            f"{self.alpha:.2f}",
            self.metadata["img_size"],
            self.metadata["batch_size"],
            self.metadata["num_steps"],
        ]
        if self.metadata["dataset"]["load_voxel"]:
            header.append("Voxel Res.")
            row.append(self.metadata.get("voxel_resolution", 64))
        pairs = [
            ("Photo loss", "photometry_losses"),
            ("Photo loss val", "photometry_losses_val"),
            ("Depth loss val", "depth_losses_val"),
            ("Photo loss test", "photometry_losses_test"),
            ("Depth loss test", "depth_losses_test"),
            ("Depth loss", "depth_losses"),
            ("Loss_G", "generator_losses"),
            ("Loss_D", "discriminator_losses"),
        ]
        for title, key in pairs:
            hist = self.histories[key]
            if hist:
                value = hist[-1][1] if isinstance(hist[-1], (list, tuple)) else hist[-1]
                header.append(title)
                row.append(f"{value:.4f}")
        stats = [header, row]
        print(format_table(stats), flush=True)
        return stats

    # ------------------------------------------------------------------
    # train loop
    # ------------------------------------------------------------------
    def train(self) -> None:
        self.write_train_settings()
        dataloader = self._make_dataloader()
        # resume: put the loader back at the checkpointed epoch and batch
        # offset; sample content is a pure function of (seed, epoch, index),
        # so the skipped batches are never decoded
        pending_skip = 0
        if self._restored_loader_state:
            dataloader.epoch = int(self._restored_loader_state["epoch"])
            pending_skip = int(self._restored_loader_state["offset"])
            self._restored_loader_state = None
        steps_elapsed = 0.0

        for _ in range(self.args.n_epochs):
            epoch_start = time.time()
            print(f"---- {self.epoch}_th epoch ----", flush=True)
            restart_epoch = False
            # the epoch about to be consumed (DataLoader.__iter__ bumps .epoch)
            self._loader_epoch = dataloader.epoch
            self._batch_offset = pending_skip
            dataloader.start_batch = pending_skip
            pending_skip = 0
            batches = iter(dataloader)
            for batch in batches:
                if self.update_metadata():
                    if self._data_changed:
                        print(f"Metadata updated at step {self.step}. Reload dataset.")
                        batches.close()  # release the loader's prefetch thread
                        dataloader = self._make_dataloader()
                        self._rebuild_step_fn()
                        restart_epoch = True
                        break
                    print(f"Metadata updated at step {self.step}. Rebuilt train step.")
                    self._rebuild_step_fn()

                self.set_alpha()
                self._profile_hook()
                t0 = time.time()
                self.train_step(batch)
                self._batch_offset += 1
                if (self.step + 1) % self.args.print_freq == 0:
                    # read the metrics inside the timed region, so "Sec per
                    # step" counts the device's work, not just the launches
                    self._flush_metrics()
                steps_elapsed += time.time() - t0

                if self.print_stats(steps_elapsed) is not None:
                    steps_elapsed = 0.0
                self.sample_imgs()
                self.save_models()
                self.evaluate()

                self.step += 1
                stop = getattr(self.args, "stop_step", None)
                if stop is not None and self.step > stop:
                    batches.close()
                    self._final_checkpoint()
                    return
            if not restart_epoch:
                dt = time.time() - epoch_start
                print(f"{self.epoch}_th epoch runtime: {int(dt // 60):02}:{int(dt % 60):02}")
                self.epoch += 1
        self._final_checkpoint()

    def train_step(self, batch: dict) -> None:
        """One D-then-G/E step on a loader batch; its metrics are queued."""
        batch = {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                 for k, v in batch.items() if not isinstance(v, list)}
        generator = torch.Generator(device=self.device).manual_seed(
            step_seed(self.seed, self.step))
        self.state, metrics = self._step_fn(self.state, batch, generator, self.alpha,
                                            self.nerf_noise)
        # the recording flags are taken now: a milestone can change the
        # metadata before these metrics are read
        self._pending_metrics.append((self.step, metrics, self._record_flags()))
        self._flush_metrics(keep=self._MAX_IN_FLIGHT)

    def _profile_hook(self) -> None:
        """A torch.profiler trace of steps 10-14 into --profile_dir."""
        profile_dir = getattr(self.args, "profile_dir", None)
        if not profile_dir:
            return
        if self.step == 10 and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.start()
        if self.step == 15 and self._profiler is not None:
            self._profiler.stop()
            Path(profile_dir).mkdir(parents=True, exist_ok=True)
            path = Path(profile_dir) / "trace.json"
            self._profiler.export_chrome_trace(str(path))
            self._profiler = None
            print(f"Wrote profiler trace to {path}")

    def _final_checkpoint(self) -> None:
        """Always leave a checkpoint at loop exit (the eval_freq-gated save
        can otherwise lose an entire sub-eval_freq run)."""
        self._flush_metrics()
        if not (self.checkpoints_path / f"{self.step - 1}.pt").exists():
            print(f"Saving final checkpoint at step {self.step - 1}")
            save_checkpoint(self.checkpoints_path, self.step - 1, self.state,
                            self._checkpoint_payload())

    def _flush_metrics(self, keep: int = 0) -> None:
        """Read queued metrics into the histories, oldest first, leaving up
        to `keep` steps in flight."""
        while len(self._pending_metrics) > keep:
            step_i, metrics, flags = self._pending_metrics.popleft()
            self._record({k: float(v) for k, v in metrics.items()}, step=step_i,
                         flags=flags)

    def _record_flags(self) -> dict:
        """The metadata flags _record consults, captured at enqueue time."""
        return {
            "enable_discriminator": self.metadata["enable_discriminator"],
            "photo_loss": self.metadata["photo_loss"],
            "depth_loss": self.metadata.get("depth_loss"),
            "load_pcl": self.metadata["dataset"]["load_pcl"],
        }

    def _record(self, metrics: dict, step: int | None = None,
                flags: dict | None = None) -> None:
        step = self.step if step is None else step
        flags = self._record_flags() if flags is None else flags
        # z_reg progress print every 100 steps (reference utils.py:696-698)
        if "z_reg" in metrics and flags["load_pcl"] and step % 100 == 0:
            print("z_reg: ", metrics["z_reg"], flush=True)
        if "d_loss" in metrics:
            self.histories["discriminator_losses"].append(metrics["d_loss"])
        if flags["enable_discriminator"]:
            self.histories["generator_losses"].append(metrics["g_loss"])
        if flags["photo_loss"]:
            self.histories["photometry_losses"].append(metrics["photo_loss"])
        if flags["depth_loss"]:
            self.histories["depth_losses"].append(metrics["depth_loss"])

    # ------------------------------------------------------------------
    # eval-time rendering helpers
    # ------------------------------------------------------------------
    def _eval_metadata(self, img_size=None, num_steps=None) -> dict:
        meta = copy.deepcopy(self.metadata)
        meta["img_size"] = img_size or self.metadata.get("sample_img_size", 128)
        meta["num_steps"] = num_steps or self.metadata.get("sample_num_steps", 48)
        meta["nerf_noise"] = 0
        meta["last_back"] = meta.get("eval_last_back", False)
        return meta

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    @torch.no_grad()
    def encode_batch(self, batch: dict):
        """Gradient-free conditioning encode (eval path)."""
        if self.metadata["dataset"]["load_pcl"]:
            z, _ = encode_pcl(self.state.encoder, batch["pcl"])
            return z
        return self.state.encoder(batch["voxel"])

    @torch.no_grad()
    def generate_img(self, z, cam2world, img_size=None, num_steps=None):
        """Deterministic render at eval settings (reference utils.py:60-82),
        through the same generator (and kernels) the losses train."""
        meta = self._eval_metadata(img_size, num_steps)
        cfg = RenderConfig.from_metadata(meta, perturb=False)
        return self.state.generator(z, cam2world, cfg, generator=None)

    def sample_imgs(self) -> None:
        """Dump GT/generated rgb+depth grids (utils.py:844-915), then the
        val and test losses."""
        if (self.step + 1) % self.args.sampling_interval != 0:
            return
        self._flush_metrics()  # keep history order: train losses first
        for dataset, path in ((self.trainset, self.samples_train_path),
                              (self.valset, self.samples_val_path),
                              (self.testset, self.samples_test_path)):
            self._sample_from_cameras(dataset, path)
        self.val_loss(self.valset, "photometry_losses_val", "depth_losses_val")
        self.val_loss(self.testset, "photometry_losses_test", "depth_losses_test")

    def _sample_from_cameras(self, dataset, save_dir, num_imgs: int = 12) -> None:
        num_imgs = min(num_imgs, len(dataset))
        ray_end = self.metadata["ray_end"]
        # the grid is a pure function of (seed, step, dataset size): the
        # same in a resumed run as in the uninterrupted one
        grid_rng = random.Random(f"{self.seed}/{self.step}/{len(dataset)}")
        indices = grid_rng.sample(range(len(dataset)), num_imgs)
        samples = [dataset[i] for i in indices]
        batch = self._to_device({k: np.stack([s[k] for s in samples])
                                 for k in ("pcl", "voxel", "cam2world") if k in samples[0]})
        rgb, depth = self.generate_img(self.encode_batch(batch), batch["cam2world"])
        rgb, depth = rgb.cpu().numpy(), depth.cpu().numpy()

        rows_gt, rows_gt_depth, rows_gen, rows_gen_depth = [], [], [], []
        for row, sample in enumerate(samples):
            rows_gt.append(sample["img"] * 0.5 + 0.5)
            gt_depth = sample.get("depth")
            if gt_depth is None:
                gt_depth = np.zeros(sample["img"].shape[:2], np.float32)
            rows_gt_depth.append(np.repeat((gt_depth / ray_end)[..., None], 3, axis=-1))
            rows_gen.append(rgb[row] * 0.5 + 0.5)
            rows_gen_depth.append(np.repeat((depth[row] / ray_end)[..., None], 3, axis=-1))
        # GT rows are read at the sample size; fit them to the render's
        target = rows_gen[0].shape[0]

        def fit(img):
            img = np.asarray(img, np.float32)
            return resize(img, target, "area") if img.shape[0] != target else img

        grid = [fit(x) for x in rows_gt + rows_gt_depth + rows_gen + rows_gen_depth]
        save_image_grid(grid, save_dir / f"{self.step:06}.png", nrow=num_imgs)

    def val_loss(self, dataset, photo_key: str, depth_key: str, batch_size: int = 8) -> None:
        """Fixed-index val/test losses (utils.py:917-972), rendered in
        batches."""
        num_imgs = min(self.metadata.get("val_num_imgs", 48), len(dataset))
        batch_size = min(batch_size, num_imgs)
        num_imgs -= num_imgs % batch_size  # drop_last, as the reference does
        photo_total, depth_total = 0.0, 0.0
        for start in range(0, num_imgs, batch_size):
            samples = [dataset[i] for i in range(start, start + batch_size)]
            batch = self._to_device({k: np.stack([s[k] for s in samples])
                                     for k in ("pcl", "voxel", "cam2world", "img", "depth")
                                     if k in samples[0]})
            rgb, depth = self.generate_img(self.encode_batch(batch), batch["cam2world"])
            photo_total += float(((batch["img"] - rgb) ** 2).mean(dim=(1, 2, 3)).sum())
            if "depth" in batch:
                gt = batch["depth"]
                mask = gt != 0
                per_img = (torch.where(mask, (gt - depth) ** 2, 0.0).sum(dim=(1, 2))
                           / mask.sum(dim=(1, 2)).clamp(min=1))
                depth_total += float(per_img.sum())
        self.histories[photo_key].append([self.step, photo_total / num_imgs])
        self.histories[depth_key].append([self.step, depth_total / num_imgs])

    # ------------------------------------------------------------------
    # persistence / evaluation
    # ------------------------------------------------------------------
    def _checkpoint_payload(self) -> dict:
        return {**self.histories,
                "loader_state": {"epoch": self._loader_epoch, "offset": self._batch_offset}}

    def save_models(self) -> None:
        if (self.step + 1) % self.args.eval_freq == 0:
            self._flush_metrics()  # checkpoints persist the histories
            print(f"Saving checkpoint at step {self.step}")
            save_checkpoint(self.checkpoints_path, self.step, self.state,
                            self._checkpoint_payload())

    def evaluate(self) -> None:
        """FID / oFID / LPIPS / PSNR every eval_freq (utils.py:974-1016): the
        `fid` subset rendered at 128^2 with 96 samples a ray, scored against
        its real images; a fid_history row and a fid.txt line."""
        if (self.step + 1) % self.args.eval_freq != 0:
            return
        self._flush_metrics()
        meta = self._eval_metadata(img_size=128, num_steps=96)
        fid, ofid, lpips_score, psnr = evaluate_trainer(self, meta)
        self.histories["fid_history"].append([self.step, fid, ofid, lpips_score, psnr])
        append_fid_line(Path(self.args.output_dir) / "fid.txt", self.step, fid, ofid,
                        lpips_score, psnr)
        print(f"Metrics at step {self.step}: FID {fid} | oFID {ofid} | "
              f"LPIPS {lpips_score} | PSNR {psnr}", flush=True)
