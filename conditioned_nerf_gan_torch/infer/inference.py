"""Inference runtime (port of conditioned_nerf_gan_tpu/infer/inference.py).

Ported: curriculum loading with the eval overrides, model building and port
checkpoints (`{run}/checkpoints/{step}.pt`, written by `save_checkpoint` or
by `bridge.convert_checkpoint`), `encode` (PointNet for point-cloud runs,
the U-Net for voxel runs), `generate_img`, `render_batched`, the image grids
(`render_imgs`) and `_load_car_cond`. Video, colored pcl, voxel export,
metrics and latent interpolation are ROADMAP A10.
"""

from __future__ import annotations

import random
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config import (
    curriculum_from_json,
    curriculum_to_json,
    extract_metadata,
    load_curriculum,
)
from ..models.generator import ImplicitGenerator3d, RenderConfig
from ..models.pointnet import ResnetPointnet, encode_pcl
from ..models.unet3d import make_unet
from ..ops.rays import create_cam2world_matrix, sample_camera_positions


def load_metadata(step: int, run_dir: str | Path | None = None,
                  config: str | None = None) -> dict:
    """Curriculum metadata at `step`: the run's curriculum.json when it has
    one, else the `thousand` preset chain (the thesis model), overlaid with
    the preset `config` of that chain when one is named (e.g. "dg")."""
    path = Path(run_dir) / "curriculum.json" if run_dir is not None else None
    if path is not None and path.exists():
        print("Loading curriculum from", path)
        curriculum = curriculum_from_json(path)
    else:
        print("Creating curriculum from the thousand preset chain",
              f"with {config}" if config else "")
        curriculum = load_curriculum(config_base="thousand", config=config)
    return extract_metadata(curriculum, step)


def voxel_to_ndhwc(voxel: np.ndarray) -> np.ndarray:
    """A voxel grid as stored, (x, y, z, C), to the encoder's NDHWC
    (z, y, x, C): the dataset's transpose (the torch permute(3, 2, 1, 0))."""
    return np.ascontiguousarray(np.asarray(voxel).transpose(2, 1, 0, 3)).astype(np.float32)


def compute_dtype(meta: dict) -> torch.dtype | None:
    """The metadata's precision policy (`compute_dtype`, "bfloat16" in the
    presets) as a torch dtype; None (fp32) without one."""
    name = meta.get("compute_dtype")
    return getattr(torch, name) if name else None


def build_models(meta: dict, generator: torch.Generator | None = None):
    """Generator and encoder for a curriculum's resolved metadata, fp32
    params initialised from `generator` (the JAX package's init schemes).
    Both take the metadata's `compute_dtype` policy, as the JAX Trainer and
    Inferencer build them."""
    gen_meta = meta["generator"]
    if not (meta["dataset"]["load_voxel"] or meta["dataset"]["load_pcl"]):
        raise ValueError("curriculum must enable load_pcl or load_voxel")
    dtype = compute_dtype(meta)
    G = ImplicitGenerator3d(
        siren_type=gen_meta["siren_type"],
        z_dim=gen_meta["z_dim"],
        input_dim=gen_meta.get("input_dim", 3),
        output_dim=gen_meta.get("output_dim", 4),
        hidden_dim=gen_meta.get("hidden_dim", 256),
        drop_out=gen_meta.get("drop_out", meta.get("dropout_ratio", 0)),
        mapping_network=gen_meta.get("mapping_network", "CustomMappingNetwork"),
        compute_dtype=dtype,
        use_fast_sin=meta.get("use_fast_sin", False),
        use_kernel=meta.get("use_pallas", False),
        generator=generator,
    )
    if meta["dataset"]["load_voxel"]:
        E = make_unet(compute_dtype=dtype, generator=generator, **meta["unet"])
    else:
        E = ResnetPointnet(c_dim=gen_meta["z_dim"], compute_dtype=dtype, generator=generator)
    return G, E


def save_checkpoint(path: str | Path, step: int, generator_model: torch.nn.Module,
                    encoder: torch.nn.Module, config: str | None = None) -> Path:
    """Write a port checkpoint {"step", "params_G", "params_E"}. With
    `config`, the run (`path`'s grandparent) also gets that preset's
    curriculum (`load_metadata`'s chain) as its curriculum.json, which the
    Inferencer loads."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if config is not None:
        curriculum_to_json(load_curriculum(config_base="thousand", config=config),
                           path.parent.parent / "curriculum.json")
    torch.save({"step": step,
                "params_G": {k: v.detach().cpu() for k, v in
                             generator_model.state_dict().items()},
                "params_E": {k: v.detach().cpu() for k, v in
                             encoder.state_dict().items()}}, path)
    return path


class Inferencer:
    def __init__(self, checkpoint_path: str | Path, sampling_mode: str = "val",
                 input_voxel_resolution: int = 64, z_up: bool = False,
                 num_imgs: int = 8, image_size: int = 128,
                 ray_step_multiplier: int = 1, load_dataset: bool = True,
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.checkpoint_path = Path(checkpoint_path)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"Inferencer: device {str(device)!r} asked for, but no "
                               "CUDA GPU is available; pass device=\"cpu\" to render "
                               "with the fp32 plain path")
        self.num_imgs = num_imgs
        self.image_size = image_size
        self.ray_step_multiplier = ray_step_multiplier
        self.up_direction = "z" if z_up else "y"
        self.rng = np.random.default_rng(seed)
        self.torch_rng = torch.Generator().manual_seed(seed)
        self.step = int(self.checkpoint_path.stem)
        self.run_dir = self.checkpoint_path.parent.parent
        self.curriculum = self._get_curriculum(input_voxel_resolution)
        self._set_models()
        if load_dataset:
            from ..data import ShapeNetDataset

            ds = self.curriculum["dataset"]
            self.valset = ShapeNetDataset(
                ds["path"], image_size, sampling_mode, self.curriculum,
                load_voxel=ds["load_voxel"], load_pcl=ds["load_pcl"],
                dataset_mode="test", shuffle=True,
                voxel_resolution=self.curriculum["voxel_resolution"],
                load_depth=True, seed=seed,
            )

    def _get_curriculum(self, input_voxel_resolution: int) -> dict:
        meta = load_metadata(self.step, self.run_dir)
        meta["voxel_resolution"] = input_voxel_resolution
        meta["num_steps"] = int(48 * self.ray_step_multiplier)
        meta["img_size"] = self.image_size
        meta["psi"] = 1
        meta["v_stddev"] = 0
        meta["h_stddev"] = 0
        meta["last_back"] = meta.get("eval_last_back", False)
        meta["nerf_noise"] = 0
        meta["noise_weight"] = 0
        return meta

    def _set_models(self) -> None:
        self.generator, self.encoder = build_models(self.curriculum)
        ckpt = torch.load(self.checkpoint_path, map_location="cpu", weights_only=True)
        self.generator.load_state_dict(ckpt["params_G"])
        self.encoder.load_state_dict(ckpt["params_E"])
        self.generator.to(self.device).eval()
        self.encoder.to(self.device).eval()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def encode(self, sample_batch: dict):
        """{"pcl": (B, P, 6)} -> z (B, z_dim); or {"voxel": (B, D, H, W, C)}
        NDHWC grids, as ShapeNetDataset yields them -> the U-Net's
        (feature volume (B, D, H, W, C) contiguous, global (B, z_dim))."""
        if self.curriculum["dataset"]["load_pcl"]:
            pcl = torch.as_tensor(np.asarray(sample_batch["pcl"]), dtype=torch.float32,
                                  device=self.device)
            z, _ = encode_pcl(self.encoder, pcl)
            return z
        voxel = torch.as_tensor(np.asarray(sample_batch["voxel"]), dtype=torch.float32,
                                device=self.device)
        return self.encoder(voxel)

    @torch.no_grad()
    def generate_img(self, z, cam2world, img_size=None, num_steps=None, fov=None):
        meta = dict(self.curriculum)
        meta["img_size"] = img_size or meta["img_size"]
        meta["num_steps"] = num_steps or meta["num_steps"]
        cfg = RenderConfig.from_metadata(meta, perturb=False)
        fov = meta["fov"] if fov is None else fov
        cams = torch.as_tensor(np.asarray(cam2world), dtype=torch.float32,
                               device=self.device)
        if not np.isscalar(fov):
            fov = torch.as_tensor(np.asarray(fov), dtype=torch.float32,
                                  device=self.device)
        if isinstance(z, (tuple, list)):
            z = tuple(torch.as_tensor(part, device=self.device) for part in z)
        else:
            z = torch.as_tensor(z, device=self.device)
        return self.generator(z, cams, cfg, generator=None, fov=fov)

    def render_batched(self, z, cams, *, fov=None, chunk: int = 8, img_size=None,
                       num_steps=None, z_batched: bool = False):
        """Render views in blocks of `chunk` -> numpy (rgb, depth) stacks.

        `fov` may be a per-view (n,) sweep; `z_batched` means z already has
        batch n (else the single conditioning is repeated per block). A
        (volume, global) pair is cut or repeated member by member."""
        cams = np.asarray(cams)
        n = cams.shape[0]
        parts = tuple(z) if isinstance(z, (tuple, list)) else (z,)
        rgbs, depths = [], []
        for s in range(0, n, chunk):
            e = min(s + chunk, n)
            z_c = tuple(p[s:e] if z_batched else p.repeat_interleave(e - s, dim=0)
                        for p in parts)
            z_c = z_c if len(parts) > 1 else z_c[0]
            fov_c = None
            if fov is not None:
                fov_c = fov if np.ndim(fov) == 0 else np.asarray(fov[s:e])
            rgb, d = self.generate_img(z_c, cams[s:e], img_size=img_size,
                                       num_steps=num_steps, fov=fov_c)
            rgbs.append(rgb.cpu().numpy())
            depths.append(d.cpu().numpy())
        return np.concatenate(rgbs), np.concatenate(depths)

    def _inference_dir(self) -> Path:
        out = self.run_dir / "inference"
        out.mkdir(parents=True, exist_ok=True)
        return out

    # ------------------------------------------------------------------
    def render_imgs(self, is_fixed: bool) -> Path:
        if is_fixed:
            print("Inference with fixed camera")
            return self._inference_camera(fixed=True)
        print("Inference with uniform spherical camera")
        return self._inference_camera(fixed=False)

    def _inference_camera(self, fixed: bool) -> Path:
        from ..utils.image import save_image_grid

        n = min(self.num_imgs, len(self.valset))
        indices = (random.sample(range(len(self.valset)), n) if fixed
                   else list(range(n)))
        ray_end = self.curriculum["ray_end"]

        if not fixed:
            origins = sample_camera_positions(
                n, generator=self.torch_rng, up_direction=self.up_direction,
                cam_r_start=self.curriculum["cam_r_start"],
                cam_r_end=self.curriculum["cam_r_end"],
            )
            cams = create_cam2world_matrix(origins, self.up_direction).numpy()

        samples = [self.valset[i] for i in indices]
        gt_rows, gt_depth_rows, gen_rows, gen_depth_rows, cam_rows = [], [], [], [], []
        for row, sample in enumerate(samples):
            gt_rows.append(sample["img"] * 0.5 + 0.5)
            depth = sample.get("depth", np.zeros(sample["img"].shape[:2], np.float32))
            gt_depth_rows.append(np.repeat((depth / ray_end)[..., None], 3, -1))
            cam_rows.append(np.asarray(sample["cam2world"] if fixed else cams[row]))
        z = self.encode({k: np.stack([np.asarray(s[k]) for s in samples])
                         for k in ("pcl", "voxel") if k in samples[0]})
        rgb_all, d_all = self.render_batched(z, np.stack(cam_rows), z_batched=True)
        for rgb, d in zip(rgb_all, d_all):
            gen_rows.append(rgb * 0.5 + 0.5)
            gen_depth_rows.append(np.repeat((d / ray_end)[..., None], 3, -1))

        stamp = datetime.now().strftime("%d--%H:%M:%S.%f")
        mode = "fixed" if fixed else "random"
        out = self._inference_dir() / f"{self.step}_{mode}_{stamp}.png"
        save_image_grid(gt_rows + gt_depth_rows + gen_rows + gen_depth_rows, out,
                        nrow=n, padding=0)
        print("Save image to", out)
        return out

    def _load_car_cond(self, car_name: str) -> dict:
        """A dataset car's conditioning as a batch of one: its colored point
        cloud (a `num_points_ratio` random subset), or its voxel grid at
        the run's `voxel_resolution` in NDHWC."""
        root = Path(self.curriculum["dataset"]["path"]) / car_name
        if self.curriculum["dataset"]["load_pcl"]:
            pcl = np.load(root / "pcl_color.npy").astype(np.float32)
            ratio = self.curriculum.get("num_points_ratio", 1.0)
            n = max(1, int(pcl.shape[0] * ratio))
            return {"pcl": pcl[self.rng.permutation(pcl.shape[0])[:n]][None]}
        name = {64: "voxel.npz", 32: "voxel_32.npz", 128: "voxel_128.npz"}[
            self.curriculum["voxel_resolution"]]
        return {"voxel": voxel_to_ndhwc(np.load(root / name)["voxel"])[None]}
