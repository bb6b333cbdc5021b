"""Inference runtime (port of conditioned_nerf_gan_tpu/infer/inference.py).

Curriculum loading with the eval overrides, model building and port
checkpoints (`{run}/checkpoints/{step}.pt`, written by `save_checkpoint` or
by `bridge.convert_checkpoint`), `encode` (PointNet for point-cloud runs,
the U-Net for voxel runs), `generate_img`, `render_batched`, and every
output of the JAX Inferencer: image grids (`render_imgs`, with the
Rodrigues camera perturbation), orbit videos (`render_video`), colored
point clouds (`render_pcl`, `render_pcl_masked`), density voxels
(`save_voxel`), metrics (`compute_metrics`) and latent interpolation
(`interpolate_latent_codes`). Each renders through the generator, so on the
card through the kernels. Videos are uncompressed AVI (`utils/video.py`)
where the JAX package writes mp4v through cv2: the port uses no cv2. With
`shard_rays`, each render's pixel rows are split over the visible cards
(`parallel.render_ray_sharded`) when there is more than one and the image
size divides by their count, the JAX Inferencer's rule; else it renders
on `device` as without.

Under a torch profiler a request records the spans `infer.encode` (a root,
with the stream's time) and `infer.render_batched` (a root), `infer.h2d`
around each copy of an input from host memory (a pageable copy, which waits
for the work queued before it) and `infer.to_host` around the rendered
arrays' way to numpy (`utils/tracing.py`).
"""

from __future__ import annotations

import math
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
from ..parallel import render_ray_sharded
from ..utils import tracing
from ..utils.image import save_image_grid
from ..utils.rotation import perturb_extrinsics
from ..utils.video import write_avi
from .extract_shapes import sample_sigma_grid
from .mrc import write_mrc


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


def shard_devices(device: torch.device, img_size: int) -> list | None:
    """The cards a `shard_rays` render splits its pixel rows over: every
    visible card, `device`'s first (the slabs meet there), where there is
    more than one and img_size divides over them; else None, and the render
    stays on `device` (the JAX CLI's rule)."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if cards < 2 or img_size % cards:
        return None
    first = device.index if device.index is not None else torch.cuda.current_device()
    return [torch.device("cuda", (first + i) % cards) for i in range(cards)]


def refuse_pyramid(z, caller: str) -> None:
    """Raise on a feature pyramid's ([levels], global) conditioning, which
    the JAX Inferencer cannot render in blocks (see `render_batched`)."""
    if isinstance(z, (tuple, list)) and any(isinstance(p, (tuple, list)) for p in z):
        raise NotImplementedError(
            f"{caller}: a feature pyramid (PyramidUNet3D) is not served: the JAX "
            "Inferencer's _tile_z and its z_batched cut cannot take a list of levels "
            "(a fault of the JAX package, out of scope; ROADMAP C)")


class Inferencer:
    def __init__(self, checkpoint_path: str | Path, sampling_mode: str = "val",
                 input_voxel_resolution: int = 64, z_up: bool = False,
                 num_imgs: int = 8, image_size: int = 128,
                 ray_step_multiplier: int = 1, load_dataset: bool = True,
                 seed: int = 0, device: str | torch.device = "cuda",
                 shard_rays: bool = False):
        self.checkpoint_path = Path(checkpoint_path)
        self.shard_rays = shard_rays
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
            self.fidset = ShapeNetDataset(
                ds["path"], self.curriculum["fid"]["target_size"],
                self.curriculum["fid"]["subset"], self.curriculum,
                load_voxel=ds["load_voxel"], load_pcl=ds["load_pcl"],
                dataset_mode="test", load_img=False, load_depth=False, shuffle=False,
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
    def _tensor(self, x) -> torch.Tensor:
        """An array or a tensor on any device as fp32 on this device."""
        with tracing.h2d_span(x):
            return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def encode(self, sample_batch: dict):
        """{"pcl": (B, P, 6)} -> z (B, z_dim); or {"voxel": (B, D, H, W, C)}
        NDHWC grids, as ShapeNetDataset yields them -> what the U-Net
        returns: a (feature volume (B, D, H, W, C) contiguous, global
        (B, z_dim)) pair, a bare volume, or a ([levels], global) pyramid.
        Arrays or tensors."""
        with tracing.span("infer.encode", device_time=True):
            if self.curriculum["dataset"]["load_pcl"]:
                z, _ = encode_pcl(self.encoder, self._tensor(sample_batch["pcl"]))
                return z
            return self.encoder(self._tensor(sample_batch["voxel"]))

    encode_batch = encode  # the eval's name (eval.fid_evaluation.output_images)

    @torch.no_grad()
    def generate_img(self, z, cam2world, img_size=None, num_steps=None, fov=None):
        meta = dict(self.curriculum)
        meta["img_size"] = img_size or meta["img_size"]
        meta["num_steps"] = num_steps or meta["num_steps"]
        cfg = RenderConfig.from_metadata(meta, perturb=False)
        fov = meta["fov"] if fov is None else fov
        cams = self._tensor(cam2world)
        if not np.isscalar(fov):
            fov = self._tensor(fov)
        devices = shard_devices(self.device, cfg.img_size) if self.shard_rays else None
        if devices:
            return render_ray_sharded(self.generator, self._on_device(z), cams, cfg, devices,
                                      fov=fov)
        return self.generator(self._on_device(z), cams, cfg, generator=None, fov=fov)

    def _on_device(self, z):
        """z (an array, a tensor, or a tuple or list of them, nested) on
        this device."""
        if isinstance(z, (tuple, list)):
            return type(z)(self._on_device(part) for part in z)
        with tracing.h2d_span(z):
            return torch.as_tensor(z, device=self.device)

    def render_batched(self, z, cams, *, fov=None, chunk: int = 8, img_size=None,
                       num_steps=None, z_batched: bool = False):
        """Render views in blocks of `chunk` -> numpy (rgb, depth) stacks.

        `fov` may be a per-view (n,) sweep; `z_batched` means z already has
        batch n (else the single conditioning is repeated per block). A
        (volume, global) pair is cut or repeated member by member, a bare
        volume as a latent is. A feature pyramid is refused: the JAX
        Inferencer's `_tile_z` stacks the ragged levels into one array and
        its `z_batched` cut slices the list of levels, not the batch, so it
        serves no pyramid, and the port adds no mode the JAX package
        lacks."""
        refuse_pyramid(z, "render_batched")
        with tracing.span("infer.render_batched"):
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
                with tracing.span("infer.to_host"):
                    rgbs.append(rgb.cpu().numpy())
                    depths.append(d.cpu().numpy())
            return np.concatenate(rgbs), np.concatenate(depths)

    def _inference_dir(self) -> Path:
        out = self.run_dir / "inference"
        out.mkdir(parents=True, exist_ok=True)
        return out

    @staticmethod
    def _cond_batch(sample: dict) -> dict:
        return {k: np.asarray(v)[None] for k, v in sample.items() if k in ("pcl", "voxel")}

    def _car_cond(self, car) -> tuple[str, dict]:
        """A valset index or a dataset car's name -> (car name, its
        conditioning as a batch of one)."""
        if isinstance(car, int):
            sample = self.valset[car]
            return Path(sample["img_path"]).parent.parent.stem, self._cond_batch(sample)
        return car, self._load_car_cond(car)

    # ------------------------------------------------------------------
    def render_imgs(self, is_fixed: bool) -> Path:
        if is_fixed:
            print("Inference with fixed camera")
            return self._inference_camera(fixed=True)
        print("Inference with uniform spherical camera")
        return self._inference_camera(fixed=False)

    def _inference_camera(self, fixed: bool, cam_noise: float = 0.0) -> Path:
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
            cam = sample["cam2world"] if fixed else cams[row]
            if fixed and cam_noise > 0:
                cam = perturb_extrinsics(cam[None], cam_noise, self.rng)[0]
            cam_rows.append(np.asarray(cam))
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

    # ------------------------------------------------------------------
    # orbit video (reference inference.py:387-499)
    # ------------------------------------------------------------------
    def render_video(self, car, num_frames: int = 240, fps: int = 24) -> Path:
        """The scripted theta/phi/r orbit with a per-frame fov sweep 60 ->
        30, rendered in blocks of 16 frames, written as an uncompressed AVI
        (`inference/video/{run}_{step}_{car}_{stamp}.avi`)."""
        assert num_frames > fps * 4 and num_frames % 4 == 0
        car_name, cond = self._car_cond(car)
        print("Rendering video for car", car_name)
        z = self.encode(cond)

        theta0 = np.linspace(1e-5, np.pi / 2 - 1e-5, num_frames // 2)
        phi0 = np.linspace(0, np.pi * 2, num_frames // 2)
        theta1 = np.linspace(np.pi / 2 - 1e-5, 1e-5, num_frames // 4)
        phi11 = np.linspace(np.pi * 2, np.pi * 5 / 4, fps)
        phi12 = np.full(num_frames // 4 - fps, np.pi * 5 / 4)
        theta21 = np.linspace(1e-5, np.pi / 4 - 1e-5, fps)
        theta22 = np.full(num_frames // 4 - fps, np.pi / 4 - 1e-5)
        phi2 = np.linspace(np.pi * 5 / 4, 0, num_frames // 4)
        theta = np.concatenate([theta0, theta1, theta21, theta22])
        phi = np.concatenate([phi0, phi11, phi12, phi2])
        r = np.linspace(self.curriculum["cam_r_start"], self.curriculum["cam_r_end"],
                        num_frames)
        fovs = np.linspace(60, 30, num_frames)

        origin = np.zeros((num_frames, 3), np.float32)
        origin[:, 0] = r * np.sin(theta) * np.cos(phi)
        if self.up_direction == "z":
            origin[:, 1] = r * np.sin(theta) * np.sin(phi)
            origin[:, 2] = r * np.cos(theta)
        else:
            origin[:, 2] = r * np.sin(theta) * np.sin(phi)
            origin[:, 1] = r * np.cos(theta)
        cams = create_cam2world_matrix(torch.from_numpy(origin), self.up_direction).numpy()

        stamp = datetime.now().strftime("%d--%H:%M:%S")
        out = (self._inference_dir() / "video" /
               f"{self.run_dir.stem}_{self.step}_{car_name}_{stamp}.avi")
        out.parent.mkdir(parents=True, exist_ok=True)
        rgb_all, _ = self.render_batched(z, cams, fov=fovs.astype(np.float32), chunk=16)
        write_avi(out, np.stack([(np.clip(frame, 0, 1)[..., ::-1] * 255).astype(np.uint8)
                                 for frame in rgb_all * 0.5 + 0.5]), fps)
        print("Writing video to", out)
        return out

    # ------------------------------------------------------------------
    # colored pcl export (reference inference.py:501-693)
    # ------------------------------------------------------------------
    def _backproject(self, cam, rgb, depth, valid):
        """The valid pixels of one view in world space (float64 xyz, as the
        JAX package's int pixel indices and float32 depth promote) and their
        [0, 1] colors; focal = 1 / tan(fov / 2)."""
        img_size = self.curriculum["img_size"]
        focal = 1.0 / math.tan(math.radians(self.curriculum["fov"]) / 2.0)
        ys, xs = np.nonzero(valid)
        d = depth[ys, xs]
        x_cam = (2 * xs - (img_size - 1)) / (img_size - 1) / focal * d
        y_cam = (2 * ys - (img_size - 1)) / (img_size - 1) / focal * d
        pts = np.stack([x_cam, y_cam, d, np.ones_like(d)], axis=1)
        return (pts @ cam.T)[:, :3], rgb[ys, xs] * 0.5 + 0.5

    @staticmethod
    def _write_obj(out: Path, pts_xyz: list, pts_rgb: list) -> None:
        xyz = np.concatenate(pts_xyz)
        rgb255 = np.clip(np.concatenate(pts_rgb) * 255 + 0.5, 0, 255).astype(np.uint8)
        with open(out, "w") as f:
            for p, c in zip(xyz, rgb255):
                f.write(f"v {p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")

    def render_pcl(self, pcl_idx: int, num_views: int = 20) -> Path:
        """A colored point cloud (.obj) from `num_views` random cameras'
        depth maps, and the views' rgb + depth grid."""
        sample = self.valset[pcl_idx]
        car_name = Path(sample["img_path"]).parent.parent.stem
        print("Rendering point clouds for car", car_name)
        z = self.encode(self._cond_batch(sample))
        origins = sample_camera_positions(
            num_views, generator=self.torch_rng, up_direction=self.up_direction,
            cam_r_start=self.curriculum["cam_r_start"],
            cam_r_end=self.curriculum["cam_r_end"])
        cams = create_cam2world_matrix(origins, self.up_direction).numpy()

        ray_start, ray_end = self.curriculum["ray_start"], self.curriculum["ray_end"]
        pts_xyz, pts_rgb, rgbs, depth_maps = [], [], [], []
        rgb_all, depth_all = self.render_batched(z, cams)
        for cam, rgb, depth in zip(cams, rgb_all, depth_all):
            rgbs.append(rgb * 0.5 + 0.5)
            depth_maps.append(np.repeat((depth / ray_end)[..., None], 3, -1))
            xyz, colors = self._backproject(cam, rgb, depth,
                                            (depth > ray_start) & (depth < ray_end))
            pts_xyz.append(xyz)
            pts_rgb.append(colors)
        stamp = datetime.now().strftime("%d--%H:%M:%S")
        out = self._inference_dir() / f"{self.step}_{car_name}_{stamp}.obj"
        self._write_obj(out, pts_xyz, pts_rgb)
        print("Saving pcl to", out)
        save_image_grid(rgbs + depth_maps,
                        self._inference_dir() / f"{self.step}_pcl_{stamp}.png", nrow=num_views)
        return out

    def render_pcl_masked(self, pcl_idx: int, num_views: int = 8, mask: bool = True) -> Path:
        """Colored-pcl export from *dataset* views, optionally masking the
        backprojected depth with the GT depth map (`depth/{view:04}.npy`,
        else `{view:04}0001.exr`), resized bilinearly to the render's size."""
        from ..data.exr import read_exr_depth
        from ..utils.resize import resize

        sample0 = self.valset[pcl_idx]
        car_dir = Path(sample0["img_path"]).parent.parent
        car_name = car_dir.stem
        z = self.encode(self._cond_batch(sample0))
        cams_npz = np.load(car_dir / "cameras.npz")
        n_available = len([k for k in cams_npz.files if k.startswith("world_mat_inv_")])
        views = random.sample(range(n_available), min(num_views, n_available))

        img_size = self.curriculum["img_size"]
        ray_start, ray_end = self.curriculum["ray_start"], self.curriculum["ray_end"]
        pts_xyz, pts_rgb = [], []
        view_cams = np.stack([cams_npz[f"world_mat_inv_{view}"].astype(np.float32)
                              for view in views])
        rgb_all, depth_all = self.render_batched(z, view_cams)
        for view, cam, rgb, depth in zip(views, view_cams, rgb_all, depth_all):
            valid = (depth > ray_start) & (depth < ray_end)
            if mask:
                depth_npy = car_dir / "depth" / f"{view:04}.npy"
                exr = car_dir / "depth" / f"{view:04}0001.exr"
                gt = None
                if depth_npy.exists():
                    gt = np.load(depth_npy)
                elif exr.exists():
                    gt = read_exr_depth(exr, img_size)
                if gt is not None:
                    if gt.shape[0] != img_size:
                        gt = resize(gt, img_size, "linear")  # cv2.resize's default
                    valid &= gt > 1e-4
            xyz, colors = self._backproject(cam, rgb, depth, valid)
            pts_xyz.append(xyz)
            pts_rgb.append(colors)
        stamp = datetime.now().strftime("%d--%H:%M:%S")
        out = self._inference_dir() / f"{self.step}_{car_name}_masked_{stamp}.obj"
        self._write_obj(out, pts_xyz, pts_rgb)
        print("Saving masked pcl to", out)
        return out

    # ------------------------------------------------------------------
    # density voxel export (reference inference.py:342-385)
    # ------------------------------------------------------------------
    def save_voxel(self, car, cube_size: float = 1.2, voxel_resolution: int = 48) -> Path:
        """The sigma grid of a car's conditioning over a `cube_size` cube at
        voxel_resolution^3 points, as `inference/{car}.mrc`."""
        car_name, cond = self._car_cond(car)
        grid = sample_sigma_grid(
            self.generator.eval_points, self.encode(cond), voxel_resolution=voxel_resolution,
            cube_length=cube_size, max_points=min(64 ** 3, voxel_resolution ** 3),
            device=self.device)
        out = self._inference_dir() / f"{car_name}.mrc"
        write_mrc(out, grid)
        print("Save voxel to", out)
        return out

    # ------------------------------------------------------------------
    # metrics (reference inference.py:695-729)
    # ------------------------------------------------------------------
    def compute_metrics(self):
        """FID, oFID, LPIPS and PSNR of the `fid` subset rendered into
        `evaluation_{voxres}_{num_steps}_{step}_128/`, appended to the run's
        fid_inference.txt as `{step} {voxres} {num_steps} {fid} {ofid}
        {lpips} {psnr}`."""
        from ..eval import output_images, setup_evaluation
        from ..eval.metrics import compute_metrics_from_dirs
        from ..eval.weights import stamp_metric_log

        meta = self.curriculum
        self.evaluation_path = self.run_dir / (
            f"evaluation_{meta['voxel_resolution']}_{meta['num_steps']}_{self.step}_128")
        self.evaluation_path.mkdir(exist_ok=True)
        real_dir = setup_evaluation(meta)
        output_images(self, meta, self.evaluation_path)
        results = compute_metrics_from_dirs(
            real_dir, self.evaluation_path, Path(meta["dataset"]["path"]).parent / "val.lst",
            device=self.device)
        fid, ofid, lpips_score, psnr = results
        stamp_metric_log(self.run_dir / "fid_inference.txt")
        with open(self.run_dir / "fid_inference.txt", "a") as f:
            f.write(f"{self.step} {meta['voxel_resolution']} {meta['num_steps']} "
                    f"{fid} {ofid} {lpips_score} {psnr}\n")
        print(f"Metrics at step {self.step}: FID {fid} | oFID {ofid} | "
              f"LPIPS {lpips_score} | PSNR {psnr}")
        return results

    # ------------------------------------------------------------------
    # latent interpolation (reference inference.py:731-834)
    # ------------------------------------------------------------------
    def interpolate_latent_codes(self, src_id: str, tgt_id: str, save_dir: str | Path,
                                 mode: str = "fz", interpolate_n: int = 8) -> Path:
        """interpolate_n + 1 renders from src's conditioning to tgt's, seen
        from src's view 20 (else view 0), as one grid. On a (volume,
        global) pair `mode` lerps both ("fz"), the volume ("f") or the
        global feature ("z"). Needs no valset."""
        z_src = self.encode(self._load_car_cond(src_id))
        z_tgt = self.encode(self._load_car_cond(tgt_id))
        refuse_pyramid(z_src, "interpolate_latent_codes")
        cams_npz = np.load(Path(self.curriculum["dataset"]["path"]) / src_id / "cameras.npz")
        cam_key = ("world_mat_inv_20" if "world_mat_inv_20" in cams_npz.files
                   else "world_mat_inv_0")
        cam = cams_npz[cam_key].astype(np.float32)[None]

        ts = np.linspace(0.0, 1.0, interpolate_n + 1, dtype=np.float32)

        def lerp(a, b):  # (1, ...) pair -> (len(ts), ...) stack, fp32 weights
            return torch.cat([float(1 - t) * a + float(t) * b for t in ts])

        if isinstance(z_src, tuple):
            fv = lerp(z_src[0], z_tgt[0])
            gz = lerp(z_src[1], z_tgt[1])
            if mode == "f":
                z_it = (fv, z_src[1].repeat_interleave(len(ts), dim=0))
            elif mode == "z":
                z_it = (z_src[0].repeat_interleave(len(ts), dim=0), gz)
            else:
                z_it = (fv, gz)
        else:
            z_it = lerp(z_src, z_tgt)
        rgb_all, _ = self.render_batched(z_it, np.repeat(cam, len(ts), axis=0), z_batched=True)

        out = Path(save_dir) / f"{src_id}_to_{tgt_id}_{mode}.png"
        out.parent.mkdir(parents=True, exist_ok=True)
        save_image_grid([rgb * 0.5 + 0.5 for rgb in rgb_all], out, nrow=interpolate_n + 1,
                        padding=0)
        print("saving image to", out)
        return out
