"""ShapeNet renders dataset + host-side loaders.

Parity target: reference datasets.py:19-315 —
  * car list from `{dataset_root_parent}/{sampling_mode}.lst`
  * train = all-but-last view per car, val = last view, test = all views
  * 16-bit PNG → [0,1] → Normalize(0.5, 0.5), resized with
    INTER_LINEAR (up) / INTER_AREA (down)
  * cam2world from `cameras.npz["world_mat_inv_{i}"]`
  * EXR depth with inf(65504)→0 background
  * voxel[_32|_128].npz loaded channel-last (the torch permute(3,2,1,0) to
    (C, z, y, x) becomes a transpose to (z, y, x, C) in NDHWC)
  * pcl_color.npy randomly subsampled by num_points_ratio
  * conditioning view selection: random / nearest / furthest by camera distance
  * tiny-subset multifold ×3000 (datasets.py:239-241)

TPU-first: the loader produces fixed-shape numpy batches (static shapes for
jit), shards the index space by (process_index, process_count) instead of a
DistributedSampler, and prefetches on a background thread.
"""

from __future__ import annotations

import os
import random
import threading
import queue as queue_mod
from pathlib import Path

import numpy as np

from ..utils.png import read_png
from ..utils.resize import resize
from .exr import read_exr_depth


def _resize_mode(img_size: int, src_size: int) -> str:
    """INTER_LINEAR to enlarge, INTER_AREA to shrink (datasets.py:176-179)."""
    return "linear" if img_size > src_size else "area"


def _read_resize_png16(path: str | Path, img_size: int) -> np.ndarray:
    """16-bit RGBA png → (H, W, 3) float in [0, 1] (datasets.py:172-180),
    decoded and resized with cv2's rules by the port's own code."""
    x = read_png(path)[..., :3]
    if img_size != x.shape[0]:
        x = resize(x, img_size, _resize_mode(img_size, x.shape[0]))
    return x / (2 ** 16 - 1)


def cond_view_size(metadata: dict, img_size: int) -> int:
    """The conditioning views' side: 256 for the projection D (its ResNet18's
    input), else the image size."""
    if metadata.get("discriminator") == "ProgressiveDiscriminator_projection":
        return 256
    return img_size


def sample_cond(img_path: Path, cameras, mode: str, rng: random.Random) -> Path:
    """Pick a conditioning view (datasets.py:219-234)."""
    current_id = int(img_path.stem)
    n_views = len([k for k in cameras.files if k.startswith("world_mat_inv_")])
    if mode == "random":
        new_id = (current_id + rng.randint(1, n_views - 1)) % n_views
        return img_path.parent / f"{new_id:04}.png"
    cam_origins = np.stack(
        [cameras[f"world_mat_inv_{i}"][:3, -1] for i in range(n_views)]
    )
    order = np.argsort(np.linalg.norm(cam_origins - cam_origins[current_id], axis=1))
    if mode == "nearest":
        return img_path.parent / f"{order[1]:04}.png"
    if mode == "furthest":
        return img_path.parent / f"{order[-1]:04}.png"
    raise ValueError(f"Unsupported cond mode {mode!r}")


class ShapeNetDataset:
    """Per-view samples over a ShapeNet renders directory tree."""

    def __init__(
        self,
        dataset_path: str | Path,
        img_size: int,
        sampling_mode: str,
        metadata: dict,
        load_voxel: bool,
        load_pcl: bool,
        dataset_mode: str = "train",
        shuffle: bool = True,
        multifold: int = 1,
        load_img: bool = True,
        load_depth: bool = True,
        load_cam: bool = True,
        cond_mode: str | None = None,
        voxel_resolution: int = 64,
        num_points: int | None = None,
        seed: int = 0,
    ):
        dataset_path = Path(dataset_path)
        test_view_per_car = 1
        lst = dataset_path.parent / f"{sampling_mode}.lst"
        with open(lst, "r") as f:
            cars = [line.strip() for line in f if line.strip()]
        self.data: list[Path] = []
        for car in cars:
            imgs = sorted(
                p for p in (dataset_path / car / "image").iterdir()
                if p.suffix == ".png"
            )
            if dataset_mode == "train":
                self.data += imgs[:-test_view_per_car]
            elif dataset_mode == "val":
                self.data += imgs[-test_view_per_car:]
            elif dataset_mode == "test":
                self.data += imgs
            else:
                raise ValueError(f"Undefined dataset mode {dataset_mode!r}")

        self.data *= multifold
        self.seed = seed
        self._epoch_key = (seed + 1) * 1_000_003  # reseed(0) equivalent
        if shuffle:
            random.Random(seed).shuffle(self.data)

        self.img_size = img_size
        self.metadata = metadata
        self._use_native = False
        if os.environ.get("CNG_NATIVE_LOADER") == "1":
            from . import native

            if not native.available():
                raise RuntimeError(
                    "CNG_NATIVE_LOADER=1 (--native_loader) but the fastload library "
                    f"could not be built or loaded: {native.build_error()}. Install g++ "
                    "and zlib's headers (the build runs `g++ -O3 -shared ... -lz "
                    "-lpthread` on native/fastload.cc), or unset CNG_NATIVE_LOADER")
            self._use_native = True
        self.load_img = load_img
        self.load_depth = load_depth
        self.load_voxel = load_voxel
        self.load_pcl = load_pcl
        self.load_cam = load_cam
        self.cond_mode = cond_mode
        self.voxel_resolution = voxel_resolution
        # Static point count per sample (jit needs fixed shapes): resolved
        # from num_points_ratio against the first car's point cloud.
        self.num_points = num_points
        if load_pcl and num_points is None:
            pcl0 = np.load(self.data[0].parent.parent / "pcl_color.npy", mmap_mode="r")
            ratio = metadata.get("num_points_ratio", 1.0)
            self.num_points = max(1, int(pcl0.shape[0] * ratio))

    def reseed(self, epoch: int) -> None:
        """Key the per-sample rng (pcl subsample, cond-view pick) to (seed,
        epoch). Each __getitem__ builds its own rng from (epoch_key, index),
        so a sample's content is a pure function of (seed, epoch, index) —
        independent of how many accesses preceded it or in what order. That
        invariant is what lets a resumed run jump the loader straight to the
        checkpointed position (DataLoader.start_batch) without decoding the
        skipped batches, and still replay bit-exactly (trainer.py resume
        continuity)."""
        self._epoch_key = (self.seed + 1) * 1_000_003 + epoch

    def _item_rng(self, index: int) -> random.Random:
        # disjoint streams per (epoch, index): the epoch key occupies bits
        # above any realistic dataset length (multifold ×3000 ≪ 2^40)
        return random.Random((self._epoch_key << 40) | index)

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        return self._item(index)

    @property
    def _cond_size(self) -> int:
        return cond_view_size(self.metadata, self.img_size)

    def _item(self, index: int, defer: dict | None = None) -> dict:
        """One sample dict. With `defer`, the decode-heavy fields (img, cond,
        EXR depth) are not decoded here; their paths are appended to the
        defer lists for a single batched native call (see get_batch)."""
        sample: dict = {}
        rng = self._item_rng(index)
        img_path = self.data[index]
        sample["img_path"] = str(img_path)
        car_dir = img_path.parent.parent

        if self.load_img:
            if defer is not None:
                defer["img"].append(str(img_path))
            elif self._use_native:
                from . import native

                sample["img"] = native.read_png16(img_path, self.img_size)
            else:
                x = _read_resize_png16(img_path, self.img_size)
                sample["img"] = ((x - 0.5) / 0.5).astype(np.float32)  # [-1,1]

        if self.cond_mode or self.load_cam:
            cameras = np.load(car_dir / "cameras.npz")
            if self.load_cam:
                sample["cam2world"] = cameras[
                    f"world_mat_inv_{int(img_path.stem)}"
                ].astype(np.float32)
            if self.cond_mode:
                cond_path = sample_cond(img_path, cameras, self.cond_mode, rng)
                if defer is not None:
                    defer["cond"].append(str(cond_path))
                else:
                    cond = _read_resize_png16(cond_path, self._cond_size)
                    sample["cond"] = ((cond - 0.5) / 0.5).astype(np.float32)

        if self.load_depth:
            depth_path = car_dir / "depth" / (img_path.stem + "0001.exr")
            if depth_path.exists():
                if defer is not None:
                    defer["depth"].append(str(depth_path))
                    defer["depth_pos"].append(defer["pos"])
                    depth = None
                elif self._use_native:
                    from .native import read_exr_depth_native

                    depth = read_exr_depth_native(depth_path, self.img_size)
                else:
                    depth = read_exr_depth(depth_path, self.img_size)
            else:  # synthetic fixtures store depth as .npy
                depth = np.load(car_dir / "depth" / (img_path.stem + ".npy"))
                if depth.shape[0] != self.img_size:
                    depth = resize(depth, self.img_size,
                                   _resize_mode(self.img_size, depth.shape[0]))
            if depth is not None:
                sample["depth"] = depth.astype(np.float32)

        if self.load_voxel:
            name = {64: "voxel.npz", 32: "voxel_32.npz", 128: "voxel_128.npz"}.get(
                self.voxel_resolution
            )
            if name is None:
                raise ValueError("Unsupported voxel resolution")
            vox = np.load(car_dir / name)["voxel"]  # (x, y, z, C)
            # torch permute(3,2,1,0)→(C,z,y,x); NDHWC equivalent: (z,y,x,C)
            sample["voxel"] = np.ascontiguousarray(
                vox.transpose(2, 1, 0, 3)
            ).astype(np.float32)

        if self.load_pcl:
            pcl = np.load(car_dir / "pcl_color.npy").astype(np.float32)
            idx = rng.sample(range(pcl.shape[0]), min(self.num_points, pcl.shape[0]))
            pcl = pcl[idx]
            if pcl.shape[0] < self.num_points:  # pad by repetition (static shape)
                reps = -(-self.num_points // pcl.shape[0])
                pcl = np.tile(pcl, (reps, 1))[: self.num_points]
            sample["pcl"] = pcl
        return sample

    def get_batch(self, indices: list[int]) -> dict:
        """Collated batch. With the native loader active, every PNG / EXR in
        the batch decodes through one C++ thread-pool call per field
        (native/fastload.cc) instead of len(indices) Python round-trips —
        the TPU replacement for the reference's 8 DataLoader worker
        processes (datasets.py:257-302, num_workers in special.py:31)."""
        if not self._use_native or len(indices) < 2:
            return _collate([self[i] for i in indices])
        from . import native

        defer: dict = {"img": [], "cond": [], "depth": [], "depth_pos": []}
        samples = []
        for k, i in enumerate(indices):
            defer["pos"] = k
            samples.append(self._item(i, defer))
        if defer["img"]:
            imgs = native.read_png16_batch(defer["img"], self.img_size)
            for s, im in zip(samples, imgs):
                s["img"] = im
        if defer["cond"]:
            conds = native.read_png16_batch(defer["cond"], self._cond_size)
            for s, c in zip(samples, conds):
                s["cond"] = c
        if defer["depth"]:
            depths = native.read_exr_depth_batch(defer["depth"], self.img_size)
            for pos, d in zip(defer["depth_pos"], depths):
                samples[pos]["depth"] = d
        return _collate(samples)


def _collate(samples: list[dict]) -> dict:
    batch = {}
    for key in samples[0]:
        if key == "img_path":
            batch[key] = [s[key] for s in samples]
        else:
            batch[key] = np.stack([s[key] for s in samples])
    return batch


class DataLoader:
    """Minimal prefetching batch loader with per-process sharding.

    Replaces torch DataLoader + DistributedSampler (reference
    datasets.py:257-302): each JAX process reads the strided subset
    `indices[process_index::process_count]`, shuffled per epoch, batched with
    drop_last, prefetched on a daemon thread.
    """

    def __init__(
        self,
        dataset: ShapeNetDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        prefetch: int = 2,
        indices: list[int] | None = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        self.epoch = 0
        self._indices = indices
        # one-shot resume offset: the next __iter__ starts at this batch
        # without loading the skipped ones (sample content is a pure
        # function of (seed, epoch, index) — see ShapeNetDataset.reseed)
        self.start_batch = 0

    def __len__(self) -> int:
        if self._indices is not None:
            n = len(self._indices)
        else:
            n = len(range(self.process_index, len(self.dataset), self.process_count))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> list[int]:
        if self._indices is not None:
            return list(self._indices)
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        return idx[self.process_index :: self.process_count]

    def __iter__(self):
        idx = self._epoch_indices()
        if hasattr(self.dataset, "reseed"):
            self.dataset.reseed(self.epoch)
        self.epoch += 1
        n_batches = len(idx) // self.batch_size if self.drop_last else -(
            -len(idx) // self.batch_size
        )
        start, self.start_batch = self.start_batch, 0
        q: queue_mod.Queue = queue_mod.Queue(maxsize=self.prefetch)

        get_batch = getattr(self.dataset, "get_batch", None)

        # abandoning the iterator mid-epoch (curriculum milestone restarts,
        # --stop_step early return) must release the worker: a plain
        # q.put would block forever on the bounded queue with no consumer,
        # leaking the thread plus `prefetch` decoded batches per milestone
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def worker():
            # decode errors (corrupt PNG/EXR, missing file — the native
            # loaders raise RuntimeError on any of them) must travel through
            # the queue: a worker that dies without putting anything leaves
            # the consumer blocked on q.get() forever, wedging training
            # silently instead of failing loudly
            try:
                for b in range(start, n_batches):
                    chunk = idx[b * self.batch_size : (b + 1) * self.batch_size]
                    if get_batch is not None:
                        item = get_batch(chunk)
                    else:
                        item = _collate([self.dataset[i] for i in chunk])
                    if not put(item):
                        return
                put(None)
            except BaseException as exc:  # noqa: BLE001 — forwarded, not eaten
                put(exc)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError("DataLoader worker failed") from item
                yield item
        finally:
            stop.set()


def get_dataloader(
    metadata: dict,
    process_index: int = 0,
    process_count: int = 1,
    seed: int = 0,
) -> DataLoader:
    """Build the train loader from curriculum metadata (datasets.py:237-302)."""
    trainset = metadata["dataset"]["trainset"]
    # reference hardcodes x3000 for its tiny subsets (datasets.py:239-241);
    # the curriculum key overrides it so small custom datasets can still
    # fill steps_per_dispatch windows (epochs must carry >= k batches)
    multifold = int(
        metadata.get("multifold")
        or (3000 if trainset in ("twenty", "single") else 1)
    )
    dataset = ShapeNetDataset(
        metadata["dataset"]["path"],
        metadata["img_size"],
        trainset,
        metadata,
        metadata["dataset"]["load_voxel"],
        metadata["dataset"]["load_pcl"],
        shuffle=True,
        multifold=multifold,
        cond_mode=metadata["dataset"].get("cond_mode") or None,
        voxel_resolution=metadata.get("voxel_resolution", 64),
        load_depth=metadata["dataset"].get("load_depth", False),
        seed=seed,
    )
    return DataLoader(
        dataset,
        batch_size=metadata["batch_size"],
        shuffle=True,
        drop_last=True,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )
