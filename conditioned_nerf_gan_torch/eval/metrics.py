"""FID, oFID, LPIPS and PSNR (port of conditioned_nerf_gan_tpu/eval/metrics.py).

  * FID over the 2048-d Inception vectors of two whole directories;
  * oFID: a Frechet distance per object over its views' 17 x 17 x 768
    Inception maps (17 * 17 * views samples of 768), >= 10 views an object,
    by scipy's sqrtm (exact) or Newton-Schulz on the device;
  * LPIPS (AlexNet) over [0, 1] images mapped to [-1, 1];
  * PSNR;
  * the directory-pair metrics over `{car}_{i:04}.png` names against a car
    list.
The nets run on `device` (the card unless the caller asks for the CPU) in
`torch.no_grad()`, `batch` images a call; the statistics and the Frechet
distance stay numpy and scipy, as in the JAX package. PNGs are read with
the port's `utils/png.py` (cv2's IMREAD_COLOR rules: RGB, 8 bits).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..utils.png import read_png


def _cov(feat: np.ndarray) -> np.ndarray:
    """Sample covariance over rows."""
    return np.cov(feat, rowvar=False)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Exact Frechet distance with scipy's sqrtm (called without `disp`,
    which newer scipy no longer takes; the JAX package discards the error
    estimate it returns)."""
    from scipy import linalg

    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def newton_schulz_sqrt_trace(a: torch.Tensor, num_iters: int = 50) -> torch.Tensor:
    """trace(sqrtm(A)) by Newton-Schulz iterations, on a's device and in
    its dtype."""
    dim = a.shape[-1]
    norm_a = torch.sqrt(torch.sum(a * a))
    y = a / norm_a
    eye = torch.eye(dim, dtype=a.dtype, device=a.device)
    z = eye.clone()
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return torch.trace(y * torch.sqrt(norm_a))


def compute_psnr(a: np.ndarray, b: np.ndarray, max_val: float = 1.0) -> float:
    """Mean per-image PSNR over a batch."""
    mse = ((a - b) ** 2).reshape(a.shape[0], -1).mean(axis=1)
    psnr = 20 * np.log10(max_val) - 10 * np.log10(mse)
    return float(psnr.mean())


def read_rgb(path: str | Path) -> np.ndarray:
    """A PNG as cv2.imread(path, IMREAD_COLOR)[..., ::-1] gives it: (H, W, 3)
    uint8 RGB (grey repeated, alpha dropped, 16 bits shifted to 8)."""
    img = read_png(path)
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[2] < 3:
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def _load_dir_images(path: str | Path, batch: int = 64):
    """Yield (B, H, W, 3) float [0, 1] batches over all pngs in a directory."""
    files = sorted(Path(path).glob("*.png"))
    for i in range(0, len(files), batch):
        yield np.stack([read_rgb(f).astype(np.float32) / 255.0 for f in files[i:i + batch]])


def _inception_features(imgs: np.ndarray, device="cuda", batch: int = 64):
    """(f768 (N, 17, 17, 768), f2048 (N, 2048)) numpy of N images in [0, 1],
    `batch` images a call of the net on `device`."""
    from .inception import get_inception

    model = get_inception(device=device)
    f768, f2048 = [], []
    with torch.no_grad():
        for i in range(0, len(imgs), batch):
            a, b = model(torch.as_tensor(imgs[i:i + batch], dtype=torch.float32, device=device))
            f768.append(a.cpu().numpy())
            f2048.append(b.cpu().numpy())
    return np.concatenate(f768), np.concatenate(f2048)


def compute_fid_from_dirs(real_dir, gen_dir, batch: int = 64, device="cuda") -> float:
    """Directory-level FID over the 2048-d features."""
    feats = []
    for d in (real_dir, gen_dir):
        feats.append(np.concatenate([_inception_features(b, device, batch)[1]
                                     for b in _load_dir_images(d, batch)]))
    mu1, s1 = feats[0].mean(0), _cov(feats[0])
    mu2, s2 = feats[1].mean(0), _cov(feats[1])
    return frechet_distance(mu1, s1, mu2, s2)


def compute_ofid_from_batch(img_gt: np.ndarray, img_pred: np.ndarray, exact: bool = True,
                            device="cuda", batch: int = 64) -> float:
    """Per-object FID over 768-d features of (B, H, W, 3) [0, 1] views of
    one object, B >= 10."""
    if img_gt.shape[0] < 10:
        raise RuntimeError(f"Need at least 10 views per object for a stable oFID "
                           f"(got {img_gt.shape[0]})")
    f_gt = _inception_features(img_gt, device, batch)[0]
    f_pr = _inception_features(img_pred, device, batch)[0]
    f_gt = f_gt.reshape(-1, f_gt.shape[-1])  # (17 * 17 * B, 768)
    f_pr = f_pr.reshape(-1, f_pr.shape[-1])
    mu1, s1 = f_gt.mean(0), _cov(f_gt)
    mu2, s2 = f_pr.mean(0), _cov(f_pr)
    if exact:
        return frechet_distance(mu1, s1, mu2, s2)
    diff = mu1 - mu2
    tr = float(newton_schulz_sqrt_trace(torch.as_tensor(s1 @ s2, dtype=torch.float32,
                                                        device=device)))
    return float(diff.dot(diff) + np.trace(s1) + np.trace(s2) - 2 * tr)


def compute_lpips_batch(a: np.ndarray, b: np.ndarray, device="cuda", batch: int = 64) -> float:
    """Mean LPIPS over pairs of [0, 1] image batches."""
    from .lpips import get_lpips

    model = get_lpips(device=device)
    dists = []
    with torch.no_grad():
        for i in range(0, len(a), batch):
            ta = torch.as_tensor(a[i:i + batch], dtype=torch.float32, device=device)
            tb = torch.as_tensor(b[i:i + batch], dtype=torch.float32, device=device)
            dists.append(model(ta * 2 - 1, tb * 2 - 1).cpu().numpy())
    return float(np.concatenate(dists).mean())


def compute_metrics_from_dirs(real_dir: str | Path, gen_dir: str | Path, car_lst: str | Path,
                              views_per_car: int = 24, exact_ofid: bool = True,
                              device="cuda", batch: int = 64):
    """(fid, ofid, lpips, psnr) over paired `{car}_{i:04}.png` directories."""
    with open(car_lst) as f:
        cars = [line.strip() for line in f if line.strip()]
    ofid_ls, lpips_ls, psnr_ls = [], [], []
    for car in cars:
        reals, gens = [], []
        for i in range(views_per_car):
            rp = Path(real_dir) / f"{car}_{i:04}.png"
            gp = Path(gen_dir) / f"{car}_{i:04}.png"
            if not (rp.exists() and gp.exists()):
                continue
            reals.append(read_rgb(rp) / 255.0)
            gens.append(read_rgb(gp) / 255.0)
        if not reals:
            continue
        img_real = np.stack(reals).astype(np.float32)
        img_gen = np.stack(gens).astype(np.float32)
        if img_real.shape[0] >= 10:
            ofid_ls.append(compute_ofid_from_batch(img_real, img_gen, exact_ofid, device, batch))
        lpips_ls.append(compute_lpips_batch(img_real, img_gen, device, batch))
        psnr_ls.append(compute_psnr(img_real, img_gen))

    fid = compute_fid_from_dirs(real_dir, gen_dir, batch, device)
    ofid = float(np.mean(ofid_ls)) if ofid_ls else float("nan")
    lpips_score = float(np.mean(lpips_ls)) if lpips_ls else float("nan")
    psnr = float(np.mean(psnr_ls)) if psnr_ls else float("nan")
    return fid, ofid, lpips_score, psnr
