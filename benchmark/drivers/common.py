"""What both drivers take from the program: its metadata at a step, held
against the configuration file, its models built with the seed's weights,
and the `record_function` wrappers around its kernel entry points that a
traced run installs."""

from __future__ import annotations

import contextlib
import gc

import torch

from ..harness import CellError

# cell-size keys the CPU tests may shrink, and the metadata keys they set
_OVERRIDE_KEYS = ("batch_size", "img_size", "num_steps", "ray_chunks", "voxel_resolution")


def metadata(cell, step: int) -> dict:
    """The program's resolved curriculum metadata at `step` for the
    configuration's preset chain, held against the configuration file."""
    from conditioned_nerf_gan_torch.config import extract_metadata, load_curriculum

    preset = cell.config["preset"]
    meta = extract_metadata(load_curriculum(config_base=preset["config_base"],
                                            config=preset["config"]), step)
    check_config(meta, cell.config)
    meta.update({k: v for k, v in cell.overrides.items() if k in _OVERRIDE_KEYS})
    return meta


def check_config(meta: dict, config: dict) -> None:
    """Refuse to run where the program's preset is not the configuration
    the file states (a width, the encoder, the precision policy)."""
    m, p = config["model"], config["precision"]
    g = meta["generator"]
    stated = {
        "siren_type": (g["siren_type"], m["siren_type"]),
        "z_dim": (g["z_dim"], m["z_dim"]),
        "siren_input_dim": (g.get("input_dim", 3), m["siren_input_dim"]),
        "siren_hidden": (g.get("hidden_dim", 256), m["siren_hidden"]),
        "siren_out": (g.get("output_dim", 4), m["siren_out"]),
        "encoder": ("voxel" if meta["dataset"]["load_voxel"] else "pcl", m["encoder_input"]),
        "discriminator": (meta["discriminator"] if meta["enable_discriminator"] else None,
                          m["discriminator"]),
        "compute_dtype": (meta.get("compute_dtype"), p["compute_dtype"]),
        "use_fast_sin": (meta.get("use_fast_sin"), p["use_fast_sin"]),
        "use_pallas": (meta.get("use_pallas"), p["use_kernels"]),
    }
    if m["encoder_input"] == "voxel":
        stated["unet"] = ({k: meta["unet"][k] for k in m["unet"]}, m["unet"])
    if m["discriminator"]:
        stated["r1_lambda"] = (meta["r1_lambda"], m["r1_lambda"])
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise CellError(f"the program's preset is not the configuration file's: "
                        f"{ {k: {'program': a, 'file': b} for k, (a, b) in wrong.items()} }")


def render_settings(meta: dict, perturb: bool) -> dict:
    """The render's settings as the reference takes them."""
    return {k: meta[k] for k in ("img_size", "num_steps", "fov", "ray_start", "ray_end",
                                 "white_back", "clamp_mode", "ray_chunks")} | {
        "perturb": perturb}


def shapes(cell, meta: dict, views: int) -> dict:
    """The shapes a step or request runs, logged at set-up, with the forward
    FLOPs of the configuration's encoder and discriminator at them (its
    reference module counts its own nets), counted on by `counts`."""
    from .. import harness

    ref = harness.reference(cell)
    m = cell.config["model"]
    enc = ref.encoder_shapes(cell.config, meta, cell.overrides)
    return {"batch": views, "views": views, "img": meta["img_size"],
            "samples": meta["num_steps"], "hierarchical": bool(meta["hierarchical_sample"]),
            "chunks": meta["ray_chunks"], "encoder": enc,
            "siren": {"din": m["siren_input_dim"], "layers": m["siren_layers"],
                      "hidden": m["siren_hidden"], "out": m["siren_out"],
                      "mapping": ref.mapping_dims(cell.config)},
            "encoder_flops": ref.encoder_flops(enc, views),
            "discriminator_flops": ref.discriminator_flops(views, meta["img_size"])}


def program_models(meta: dict, weights: dict, device, with_discriminator: bool):
    """The program's generator, encoder (and discriminator) under the
    metadata's policy, built on `device` and loaded with the seed's weights."""
    from conditioned_nerf_gan_torch.infer.inference import build_models, compute_dtype
    from conditioned_nerf_gan_torch.models.discriminators import make_discriminator

    with torch.device(device):
        G, E = build_models(meta)
        D = (make_discriminator(meta["discriminator"], compute_dtype=compute_dtype(meta))
             if with_discriminator else None)
    G.load_state_dict(weights["generator"])
    E.load_state_dict(weights["encoder"])
    if D is not None:
        D.load_state_dict(weights["discriminator"])
    return G, E, D


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class precise:
    """fp32 products without TF32, for the reference's span only."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# ---------------------------------------------------------------------------
# the traced run's wrappers
# ---------------------------------------------------------------------------

RANGES = ("film_siren_mlp", "film_siren_mlp_bwd", "trilinear_fwd", "trilinear_bwd")


@contextlib.contextmanager
def kernel_ranges(calls: dict):
    """Wrap the program's kernel entry points, where their callers look them
    up, in `record_function` ranges named after them, and record each
    call's (FLOPs, bytes) from its shapes into `calls[name]` (the trilinear
    ones: the coordinates, counted once the trace is read)."""
    from conditioned_nerf_gan_torch.models import siren
    from conditioned_nerf_gan_torch.ops import grid_sample
    from conditioned_nerf_gan_torch.ops.kernels import film_siren

    from .. import counts

    def film_shape(points, freq, ws, wf):
        B, N, din = points.shape
        return B, N, din, ws.shape[0] + 1, wf.shape[0], wf.shape[1]

    def wrap_film_fwd(fn):
        def wrapped(points, freq, phase, w0, b0, ws, bs, wf, bf):
            calls.setdefault("film_siren_mlp", []).append(
                counts.film_fwd(*film_shape(points, freq, ws, wf)))
            with torch.profiler.record_function("film_siren_mlp"):
                return fn(points, freq, phase, w0, b0, ws, bs, wf, bf)
        return wrapped

    def wrap_film_bwd(fn):
        def wrapped(points, freq, phase, w0, b0, ws, bs, wf, bf, g):
            calls.setdefault("film_siren_mlp_bwd", []).append(
                counts.film_bwd(*film_shape(points, freq, ws, wf)))
            with torch.profiler.record_function("film_siren_mlp_bwd"):
                return fn(points, freq, phase, w0, b0, ws, bs, wf, bf, g)
        return wrapped

    def wrap_tri_fwd(fn):
        def wrapped(volume, coords):
            calls.setdefault("trilinear_fwd", []).append(
                (tuple(volume.shape), coords.detach().clone(), False))
            with torch.profiler.record_function("trilinear_fwd"):
                return fn(volume, coords)
        return wrapped

    def wrap_tri_bwd(fn):
        def wrapped(volume, coords, g, dvol=None, need_coords=False):
            calls.setdefault("trilinear_bwd", []).append(
                (tuple(volume.shape), coords.detach().clone(), need_coords))
            with torch.profiler.record_function("trilinear_bwd"):
                return fn(volume, coords, g, dvol, need_coords)
        return wrapped

    sites = [(siren, "film_siren_mlp", wrap_film_fwd),
             (film_siren, "film_siren_mlp_bwd", wrap_film_bwd),
             (grid_sample, "trilinear_fwd", wrap_tri_fwd),
             (grid_sample, "trilinear_bwd", wrap_tri_bwd)]
    saved = [(module, name, getattr(module, name)) for module, name, _ in sites]
    try:
        for module, name, wrap in sites:
            fn = getattr(module, name)
            wrapped = wrap(fn)
            if hasattr(fn, "launches"):  # the entry point counts itself by its global name
                wrapped.launches = fn.launches
            setattr(module, name, wrapped)
        yield
    finally:
        for module, name, fn in saved:
            wrapped = getattr(module, name)
            if hasattr(wrapped, "launches"):
                fn.launches = wrapped.launches
            setattr(module, name, fn)


def range_calls(calls: dict) -> dict:
    """{range name: [(FLOPs, bytes) a call]}, the trilinear ones counted now
    from their recorded coordinates."""
    from .. import counts

    out = {}
    for name, recorded in calls.items():
        if name.startswith("trilinear"):
            rows = []
            for shape, coords, need_coords in recorded:
                B, N, C = shape[0], coords.shape[1], shape[4]
                touched = counts.touched_rows(shape, coords)
                fn = counts.trilinear_fwd if name == "trilinear_fwd" else counts.trilinear_bwd
                rows.append(fn(B, N, C, touched) if name == "trilinear_fwd"
                            else fn(B, N, C, touched, need_coords))
            out[name] = rows
        else:
            out[name] = list(recorded)
    return out
