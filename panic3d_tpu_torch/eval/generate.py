"""The per-portrait turntable of eval generate (panic3d_tpu/eval/generate.py:23-190):
one planes bundle per portrait -- mapping, backbone planes, the ESS
occupancy and the paste-front occlusion volume -- then every view batch
rendered from it. PyTorch runs eagerly, so the JAX package's jitted closures
become plain functions; the PNG writing, dataset loop and CLI are not
ported yet.
"""

from __future__ import annotations

import torch

from ..cameras import camera_label
from ..models.triplane import seeds_to_z
from ..utils.device import constant, to_device

INFERENCE_OPTS = dict(
    triplane_crop=0.1,
    cull_clouds=0.5,
    paste_params=dict(
        mode="default",
        thresh_weight=0.95,
        thresh_edges=0.02,
        thresh_occ=0.05,
        offset_occ=0.01,
        thresh_dxyz=0.000005,
    ),
)

EVAL_VIEWS = [
    ("camO", "front", 0, 0, -1),
    ("camO", "left", 0, 90, -1),
    ("camO", "right", 0, -90, -1),
    ("camO", "back", 0, 180, -1),
]


def plane_cache_ok(G) -> bool:
    """Planes are view-independent iff the mapping ignores the camera
    (c_gen_conditioning_zero, the flagship eval default): then one backbone
    pass serves every view of a portrait, output-identically."""
    return bool(G.rk.get("c_gen_conditioning_zero", False))


def planes_bundle(G, seed: int, cond: dict, opts: dict | None = None,
                  noise_mode: str = "const") -> dict:
    """The once-per-portrait bundle (generate.py:139 _get_planes_jit):
    seed -> z, the single-z mapping, the backbone planes, and -- each
    computed once instead of once per view batch, output-identically -- the
    ESS occupancy ('occ', 'occ_out') when ESS is on and the paste-front
    occlusion volume ('occ_A', 'occ_d0') when paste_params use the grid
    occlusion. ``cond`` holds one portrait's conditioning (batch 1)."""
    opts = opts or {}
    pp = opts.get("paste_params") or {}
    z = to_device(seeds_to_z([seed], G.z_dim), G.device)
    # the camera label is irrelevant under c_gen_conditioning_zero (zeroed
    # inside mapping): pass the canonical front label, as G.f would
    c0 = camera_label(*(constant([v], G.device) for v in (0.0, 0.0, 1.0, 30.0)))
    filters = dict(triplane_crop=opts.get("triplane_crop"),
                   cull_clouds=opts.get("cull_clouds"),
                   binarize_clouds=opts.get("binarize_clouds"))
    with torch.no_grad():
        ws = G.mapping(z, c0)
        planes = G._planes_from_ws(ws, cond, noise_mode=noise_mode)
        out = {"ws": ws, "planes": planes}
        if G.rk.get("ess"):
            out["occ"], out["occ_out"] = G.ess_occupancy_for_planes(planes, **filters)
        if (pp and pp.get("occ_impl", "grid") == "grid"
                and isinstance(G.rk.get("ray_start"), (int, float))):
            vol = G.front_occlusion_volume(planes, **filters)
            out["occ_A"], out["occ_d0"] = vol["A"], vol["density0"]
    return out


def render_from_planes(G, opts: dict, bundle: dict, elevations, azimuths, fovs, cond: dict,
                       noise_mode: str = "const") -> dict:
    """One view batch from a portrait's planes bundle (generate.py:46
    _get_render_jit(from_planes=True)): the bundle's tensors are broadcast
    over the vb views, and G.f renders them with ``opts`` (density filters,
    paste_params). -> {'image', 'image_xyz', 'image_weights'}."""
    vb = len(elevations)

    def bcast(t):
        return t.expand((vb,) + tuple(t.shape[1:]))

    # the view angles repeat from portrait to portrait: cached on the device
    xin = {"elevations": constant(elevations, G.device),
           "azimuths": constant(azimuths, G.device),
           "fovs": constant(fovs, G.device),
           "cond": {k: bcast(v) for k, v in cond.items()},
           "ws": bcast(bundle["ws"]), "_planes": bcast(bundle["planes"]), **opts}
    if "occ" in bundle:
        xin["_ess_occ"] = (bcast(bundle["occ"]), bundle["occ_out"])
    if "occ_A" in bundle:
        A = bundle["occ_A"]
        xin["_occ_vol"] = {"A": bcast(A), "density0": bundle["occ_d0"],
                           "box_warp": G.rk["box_warp"], "grid": tuple(A.shape[1:])}
    with torch.no_grad():
        out = G.f(xin, noise_mode=noise_mode)
    return {k: out[k] for k in ("image", "image_xyz", "image_weights")}
