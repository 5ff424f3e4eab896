"""End-to-end inference over the daredemoE benchmark
(panic3d_tpu/eval/generate.py).

For each portrait of a subset: the line filler on the white-background
portrait (with a checkpoint's ``rmline/``), the ResNet-PCA features, then the
marching-cubes mesh pickle and the 4 ortho + 12 spin views, saved as RGB and
xyza PNGs in the reference's file layout (<out>/daredemoE/{marching_cubes,
ortho, ortho_xyza, rgb60, xyza60}/franchise/id/view). The turntable renders
from one planes bundle per portrait -- mapping, backbone planes, the ESS
occupancy and the paste-front occlusion volume -- when the mapping ignores
the camera, then every view batch from it. PyTorch runs eagerly, so the JAX
package's jitted closures become plain functions.

    python -m panic3d_tpu_torch.eval.generate --ckpt <dir>/G --data <root> --out <dir>
    python -m panic3d_tpu_torch.eval.generate --tiny --data <root> --out <dir>

``--ckpt`` is a directory of the JAX package's native format
(runtime/checkpoint.py); the line filler and the ResNet-PCA extractor load
from its siblings ``rmline/`` and ``resnet/`` (``state.msgpack``, and
``pca.npz`` for the ResNet). Without them the CLI warns, skips the filler
and takes seeded random features, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Optional

import numpy as np
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
    occlusion. A deep-plane generator (triplane_depth > 1) has neither:
    it renders without ESS and pastes with occ_impl='render' (the others
    raise, ROADMAP F12), so its bundle is ws and planes alone. ``cond``
    holds one portrait's conditioning (batch 1)."""
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
        ws = G.mapping(z, c0, cond)
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


def render_views(G, opts: dict, seed: int, elevations, azimuths, fovs, cond: dict,
                 noise_mode: str = "const") -> dict:
    """One view batch by the full forward (generate.py:46 _get_render_jit
    without the plane cache, for a mapping that reads the camera): z from
    ``seed`` for every view. -> {'image', 'image_xyz', 'image_weights'}."""
    vb = len(elevations)
    xin = {"elevations": constant(elevations, G.device),
           "azimuths": constant(azimuths, G.device),
           "fovs": constant(fovs, G.device),
           "cond": {k: v.expand((vb,) + tuple(v.shape[1:])) for k, v in cond.items()},
           "seeds": [seed] * vb, **opts}
    with torch.no_grad():
        out = G.f(xin, noise_mode=noise_mode)
    return {k: out[k] for k in ("image", "image_xyz", "image_weights")}


def eval_views() -> list:
    """The 16 eval views: 4 ortho (EVAL_VIEWS), then spin12 at fov 30, as
    (camera, name, elevation, azimuth, fov)."""
    from ..cameras.conventions import cam60, camsubs

    return EVAL_VIEWS + [("camP", f"{v:04d}", float(cam60[v][0]), float(cam60[v][1]), 30)
                         for v in camsubs["spin12"]]


def _output_path(out_dir: str, bn: str, sub: str, view: Optional[str] = None,
                 ext: str = ".png") -> str:
    name = bn.replace("fandom_align", sub)
    if view is not None:
        name = name.replace("/front", f"/{view}")
    return os.path.join(out_dir, name + ext)


def generate_portrait(G, resnet, x, aligndata, opts: dict, seed: int, view_batch: int,
                      out_dir: str, level: float = 0.5, mesh_res: int = 256, rmline=None,
                      stages: Optional[dict] = None) -> dict:
    """One portrait of generate.py:282-366: ``x`` is the data item
    (DatabackendMinna[bn]: 'bn' and the RGBA 'image'), ``resnet`` the
    ResNet-PCA extractor, ``rmline`` the line filler (an RMLineWrapper) or
    None, ``aligndata`` the portrait's alignment record (the filler's
    keypoints). Writes the marching-cubes pickle (extract_mesh's dict at
    ``mesh_res``^3 and ``level``) and the 16 views' RGB and xyza PNGs under
    ``out_dir``; with ``stages`` (a dict) records the seconds of the line
    filler, the features, mesh, views and writing. -> the G.f ``cond`` of
    the portrait."""
    from ..utils.imglib import Img, from_model_output
    from .volume import _stage_clock, extract_mesh

    mark = _stage_clock(G.device, stages)
    bn, img = x["bn"], x["image"]
    rgb = to_device(img.bg("w").convert("RGB").t(), G.device)[None]
    if rmline is not None:
        rgb, _, _ = rmline(rgb, _aligned_keypoints(aligndata))
        mark("rmline")
    chonk = resnet(img.bg("k").convert("RGB").t())
    ch = 16 if "reschonk_add_16" in G.backbone.synthesis.cond_mode else 512
    cond = {"image_ortho_front": rgb, "resnet_chonk": chonk[None, 0, :ch].to(torch.float32)}
    mark("features")

    # geometry (numerics per eg3d_metrics3d.py)
    mc = extract_mesh(G, {"cond": cond, "seeds": [seed], **opts}, level=level,
                      resolution=mesh_res)
    fn_march = _output_path(out_dir, bn, "marching_cubes", ext=".pkl")
    os.makedirs(os.path.dirname(fn_march), exist_ok=True)
    with open(fn_march, "wb") as f:
        pickle.dump(dict(mc), f)
    mark("mesh")

    # images: view batches from one planes bundle when the mapping ignores
    # the camera; the host copies and PNG writing come after all batches
    views = eval_views()
    vb = min(view_batch, len(views))
    bw = G.rk["box_warp"]
    bundle = planes_bundle(G, seed, cond, opts) if plane_cache_ok(G) else None
    outs = []
    for i in range(0, len(views), vb):
        chunk = views[i:i + vb]
        cc = chunk + [chunk[-1]] * (vb - len(chunk))
        angles = ([float(c[2]) for c in cc], [float(c[3]) for c in cc],
                  [float(c[4]) for c in cc])
        out = (render_from_planes(G, opts, bundle, *angles, cond) if bundle is not None
               else render_views(G, opts, seed, *angles, cond))
        xyza = torch.cat([(out["image_xyz"] + bw / 2) / bw, out["image_weights"]], dim=1)
        outs.append((chunk, out["image"][:len(chunk)], xyza[:len(chunk)]))
    images = torch.cat([o[1] for o in outs]).float().cpu().numpy()
    xyzas = torch.cat([o[2] for o in outs]).float().cpu().numpy()
    mark("views")
    for j, (cm, cam_view, *_rest) in enumerate(views):
        sub, sub_x = ("ortho", "ortho_xyza") if cm == "camO" else ("rgb60", "xyza60")
        from_model_output(images[j:j + 1], normalize=False).save(
            _output_path(out_dir, bn, sub, cam_view))
        Img(np.clip(xyzas[j], 0, 1)).save(_output_path(out_dir, bn, sub_x, cam_view))
    mark("write")
    return cond


def _aligned_keypoints(aligndata) -> np.ndarray:
    """The detector's keypoints of an alignment record, mapped by its
    transformation into the aligned portrait (generate.py:369-376)."""
    M = aligndata["transformation"]
    src = aligndata["_alignment"]["source"]
    kpts = src["keypoints"][src["_detection_used"]]
    pts = np.concatenate([kpts[:, :2], np.ones((len(kpts), 1))], axis=-1)
    return (M @ pts.T).T[:, :2]


def _load_rmline(args, device):
    """The line filler from ``<dirname(--ckpt)>/rmline`` (generate.py:378-390),
    or None with a warning."""
    from ..models.rmlinegan import RMLineGenerator, RMLineWrapper
    from ..runtime.checkpoint import load_checkpoint

    if not args.ckpt:
        print("WARNING: no rmline checkpoint; skipping line filling")
        return None
    path = os.path.join(os.path.dirname(args.ckpt), "rmline")
    if not os.path.isdir(path):
        print("WARNING: no rmline checkpoint found; skipping line filling")
        return None
    variables, _ = load_checkpoint(path)
    return RMLineWrapper(RMLineGenerator(device=device).load_variables(variables))


def _load_resnet(args, device):
    """The ResNet-PCA extractor from ``<dirname(--ckpt)>/resnet``
    (generate.py:393-416), else seeded random features with a warning."""
    from ..models.resnet import load_pca_extractor, random_feature_extractor

    path = os.path.join(os.path.dirname(args.ckpt), "resnet") if args.ckpt else ""
    if path and os.path.isdir(path):
        return load_pca_extractor(path, device=device)
    print("WARNING: no resnet checkpoint; using random features")
    return random_feature_extractor(0, device=device)


def main(argv=None, stages: Optional[dict] = None):
    """The generate CLI (generate.py:201-300): argparse, the generator of a
    ``--ckpt`` directory (G_ema of a trainer snapshot; ESS on unless
    ``--no-ess``) or the tiny model with seeded weights (``--tiny``), the
    line filler and the extractor from the checkpoint's siblings, the subset
    loop. With ``stages`` (a dict) adds up the seconds of loading ('load')
    and of each portrait's stages."""
    from .. import configs
    from ..data.databack import DatabackendMinna
    from ..runtime.checkpoint import (extract_generator_variables, load_checkpoint,
                                      state_dict_from_flax)
    from .volume import _stage_clock

    def add(part):
        for k, v in (part or {}).items():
            stages[k] = stages.get(k, 0.0) + v

    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None, help="converted G_ema checkpoint dir")
    ap.add_argument("--data", default=".", help="dir containing _data/lustrous")
    ap.add_argument("--out", default=None)
    ap.add_argument("--name", default="ecrutileE_eclustrousC_n120-00000-000200")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--subset", default="daredemoE_test")
    ap.add_argument("--skip-rmline", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny model + random init (pipeline smoke test)")
    ap.add_argument("--mesh-res", type=int, default=256)
    ap.add_argument("--level", type=float, default=0.5,
                    help="marching-cubes iso level (reference: 0.5)")
    ap.add_argument("--no-filters", action="store_true",
                    help="disable triplane_crop/cull_clouds (random-init smoke)")
    ap.add_argument("--view-batch", type=int, default=2,
                    help="views rendered per call (2, as bench.py)")
    ap.add_argument("--no-ess", action="store_true",
                    help="disable empty-space skipping and render the "
                         "reference's uniform 96+96 quadrature")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and kernels (default: cuda)")
    args = ap.parse_args(argv)

    opts = dict(INFERENCE_OPTS)
    if args.no_filters:
        opts.pop("triplane_crop"); opts.pop("cull_clouds")

    edn = args.out or f"./temp/eval/{args.name}"
    loading = {} if stages is not None else None
    mark = _stage_clock(configs.resolve_device(args.device), loading)
    if args.tiny:
        G = configs.tiny(force_sigmoid=True, device=args.device).init_weights(0).eval()
    elif args.ckpt:
        state, config = load_checkpoint(args.ckpt)
        G = configs.from_snapshot_config(config, eval_mode=True, ess=not args.no_ess,
                                         device=args.device)
        G.load_state_dict(state_dict_from_flax(extract_generator_variables(state)), strict=True)
        G.eval()
    else:
        raise SystemExit("--ckpt required unless --tiny")

    dk = DatabackendMinna(args.data)
    subset_csv = os.path.join(args.data, "_data", "lustrous", "subsets", f"{args.subset}.csv")
    with open(subset_csv) as f:
        bns = [f"daredemoE/fandom_align/{l.strip()}/front" for l in f if l.strip()]
    align_pkl = os.path.join(args.data, "_data", "lustrous", "renders", "daredemoE",
                             "fandom_align_alignment.pkl")
    with open(align_pkl, "rb") as f:
        aligndata = pickle.load(f)

    rmline = None if args.skip_rmline else _load_rmline(args, G.device)
    resnet = _load_resnet(args, G.device)
    mark("load")
    add(loading)
    for bn in bns:
        one = {} if stages is not None else None
        generate_portrait(G, resnet, dk[bn], aligndata[bn], opts, args.seed, args.view_batch,
                          edn, level=args.level, mesh_res=args.mesh_res, rmline=rmline,
                          stages=one)
        add(one)
        print(bn, "done")


if __name__ == "__main__":
    main()
