"""Metric harness over generated outputs (panic3d_tpu/eval/measure.py):
CLIP / LPIPS / PSNR and chamfer / F1.

``main`` is the CLI: 2-D metrics on the alignment-ROI crops (front, back,
and 360 = the mean over spin12), and 3-D metrics between the predicted
marching-cubes mesh and the GT ``.vrm`` head (innards removed by winding
number, kernel K13; decapitated; both filtered to the ROI; 10,000 surface
samples a side; symmetric point -> mesh distances, kernel K9), with the
reference's crops, ROIs and coordinate conventions (the cv <-> world
conjugation, the x-flip of the predicted vertices). ``geometry_metrics``
is its 3-D part for one portrait.

Kept quirks: the reference assigns (does not append) each portrait's F1
(measure.py:200-201), so the reported F1 is the last portrait's, with the
mean beside it as f1@k_mean (F5); and the point samples are seeded with
``abs(hash(bn)) % 2**31`` (measure.py:183), which Python salts per process
(F10), so two runs agree only in one process or under one PYTHONHASHSEED.
"""

from __future__ import annotations

from typing import Optional

import argparse
import os
import pickle
import time
from collections import defaultdict

import numpy as np
import torch

from ..utils.table import Table
from .mesh_metrics import distances, sample_points_on_mesh
from .volume import _stage_clock

F1_THRESHOLDS = (0.005, 0.01, 0.05, 0.1, 0.5)


def filter_mesh(v, f, roi, bw, size=512):
    """measure.py:54-76."""
    (fcx, fcy), (fsx, fsy) = roi
    fcx, fcy, fsx, fsy = fcx / size, fcy / size, fsx / size, fsy / size
    cx, cy = (-bw / 2 + fcy * bw, bw / 2 - fcx * bw)
    sx, sy = bw * fsy, bw * fsx
    wv = (
        (cx < v[:, 0]) & (v[:, 0] < cx + sx)
        & (cy - sy < v[:, 1]) & (v[:, 1] < cy)
    )
    wf = wv[f].all(axis=1)
    faces = (np.cumsum(wv) - 1)[f[wf]]
    return {"verts": v[wv], "faces": faces}


def point_mesh_f1(p2s, s2p, thresh):
    pre = (p2s <= thresh).mean()
    rec = (s2p <= thresh).mean()
    f1 = 2 * pre * rec / (pre + rec) if not pre == rec == 0.0 else 0.0
    return dict(precision=pre, recall=rec, threshold=thresh, f1=f1)


CV2WORLD = np.asarray(
    [[-1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]], dtype=np.float64
)


def geometry_metrics(mesh_pred: dict, mesh_gt: dict, roi, bw: float = 0.7,
                     n_sample: int = 10000, seed: int = 0, device="cuda",
                     timings: Optional[dict] = None, stages: Optional[dict] = None) -> dict:
    """measure.py:181-215 for one portrait: ``mesh_pred`` is extract_mesh's
    output (verts in box_warp units), ``mesh_gt`` the reference head
    ({'verts', 'faces'} in the cv frame), ``roi`` its alignment box
    ((cx, cy), (sx, sy)) in 512-pixel space. -> p2s and s2p (the mean
    distances), cd, and f1_005 ... f1_500 (F1 at 0.005 ... 0.5). With
    ``timings`` (a dict), the seconds of each direction's distances are
    recorded under p2s and s2p; with ``stages``, the seconds of the ROI
    filters ('filter'), the sampling and each direction, the device waited
    for after each."""
    mark = _stage_clock(torch.device(device), stages)
    verts = mesh_pred["verts"] * np.asarray([-1, 1, 1])[None]
    pred = filter_mesh(verts, mesh_pred["faces"], roi, bw)
    gt = filter_mesh(mesh_gt["verts"], mesh_gt["faces"], roi, bw)
    mark("filter")
    points_pred = sample_points_on_mesh(pred["verts"], pred["faces"], n_sample, seed=seed)
    inv = np.linalg.inv(CV2WORLD)[:3, :3]
    points_gt = (inv @ sample_points_on_mesh(gt["verts"], gt["faces"], n_sample,
                                             seed=seed).T).T.astype(np.float32)
    gt_verts_w = (inv @ gt["verts"].T).T.astype(np.float32)
    mark("sampling")
    t0 = time.perf_counter()
    p2s = distances(points_pred, gt_verts_w, gt["faces"], device)
    t1 = time.perf_counter()
    mark("p2s")
    s2p = distances(points_gt, pred["verts"], pred["faces"], device)
    if timings is not None:
        timings.update(p2s=t1 - t0, s2p=time.perf_counter() - t1)
    mark("s2p")
    out = {"p2s": float(p2s.mean()), "s2p": float(s2p.mean()),
           "cd": float((p2s.mean() + s2p.mean()) / 2)}
    for th in F1_THRESHOLDS:
        out[f"f1_{int(th * 1000):03d}"] = float(point_mesh_f1(p2s, s2p, th)["f1"])
    return out


def main(argv=None, stages: Optional[dict] = None):
    """The measure CLI (measure.py:54-229) -> (ans2d, ans3d). ``--device``
    (default cuda) is where the nets, K13 and K9 run. With ``stages`` (a
    dict), the seconds of each stage summed over the portraits: 2d, vrm_load,
    remove_innards, decapitate and geometry_metrics' filter, sampling, p2s
    and s2p, the device waited for after each."""
    from ..cameras.conventions import camsubs
    from ..configs import resolve_device
    from ..data.databack import DatabackendMinna
    from ..ops.resize import resize
    from ..utils.device import to_device
    from ..utils.imglib import Img
    from .gltf import LustrousGLTF, LustrousGLTFDecapitated
    from .lpips import LPIPS, load_lpips_params
    from .metrics2d import CLIPSimilarity, load_clip_params, psnr

    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=".")
    ap.add_argument("--name", default="ecrutileE_eclustrousC_n120-00000-000200")
    ap.add_argument("--out", default=None)
    ap.add_argument("--subset", default="daredemoE_test")
    ap.add_argument("--clip-weights", default=None)
    ap.add_argument("--lpips-weights", default=None)
    ap.add_argument("--roi-space", type=int, default=512,
                    help="pixel space the alignment ROIs are defined in")
    ap.add_argument("--allow-random-metrics", action="store_true",
                    help="permit random-init CLIP/LPIPS (smoke tests only; "
                         "2D metric VALUES are then meaningless)")
    ap.add_argument("--device", default=None,
                    help="torch device of the nets and kernels (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    edn = args.out or f"./temp/eval/{args.name}"
    dk = DatabackendMinna(args.data)
    with open(
        os.path.join(args.data, "_data", "lustrous", "subsets", f"{args.subset}.csv")
    ) as f:
        bns = [f"daredemoE/fandom_align/{l.strip()}/front" for l in f if l.strip()]
    with open(
        os.path.join(args.data, "_data", "lustrous", "renders", "daredemoE",
                     "fandom_align_alignment.pkl"), "rb",
    ) as f:
        aligndata = pickle.load(f)

    if not (args.clip_weights and args.lpips_weights) and not args.allow_random_metrics:
        raise SystemExit(
            "refusing to report 2D metrics from random-init CLIP/LPIPS nets "
            "(values would not be paper-comparable): pass --clip-weights and "
            "--lpips-weights (runtime/convert.py) or --allow-random-metrics"
        )
    clip_sim = CLIPSimilarity(
        load_clip_params(args.clip_weights) if args.clip_weights else None, device=dev
    )
    lpips_mod = LPIPS(device=dev).eval()
    if args.lpips_weights:
        lpips_mod.load_variables(load_lpips_params(args.lpips_weights))
    else:
        lpips_mod.init_weights(0)
        print("WARNING: random-init LPIPS/CLIP — values not paper-comparable")

    rs = args.roi_space
    per = {} if stages is not None else None   # one portrait's stages
    mark = _stage_clock(dev, per)

    def crop_t(img: Img, roi):
        # ROIs live in --roi-space pixels (512 for the real benchmark);
        # crop fractionally so differently-sized images stay comparable
        (fcx, fcy), (fsx, fsy) = roi
        arr = img.convert("RGBA").bg("w").convert("RGB").t()
        h, w = arr.shape[-2:]
        r0, r1 = int(fcx * h / rs), int((fcx + fsx) * h / rs)
        c0, c1 = int(fcy * w / rs), int((fcy + fsy) * w / rs)
        return arr[:, r0:max(r1, r0 + 1), c0:max(c1, c0 + 1)]

    def run2d(pred: Img, gt: Img, roi):
        """-> {clip, lpips, psnr} as 0-d tensors on the device."""
        a = to_device(crop_t(pred, roi), dev)[None]
        b = to_device(crop_t(gt, roi), dev)[None]
        if a.shape != b.shape:  # mixed-resolution smoke runs
            a = resize(a, b.shape, method="bilinear")
        if min(b.shape[-2:]) < 64:  # below AlexNet's receptive field
            shape = tuple(b.shape[:2]) + (max(64, b.shape[-2]), max(64, b.shape[-1]))
            a = resize(a, shape, method="bilinear")
            b = resize(b, shape, method="bilinear")
        with torch.no_grad():
            return {
                "clip": clip_sim(a, b)[0],
                "lpips": torch.mean(lpips_mod(a * 2 - 1, b * 2 - 1)),
                "psnr": psnr(a, b),
            }

    def to_floats(rows):
        """[{metric: 0-d tensor}] -> [{metric: float}], one copy to the host."""
        keys = list(rows[0])
        vals = torch.stack([r[k] for r in rows for k in keys]).cpu().tolist()
        return [dict(zip(keys, vals[i * len(keys):(i + 1) * len(keys)]))
                for i in range(len(rows))]

    bw = 0.7
    n_sample = 10000
    ans2d = defaultdict(lambda: defaultdict(list))
    ans3d = defaultdict(list)
    ans3d_last = {}

    for bn in bns:
        roi = aligndata[bn]["area_of_interest"]
        roi_horiz = ((roi[0][0], 0), (roi[1][0], rs))
        roi_back = ((roi[0][0], rs - (roi[0][1] + roi[1][1])), (roi[1][0], roi[1][1]))
        mark("start")

        # ---- 2d ----
        front = run2d(Img(f"{edn}/{bn.replace('fandom_align','ortho')}.png"),
                      dk[bn.replace("fandom_align", "ortho")]["image"], roi)
        back = run2d(
            Img(f"{edn}/{bn.replace('fandom_align','ortho').replace('/front','/back')}.png"),
            dk[bn.replace("fandom_align", "ortho").replace("/front", "/back")]["image"],
            roi_back)
        spins = []
        for view in camsubs["spin12"]:
            view = f"/{view:04d}"
            gt = dk[bn.replace("fandom_align", "rgb60").replace("/front", view)]["image"]
            pred = Img(
                f"{edn}/{bn.replace('fandom_align','rgb60').replace('/front',view)}.png"
            )
            spins.append(run2d(pred, gt, roi_horiz))
        front, back, *spins = to_floats([front, back] + spins)
        for k, v in front.items():
            ans2d["front"][k].append(v)
        for k, v in back.items():
            ans2d["back"][k].append(v)
        viewavg = defaultdict(list)
        for row in spins:
            for k, v in row.items():
                viewavg[k].append(v)
        for k in viewavg:
            ans2d["360"][k].append(float(np.mean(viewavg[k])))
        mark("2d")

        # ---- 3d ----
        with open(f"{edn}/{bn.replace('fandom_align','marching_cubes')}.pkl", "rb") as f:
            mc = pickle.load(f)
        seed = abs(hash(bn)) % (2**31)

        _, _, franch, idx, _ = bn.split("/")
        gltf = LustrousGLTF(
            os.path.join(args.data, "_data", "lustrous", "raw", "dssc", franch,
                         f"{idx}.vrm")
        )
        mark("vrm_load")
        gltf.remove_innards(device=dev)
        mark("remove_innards")
        head = LustrousGLTFDecapitated(gltf)
        mark("decapitate")
        m = geometry_metrics(mc, {"verts": head.verts, "faces": head.faces}, roi, bw,
                             n_sample, seed=seed, device=dev, stages=per)
        if stages is not None:
            per.pop("start")
            for k, t in per.items():
                stages[k] = stages.get(k, 0.0) + t
        ans3d["p2s"].append(m["p2s"])
        ans3d["s2p"].append(m["s2p"])
        ans3d["cd"].append(m["cd"])
        for th in F1_THRESHOLDS:
            key = f"f1_{int(th * 1000):03d}"
            ans3d_last[key] = m[key]  # reference quirk: last
            ans3d[f"{key}_mean"].append(m[key])
        print(bn, "measured")

    rows = [["subset", "metric", "value"]]
    for s in reversed(sorted(ans2d)):
        rows.append([s, "clip", f"{100*np.mean(ans2d[s]['clip']):.3f}"])
        rows.append([s, "lpips", f"{100*np.mean(ans2d[s]['lpips']):.3f}"])
        rows.append([s, "psnr", f"{np.mean(ans2d[s]['psnr']):.3f}"])
    rows.append(["geom", "cd", f"{100*np.mean(ans3d['cd']):.3f}"])
    rows.append(["geom", "f1@5", f"{100*ans3d_last['f1_005']:.3f}"])
    rows.append(["geom", "f1@10", f"{100*ans3d_last['f1_010']:.3f}"])
    rows.append(["geom", "f1@5_mean", f"{100*np.mean(ans3d['f1_005_mean']):.3f}"])
    rows.append(["geom", "f1@10_mean", f"{100*np.mean(ans3d['f1_010_mean']):.3f}"])
    print(Table(rows))
    return ans2d, ans3d


if __name__ == "__main__":
    main()
