"""Training dataset: multi-view condition dicts for the GAN loop, a copy of
panic3d_tpu/data/dataset.py (numpy only; the camera label is the port's,
converted to numpy).

Role of `_train/eg3dc/datasets/ecrutileE.py` (Dataset + DatasetWrapper):
per-sample dict with the 512² white-bg RGB render + xyz map (scaled by
boxwarp), alpha, 25-dim camera label, precomputed resnet PCA features,
4 ortho views (+xyza+cameras), 2 dortho views, fandom_align substitution,
and manual mirror augmentation (x-flip + left/right swap + label mirror,
ecrutileE.py:83-120).

Also provides `synthetic_batch()` — a structurally-identical random batch
used by tests and the multi-chip dry-run (the real `_data/` tree is not
distributed with the reference either, `_data/.gitignore:2`).

Batches are plain numpy dicts; `InfiniteBatcher` shards the shuffle across
data-parallel processes (the InfiniteSampler role,
`src/torch_utils/misc.py:113-147`); the port's trainer runs one.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict as TDict, Iterator, Optional

import numpy as np

from ..cameras.conventions import camera_label as _camera_label_t
from ..utils.config import Dict
from ..utils.imglib import Img
from .databack import DatabackendMinna

ORTHO_VIEWS = ("front", "left", "right", "back")


def camera_label(elev, azim, dist, fov) -> np.ndarray:
    """The port's camera label (cameras/conventions.py) on the CPU, as numpy."""
    return _camera_label_t(*(np.asarray(v, dtype=np.float32) for v in (elev, azim, dist, fov))
                           ).cpu().numpy()


def _label(render_params) -> np.ndarray:
    return np.asarray(
        camera_label(
            render_params["elev"],
            render_params["azim"],
            render_params["dist"],
            render_params["fov"],
        ),
        dtype=np.float32,
    )


def mirror_camera_label(label: np.ndarray) -> np.ndarray:
    """x-flip of the 25-dim label: negate elements [1,2,3,4,8]
    (ecrutileE.py:202-208)."""
    out = label.copy()
    out[[1, 2, 3, 4, 8]] *= -1
    return out


class EcrutileEDataset:
    """Maps subset CSV basenames -> training samples (ecrutileE.py:240-421)."""

    def __init__(self, base_dir=".", subset="rutileEA", split="train", size=512,
                 n_generations=8, boxwarp=0.7, mirror=True):
        self.dk = DatabackendMinna(base_dir)
        self.base_dir = base_dir
        self.size = size
        self.boxwarp = boxwarp
        self.mirror = mirror
        csv = os.path.join(
            base_dir, "_data", "lustrous", "subsets", f"{subset}_{split}.csv"
        )
        with open(csv) as f:
            models = [l.strip() for l in f if l.strip()]
        self.bns = [
            f"rutileE/rgb/{bn[-1]}/{bn}/{i:04d}"
            for bn in models
            for i in range(n_generations)
        ]

    def __len__(self):
        return len(self.bns) * (2 if self.mirror else 1)

    def _pca_feat(self, rs, kind, franch, idx):
        fn = os.path.join(
            self.base_dir, "_data", "lustrous", "renders", rs, kind, franch, idx,
            "front.pkl",
        )
        with open(fn, "rb") as f:
            return np.asarray(pickle.load(f), dtype=np.float32)

    def _base_item(self, bn: str) -> Dict:
        bw = self.size and self.boxwarp
        rs, dtype, franch, idx, view = bn.split("/")
        isfan = rs == "daredemoE" and dtype == "fandom_align" and view == "front"
        if isfan:
            bn_orig = bn
            bn = f"{rs}/ortho/{franch}/{idx}/front"
            rs, dtype, franch, idx, view = bn.split("/")

        x = self.dk[bn]
        cam = _label(x["render_params"])
        xyz_dtype = {
            ("daredemoE", "rgb60"): "xyza60",
            ("daredemoE", "ortho"): "ortho_xyza",
        }.get((rs, dtype), "xyza")
        xox = self.dk[f"{rs}/{xyz_dtype}/{franch}/{idx}/{view}"]["image"].resize(self.size).t()
        ret = Dict(
            bn=x["bn"],
            image=x["image"].resize(self.size).convert("RGBA").bg("w").convert("RGB").t(),
            xyz=xox[:3] * self.boxwarp - self.boxwarp / 2,
            alpha=xox[-1:],
            camera_label=cam,
            resnet_feats=self._pca_feat(rs, "ortho_katepca", franch, idx),
            resnet_chonk=self._pca_feat(rs, "ortho_katepca_chonk", franch, idx),
        )
        for v in ORTHO_VIEWS:
            xo = self.dk[f"{rs}/ortho/{franch}/{idx}/{v}"]
            ret[f"image_ortho_{v}"] = (
                xo["image"].resize(self.size).convert("RGBA").bg("w").convert("RGB").t()
            )
            ret[f"image_ortho_{v}_camera_label"] = _label(xo["render_params"])
            xox = self.dk[f"{rs}/ortho_xyza/{franch}/{idx}/{v}"]["image"].resize(self.size).t()
            ret[f"image_ortho_{v}_xyz"] = xox[:3] * self.boxwarp - self.boxwarp / 2
            ret[f"image_ortho_{v}_alpha"] = xox[-1:]
        for v in ("left", "right"):
            xo = self.dk[f"{rs}/dorthoA/{franch}/{idx}/{v}"]
            ret[f"image_dorthoA_{v}"] = xo["image"].resize(self.size).t()
            ret[f"image_dorthoA_{v}_camera_label"] = _label(xo["render_params"])
        if isfan:
            ret["bn"] = bn_orig
            rs2, _, franch2, idx2, _ = bn_orig.split("/")
            xo = self.dk[bn_orig]
            ret["resnet_feats"] = self._pca_feat(rs2, "fandom_align_katepca", franch2, idx2)
            ret["resnet_chonk"] = self._pca_feat(rs2, "fandom_align_katepca_chonk", franch2, idx2)
            ret["image_ortho_front"] = (
                xo["image"].resize(self.size).convert("RGBA").bg("w").convert("RGB").t()
            )
        return ret

    def __getitem__(self, idx: int) -> TDict:
        n = len(self.bns)
        x = self._base_item(self.bns[idx % n])
        flip = idx >= n
        return assemble_sample(x, flip=flip)


def assemble_sample(x: Dict, flip: bool = False) -> TDict:
    """DatasetWrapper.__getitem__ layout incl. mirror aug (ecrutileE.py:46-166)."""

    def fx(img, is_xyz=False):
        if not flip:
            return np.ascontiguousarray(img)
        img = img[..., ::-1].copy()
        if is_xyz:
            img[0] *= -1
        return img

    views = {}
    for v in ("front", "left", "right", "back"):
        views[v] = dict(
            img=fx(x[f"image_ortho_{v}"]),
            xyz=fx(x[f"image_ortho_{v}_xyz"], is_xyz=True),
            alpha=fx(x[f"image_ortho_{v}_alpha"]),
            cam=x[f"image_ortho_{v}_camera_label"],
        )
    d = {
        "left": fx(x["image_dorthoA_left"]),
        "right": fx(x["image_dorthoA_right"]),
    }
    if flip:
        views["left"], views["right"] = views["right"], views["left"]
        d["left"], d["right"] = d["right"], d["left"]

    label = x["camera_label"]
    if flip:
        label = mirror_camera_label(label)

    rf = x["resnet_feats"]
    rc = x["resnet_chonk"]
    # precomputed features come as [2, ...]: slot 0 = original, 1 = h-flip
    if rf.ndim > 1 and rf.shape[0] == 2:
        rf = rf[1] if flip else rf[0]
    if rc.ndim > 3 and rc.shape[0] == 2:
        rc = rc[1] if flip else rc[0]

    image = fx(x["image"])
    xyz = fx(x["xyz"], is_xyz=True)
    alpha = fx(x["alpha"])
    return {
        "image": (image * 255).astype(np.uint8),
        "xyz": xyz,
        "alpha": alpha,
        "camera": label,
        "condition": {
            "resnet_feats": rf,
            "resnet_chonk": rc,
            "image": image,
            "image_xyz": xyz,
            "image_alpha": alpha,
            "image_camera": label,
            **{
                k: v
                for view in ("front", "left", "right", "back")
                for k, v in {
                    f"image_ortho_{view}": views[view]["img"],
                    f"image_ortho_{view}_xyz": views[view]["xyz"],
                    f"image_ortho_{view}_alpha": views[view]["alpha"],
                    f"image_ortho_{view}_camera": views[view]["cam"],
                }.items()
            },
            "image_dorthoA_left": d["left"],
            "image_dorthoA_right": d["right"],
        },
    }


def collate(samples) -> TDict:
    """Stack a list of sample dicts into a batch dict of arrays."""

    def stack(key_path, vals):
        return np.stack(vals)

    out = {}
    for k in samples[0]:
        if isinstance(samples[0][k], dict):
            out[k] = collate([s[k] for s in samples])
        elif isinstance(samples[0][k], str):
            out[k] = [s[k] for s in samples]
        else:
            out[k] = np.stack([np.asarray(s[k]) for s in samples])
    return out


class InfiniteBatcher:
    """Rank-sharded infinite shuffled batches (misc.py:113-147 role).

    All ranks seed the SAME shuffle RNG (`seed`, not `seed + rank`) and each
    takes its strided slice ``order[rank::world]`` — exactly the reference
    InfiniteSampler's shared-order partition (src/torch_utils/misc.py:113-147).
    Per-rank seeds would shuffle different permutations, so the strided
    slices would no longer partition the epoch (ranks duplicate/miss samples).
    """

    def __init__(self, dataset, batch_size: int, rank: int = 0, world: int = 1,
                 seed: int = 0):
        assert 0 <= rank < world
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank = rank
        self.world = world
        self.rng = np.random.RandomState(seed)

    def __iter__(self) -> Iterator[TDict]:
        n = len(self.dataset)
        order = np.arange(n)
        while True:
            self.rng.shuffle(order)
            local = order[self.rank :: self.world]
            for i in range(0, len(local) - self.batch_size + 1, self.batch_size):
                idxs = local[i : i + self.batch_size]
                yield collate([self.dataset[int(j)] for j in idxs])


# ---------------------------------------------------------------------------
# synthetic data (tests + dryrun; real _data tree not in the snapshot)

def synthetic_batch(bs=2, size=64, chonk_ch=16, feat_dim=32, boxwarp=0.7,
                    seed=0) -> TDict:
    """A random batch with the exact ecrutileE key/shape layout."""
    rng = np.random.RandomState(seed)

    def img(c=3):
        return rng.rand(bs, c, size, size).astype(np.float32)

    def xyz():
        return (rng.rand(bs, 3, size, size).astype(np.float32) - 0.5) * boxwarp

    elev = rng.uniform(-20, 60, bs)
    azim = rng.uniform(-180, 180, bs)
    cam = np.asarray(camera_label(elev, azim, np.ones(bs), 30 * np.ones(bs)),
                     dtype=np.float32)
    ortho_cams = {
        v: np.asarray(
            camera_label(np.zeros(bs), az * np.ones(bs), np.ones(bs), -np.ones(bs)),
            dtype=np.float32,
        )
        for v, az in dict(front=0, left=90, right=-90, back=180).items()
    }
    image = img()
    xyz_r = xyz()
    alpha = (rng.rand(bs, 1, size, size) > 0.5).astype(np.float32)
    cond = {
        "resnet_feats": rng.randn(bs, feat_dim).astype(np.float32),
        "resnet_chonk": rng.randn(bs, chonk_ch, 8, 8).astype(np.float32),
        # [0,1] like every condition image (the reference's Img.t() range;
        # recon losses compare [0,1] renders against it)
        "image": image,
        "image_xyz": xyz_r,
        "image_alpha": alpha,
        "image_camera": cam,
    }
    for v in ORTHO_VIEWS:
        cond[f"image_ortho_{v}"] = img()
        cond[f"image_ortho_{v}_xyz"] = xyz()
        cond[f"image_ortho_{v}_alpha"] = (
            rng.rand(bs, 1, size, size) > 0.5
        ).astype(np.float32)
        cond[f"image_ortho_{v}_camera"] = ortho_cams[v]
    cond["image_dorthoA_left"] = img(4)
    cond["image_dorthoA_right"] = img(4)
    return {
        "image": image * 2 - 1,  # training loop normalizes uint8 -> [-1,1]
        "xyz": xyz_r,
        "alpha": alpha,
        "camera": cam,
        "cond": cond,
    }
