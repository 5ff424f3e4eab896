"""Filesystem databackend for the lustrous render sets (panic3d_tpu/data/databack.py).

Role of `_databacks/lustrous_renders_v1.py:107-206` (DatabackendMinna):
basenames `renderset/dtype/franchise/id/view` map to PNG renders + camera
render-params merged from the per-set metadata JSONs, with the dtype
aliasing (ortho -> ortho_xyza/dorthoA/fandom_align*) and fixed ortho params
for the vtuber set.
"""

from __future__ import annotations

import json
import os

from ..utils.config import Dict
from ..utils.imglib import Img

VTUBER_ORTHO_PARAMS = {
    "elev": 0.0,
    "azim": 0.0,
    "dist": 1.0,
    "fov": -1,
    "near": 0.5,
    "far": 1.5,
    "boxwarp": 0.7,
}

_RENDERSETS = ("rutileE", "daredemoE", "virtualyoutuberE")

_META_FILES = (
    "renders/rutileE/rutileE_meta.json",
    "renders/daredemoE/daredemoE_meta.json",
    "renders/daredemoE/danbooru_rutileE/renderparams.json",
    "renders/kiddoWE/danbooru_rutileE/renderparams.json",
    "renders/daredemoE/asoul_meta.json",
)

_ALIASES = {
    "rutileE/ortho/": ("rutileE/ortho_xyza", "rutileE/dorthoA"),
    "daredemoE/ortho/": (
        "daredemoE/ortho_xyza",
        "daredemoE/fandom_align",
        "daredemoE/fandom_align_rmlineEA",
        "daredemoE/dorthoA",
    ),
    # xyz maps share the rgb view's render params
    "rutileE/rgb/": ("rutileE/xyza",),
    "daredemoE/rgb60/": ("daredemoE/xyza60",),
}


class DatabackendMinna:
    def __init__(self, base_dir: str = ".", dtypes=None):
        self.dn = os.path.join(base_dir, "_data", "lustrous")
        self.bns = self._walk_bns()
        self.dtypes = set(dtypes) if dtypes is not None else {"image", "render_params"}
        self.rp_meta = {}
        if "render_params" in self.dtypes:
            for rel in _META_FILES:
                fn = os.path.join(self.dn, rel)
                if os.path.isfile(fn):
                    with open(fn) as f:
                        self.rp_meta.update(json.load(f))
            for k, v in list(self.rp_meta.items()):
                for prefix, targets in _ALIASES.items():
                    if k.startswith(prefix):
                        src = prefix[:-1]
                        for t in targets:
                            self.rp_meta[k.replace(src, t)] = v
            for bn in self.bns:
                if bn.startswith("virtualyoutuberE/"):
                    self.rp_meta[bn] = {"render_params": dict(VTUBER_ORTHO_PARAMS)}

    def _walk_bns(self):
        bns = []
        for rs in _RENDERSETS:
            root = os.path.join(self.dn, "renders", rs)
            if not os.path.isdir(root):
                continue
            for dtype in sorted(os.listdir(root)):
                droot = os.path.join(root, dtype)
                if not os.path.isdir(droot):
                    continue
                for franch in sorted(os.listdir(droot)):
                    froot = os.path.join(droot, franch)
                    if franch.startswith("_") or not os.path.isdir(froot):
                        continue
                    for idx in sorted(os.listdir(froot)):
                        iroot = os.path.join(froot, idx)
                        if not os.path.isdir(iroot):
                            continue
                        for fn in sorted(os.listdir(iroot)):
                            if fn.endswith(".png") and not fn.startswith("_"):
                                bns.append(
                                    f"{rs}/{dtype}/{franch}/{idx}/{fn[:-4]}"
                                )
        return sorted(bns)

    def __len__(self):
        return len(self.bns)

    def __getitem__(self, bn: str) -> Dict:
        rs, dtype, franch, idx, view = bn.split("/")
        ret = Dict(
            bn=bn,
            info=dict(renderset=rs, dtype=dtype, franch=franch, idx=idx, view=view),
        )
        if "image" in self.dtypes:
            ret["image"] = Img(os.path.join(self.dn, "renders", f"{bn}.png"))
        if "render_params" in self.dtypes and bn in self.rp_meta:
            ret["render_params"] = self.rp_meta[bn]["render_params"]
        return ret
