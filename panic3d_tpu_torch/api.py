"""Library entry point: portrait -> rendered views, turntable, coloured mesh
(panic3d_tpu/api.py).

    rec = Reconstructor(model=G)            # a port generator with its weights
    cond = rec.preprocess(portrait_rgb)     # [3,H,W] RGB in [0,1]
    spin = rec.turntable(cond, n=12)        # [12,3,512,512]
    mesh = rec.mesh(cond)                   # verts / faces / colors

One object owns the generator. Views render from one planes bundle per
portrait (eval/generate.py), the mesh through eval/volume.py:extract_mesh.
Not ported yet (they raise NotImplementedError): checkpoint loading
(``ckpt=``), the multi-device ``mesh=`` sharding, and the conditioning
preprocess's line filler and ResNet-PCA features (``rmline=``, ``resnet=``;
the extractor itself is models/resnet.py, which eval generate uses).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import configs
from .eval.generate import plane_cache_ok, planes_bundle, render_from_planes
from .eval.volume import extract_mesh

DEFAULT_OPTS = dict(triplane_crop=0.1, cull_clouds=0.5)


class Reconstructor:
    def __init__(self, model=None, tiny: bool = False, view_batch: int = 2,
                 opts: Optional[dict] = None, seed: int = 0, rmline=None, resnet=None,
                 ckpt: Optional[str] = None, mesh=None, device=None):
        for name, value in (("ckpt", ckpt), ("mesh", mesh), ("rmline", rmline),
                            ("resnet", resnet)):
            if value is not None:
                raise NotImplementedError(f"Reconstructor({name}=...) is not ported yet")
        self.opts = dict(DEFAULT_OPTS if opts is None else opts)
        self.view_batch = view_batch
        self.seed = seed
        if model is not None:
            self.g = model
        elif tiny:
            self.g = configs.tiny(force_sigmoid=True, device=device).init_weights(seed).eval()
        else:
            raise ValueError("pass model= or tiny=True")

    # -- conditioning --------------------------------------------------------

    def preprocess(self, image_rgb: np.ndarray, keypoints=None) -> dict:
        """[3,H,W] RGB in [0,1] -> the G.f ``cond`` dict: the image itself
        and zero ResNet features (the line filler is not ported yet, and
        ``resnet=`` is not taken yet)."""
        dev = self.g.device
        img = torch.as_tensor(np.asarray(image_rgb, np.float32))[None].to(dev)
        ch = 16 if "reschonk_add_16" in self.g.backbone.synthesis.cond_mode else 512
        return {"image_ortho_front": img,
                "resnet_chonk": torch.zeros((1, ch, 8, 8), dtype=torch.float32, device=dev)}

    # -- rendering -----------------------------------------------------------

    def views(self, cond: dict, elevations: Sequence[float], azimuths: Sequence[float],
              fovs: Optional[Sequence[float]] = None) -> dict:
        """Arbitrary views (fov < 0: orthographic) in batches of view_batch
        (the last padded with its last view) -> {'image', 'image_xyz',
        'image_weights'} as stacked numpy arrays [n, ...]."""
        n = len(elevations)
        fovs = list(fovs) if fovs is not None else [30.0] * n
        vb = min(self.view_batch, n)
        bundle = planes_bundle(self.g, self.seed, cond, self.opts) \
            if plane_cache_ok(self.g) else None
        outs = []
        for i in range(0, n, vb):
            k = min(vb, n - i)

            def batch(xs):
                xs = [float(v) for v in xs[i:i + k]]
                return xs + [xs[-1]] * (vb - k)

            if bundle is not None:
                out = render_from_planes(self.g, self.opts, bundle, batch(elevations),
                                         batch(azimuths), batch(fovs), cond)
            else:
                xin = {"seeds": [self.seed] * vb, "elevations": batch(elevations),
                       "azimuths": batch(azimuths), "fovs": batch(fovs),
                       "cond": {kk: v.expand((vb,) + tuple(v.shape[1:]))
                                for kk, v in cond.items()}, **self.opts}
                with torch.no_grad():
                    out = self.g.f(xin)
            outs.append({kk: out[kk][:k].float().cpu().numpy()
                         for kk in ("image", "image_xyz", "image_weights")})
        return {kk: np.concatenate([o[kk] for o in outs]) for kk in outs[0]}

    def turntable(self, cond: dict, n: int = 12, elevation: float = 0.0,
                  fov: float = 30.0) -> np.ndarray:
        """An n-view spin at one elevation ([-1,1] RGB images [n,3,H,W])."""
        azims = list(np.linspace(0.0, 360.0, n, endpoint=False))
        return self.views(cond, [elevation] * n, azims, [fov] * n)["image"]

    # -- geometry ------------------------------------------------------------

    def mesh(self, cond: dict, resolution: int = 256, level: float = 0.5, **kw) -> dict:
        """The coloured iso-surface mesh (verts in box_warp world units)."""
        xin = {"cond": cond, "seeds": [self.seed], **self.opts}
        return extract_mesh(self.g, xin, resolution=resolution, level=level, **kw)
