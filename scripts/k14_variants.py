#!/usr/bin/env python3
"""K14's design choices measured on the card (csrc/grid_sample.cu).

    python3 scripts/k14_variants.py [--parent FILE]

Builds the tree's grid_sample.cu, and builds of it with one design choice
changed by -D (K14_BLOCKS, K14_CHUNK, K14_CB) and, with --parent, an
earlier grid_sample.cu (called through chip_smoke.k14_parent_adapt where
its entry points take P = Hg Wg). Then times each forward, in the order
v1 .. vn vn .. v1 with chip_smoke.cuda_ms, beside F.grid_sample, at ADA's call as
augment_pipe makes it (a strided grid, which the wrapper copies), at ADA's
call with a contiguous grid, at one channel of it, at an identity and a
45-degree grid of the same shape and at EQ-R's call; each output bit for bit
against the plain version (its buffer filled with NaN first). Then each
backward at ADA's call with a contiguous grid, beside the wrapper's zeroing
alone and aten's grid_sampler_2d_backward, each within K14_GRAD_TOL of the
plain version. Prints the card and the registers and spills of each build;
the last line is a JSON object of the times. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

VARIANTS = {"blocks4": {"K14_BLOCKS": 4}, "chunk1": {"K14_CHUNK": 1}, "chunk3": {"K14_CHUNK": 3},
            "chunk4": {"K14_CHUNK": 4}, "cb1": {"K14_CB": 1}, "cb2": {"K14_CB": 2}}


def build_variants(parent):
    """-> {name: the library as chip_smoke.parent_entries takes it}."""
    from panic3d_tpu_torch.kernels import build

    out = ROOT / "build" / "k14_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "grid_sample.cu"
    jobs = {"this": (src, {}), **{name: (src, defs) for name, defs in VARIANTS.items()}}
    if parent:
        jobs["parent"] = (Path(parent), {})
        cs.PARENT_SOURCES["grid_sample"] = Path(parent)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
         *(f"-D{k}={v}" for k, v in defs.items()), str(path), "-o", str(out / f"{name}.so")],
        stderr=subprocess.PIPE, text=True)
        for name, (path, defs) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        cs.require(proc.returncode == 0, f"{name} failed to build:\n{err}")
        for fn, regs, st, ld, _ in cs.ptxas_report(err):
            print(f"  {name}: {fn} {regs} registers, spill stores/loads {st}/{ld}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        libs[name] = (lib, cs.k14_parent_adapt()) if name == "parent" else lib
    return libs


def in_turns(fns):
    """{name: fn} timed in the order v1 .. vn vn .. v1 -> {name: [ms, ms]}."""
    times = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        times[n].append(cs.cuda_ms(fns[n]))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="FILE", help="an earlier grid_sample.cu to time beside")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from panic3d_tpu_torch.ops import grid_sample as gs

    if not torch.cuda.is_available():
        print("k14_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = build_variants(args.parent)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    with torch.no_grad():
        calls = cs.k14_calls(dev)
    x, grid, pad, ac = calls["ada"]
    xe, ge, pe, ae = calls["eqr"]
    del calls
    N, C, H, W = x.shape
    Hg, Wg = grid.shape[1:3]
    py, px = torch.meshgrid(torch.arange(Hg, dtype=torch.float32, device=dev),
                            torch.arange(Wg, dtype=torch.float32, device=dev), indexing="ij")
    size = torch.tensor([W, H], dtype=torch.float32, device=dev)

    def texels(ix, iy):   # texel coordinates -> align_corners=False's grid
        return ((2 * torch.stack([ix, iy], -1)[None].expand(N, Hg, Wg, 2) + 1) / size
                - 1).contiguous()

    cx, cy, c45 = px - Wg / 2, py - Hg / 2, math.cos(math.pi / 4)
    inputs = {
        "ada": (x, grid, pad, ac),
        "ada_contiguous_grid": (x, grid.contiguous(), pad, ac),
        "ada_one_channel": (x[:, :1].contiguous(), grid.contiguous(), pad, ac),
        "identity": (x, texels(px + 262.3, py + 262.3), pad, ac),
        "rotation_45": (x, texels(c45 * (cx - cy) + W / 2 + 0.3, c45 * (cx + cy) + H / 2 + 0.3),
                        pad, ac),
        "eqr": (xe, ge, pe, ae),
    }
    result = {"card": card, "forward": {}, "backward": {}}
    for label, (xx, gg, pp, aa) in inputs.items():
        with torch.no_grad():
            ref = gs.grid_sample_2d_plain(xx, gg, pp, aa)
            fns = {}
            for name, lib in libs.items():
                def fn(lib=lib, xx=xx, gg=gg, pp=pp, aa=aa):
                    with cs.parent_entries({"grid_sample_2d": lib}):
                        return gs.grid_sample_2d_kernel(xx, gg, pp, aa)

                junk = torch.full_like(ref, float("nan"))
                del junk
                bad = int((fn() != ref).sum())
                cs.require(bad == 0, f"{label}, {name}: {bad} values not equal to the plain's")
                fns[name] = fn
            times = in_turns(fns)
            lib_ms = cs.cuda_ms(lambda: F.grid_sample(xx, gg, mode="bilinear", padding_mode=pp,
                                                      align_corners=aa))
        result["forward"][label] = {"F.grid_sample": lib_ms, **times}
        print(f"{label} forward: F.grid_sample "
              f"{lib_ms:.6f} ms; " + "; ".join(f"{n} {t[0]:.6f} / {t[1]:.6f}"
                                                for n, t in times.items()) + f"  [{card}]",
              flush=True)

    grid = grid.contiguous()
    shape = tuple(x.shape)
    g = torch.randn((N, C, Hg, Wg), generator=torch.Generator(device=dev).manual_seed(1),
                    device=dev)
    with torch.no_grad():
        want = gs.grid_sample_2d_grad_plain(g, grid, shape, pad, ac)
        tol = cs.K14_GRAD_TOL * float(want.abs().max())
        fns = {}
        for name, lib in libs.items():
            def fn(lib=lib):
                with cs.parent_entries({"grid_sample_2d_grad": lib}):
                    return gs._launch_k14_grad(g, grid, shape, pad, ac)

            e = cs.max_err(fn(), want)
            cs.require(e <= tol, f"backward {name}: {e} > {tol}")
            fns[name] = fn
        del want
        times = in_turns(fns)
        zeros_ms = cs.cuda_ms(lambda: torch.zeros(shape, device=dev))
        lib_ms = cs.cuda_ms(lambda: torch.ops.aten.grid_sampler_2d_backward(
            g, x, grid, 0, 0 if pad == "zeros" else 1, ac, [True, False]))
    result["backward"] = {"aten": lib_ms, "zeros_alone": zeros_ms, **times}
    print(f"ada backward (contiguous grid): aten {lib_ms:.6f} ms, the wrapper's zeroing alone "
          f"{zeros_ms:.6f}; " + "; ".join(f"{n} {t[0]:.6f} / {t[1]:.6f}"
                                          for n, t in times.items()) + f"  [{card}]")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
