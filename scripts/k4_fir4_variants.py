#!/usr/bin/env python3
"""K4's 4x4 form's design choices measured on the card (csrc/upfirdn2d.cu).

    python3 scripts/k4_fir4_variants.py [--parent FILE]

Builds the tree's upfirdn2d.cu, and builds of it with one kernel design
choice changed by -D (KERNEL_VARIANTS): in the flat plan F4_PAIR=1 (one
output column a lane, scalar stores), F4_Y=32 (32-row tiles), F4_MINB=8
(eight blocks an SM, which caps the registers); and, with --parent, an
earlier upfirdn2d.cu. The block plan's limits (ops/upfirdn2d.py:Fir4Limits)
are changed on this tree's build instead (PLAN_VARIANTS): aligned rows
taken as unaligned ones ("flat", or "rows_scalar" below tall_min tiles),
"flat" however few tiles, no planes plan, the planes plan up to 64 output
columns, and up to 32 on aligned rows too. Then times each at the 4x4
form's calls of a training step that chip_smoke.k4_fir4_calls lists (both
directions), the view path's two 4x4 calls (bf16 [2,256,256,256], down 2
at padding 1 and the filter pass at padding 2), calls of 32^2 and 64^2
outputs, where the plan changes, k4_checks' small calls and
k4_form_checks' 3x3 ("fir_small"): in the order v1 .. vn vn .. v1 with
chip_smoke.cuda_ms, beside the depthwise conv2d, each output bit for bit
equal to this tree's build's. Prints the card and the registers and spills
of each build; the last line is a JSON object of the times. Needs one CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

KERNEL_VARIANTS = {"pair1": {"F4_PAIR": 1}, "y32": {"F4_Y": 32}, "minb8": {"F4_MINB": 8}}
PLAN_VARIANTS = {"aligned0": {"aligned_rows": False}, "tall0": {"tall_min": 0},
                 "pack0": {"pack_w": 0, "pack_wa": 0}, "pack64": {"pack_w": 64},
                 "packa32": {"pack_wa": 32}}


def build_variants(parent):
    """-> {name: ctypes library}, this tree's build first."""
    from panic3d_tpu_torch.kernels import build

    out = ROOT / "build" / "k4_fir4_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = build.CSRC / "upfirdn2d.cu"
    jobs = {"this": (src, {}), **{name: (src, defs) for name, defs in KERNEL_VARIANTS.items()}}
    if parent:
        jobs["parent"] = (Path(parent), {})
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}",
         *(f"-D{k}={v}" for k, v in defs.items()), str(path), "-o", str(out / f"{name}.so")],
        stderr=subprocess.PIPE, text=True)
        for name, (path, defs) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        err = proc.communicate()[1]
        cs.require(proc.returncode == 0, f"{name} failed to build:\n{err}")
        for fn, regs, st, ld, smem in cs.ptxas_report(err):
            if "fir4" in fn:
                print(f"  {name}: {fn} {regs} registers, spill stores/loads {st}/{ld}, "
                      f"static smem {smem}")
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def calls():
    """{(transposed, shape, dtype, up, down, pad): [count, f2d]}: k4_fir4_calls'
    4x4-form calls, the view path's two, the 32^2 / 64^2 ones and a 3x3."""
    import importlib

    import torch

    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    f = uf.setup_filter([1, 3, 3, 1])
    out = {k: v for k, v in cs.k4_fir4_calls().items()
           if uf.k4_plan(v[1], *k[3:]).variant != "up2"}
    bf, f32 = torch.bfloat16, torch.float32
    for shape, dtype, down, pad in (((cs.BATCH, 256, 256, 256), bf, 2, 1),
                                    ((cs.BATCH, 256, 256, 256), bf, 1, 2),
                                    ((8, 512, 66, 66), bf, 2, 0),
                                    ((8, 256, 33, 33), f32, 1, 1),
                                    ((8, 256, 130, 130), bf, 2, 0),
                                    ((8, 128, 65, 65), bf, 1, 1)):
        f2d, up, dn, p = uf.fir_passes(f, down=down, padding=pad)[0]
        out[(False, shape, dtype, tuple(up), tuple(dn), tuple(p))] = [1, f2d]
    # k4_checks' small calls: the dual discriminator's resize of 3 channels
    # (258-wide rows), a 102-wide filter pass; b32's aligned filter pass
    for shape, dtype, down, pad in (((cs.BATCH, 3, 258, 258), f32, 2, 0),
                                    ((cs.BATCH, 3, 258, 258), bf, 2, 0),
                                    ((cs.BATCH, 64, 102, 102), f32, 1, 2),
                                    ((8, 512, 32, 32), f32, 1, 1)):
        f2d, up, dn, p = uf.fir_passes(f, down=down, padding=pad)[0]
        out[(False, shape, dtype, tuple(up), tuple(dn), tuple(p))] = [1, f2d]
    # "fir_small": a 3x3 (k4_form_checks' call)
    f2d, up, dn, p = uf.fir_passes(uf.setup_filter([1, 2, 1]), padding=1)[0]
    out[(False, (cs.BATCH, 64, 256, 256), f32, tuple(up), tuple(dn), tuple(p))] = [1, f2d]
    return out


def in_turns(fns):
    """{name: fn} timed in the order v1 .. vn vn .. v1 -> {name: [ms, ms]}."""
    times = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        times[n].append(cs.cuda_ms(fns[n]))
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", metavar="FILE", help="an earlier upfirdn2d.cu to time beside")
    args = ap.parse_args(argv)

    import importlib

    import torch

    uf = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")
    if not torch.cuda.is_available():
        print("k4_fir4_variants: no CUDA device", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = build_variants(args.parent)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s")
    # (library, parent_entries' adapt, the plan's limits) of each variant
    limits = uf.F4_LIMITS
    runs = {name: (lib, None, limits) for name, lib in libs.items()}
    if args.parent and "f4_plan" not in Path(args.parent).read_text():
        runs["parent"] = (libs["parent"], lambda argtypes, a: (argtypes[:-3] + argtypes[-1:],
                                                               a[:-3] + a[-1:]), limits)
    for name, change in PLAN_VARIANTS.items():
        runs[name] = (libs["this"], None, limits._replace(**change))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    result = {"card": card, "calls": []}
    with torch.no_grad():
        for (transposed, shape, dtype, up, down, pad), (_, f2d) in calls().items():
            xx = torch.randn(shape, generator=gen, device=dev).to(dtype)
            spec = (f2d, up, down, pad)
            fns, ref = {}, None
            for name, (lib, adapt, lim) in runs.items():
                def fn(lib=lib, adapt=adapt, lim=lim):
                    uf.F4_LIMITS = lim
                    try:
                        with cs.parent_entries({"upfirdn2d": (lib, adapt)}):
                            return uf._launch_k4(xx, *spec, transposed)
                    finally:
                        uf.F4_LIMITS = limits

                got = fn()
                if ref is None:
                    ref = got
                    e = cs.max_err(got, uf.upfirdn2d_plain(xx, *spec))
                    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 1e-5) * float(
                        ref.float().abs().max())
                    cs.require(e <= tol, f"{list(shape)}: {e} from the plain version > {tol}")
                bad = int((got != ref).sum())
                cs.require(bad == 0, f"{list(shape)}, {name}: {bad} values differ from this "
                                     "tree's")
                fns[name] = fn
            times = in_turns(fns)
            lib = cs.k4_backward_library(xx, f2d, up, down, pad, tuple(ref.shape[-2:]))
            lib_ms = cs.cuda_ms(lib) if lib else None
            bound_ms, _ = cs.bound(cs.nbytes(xx, ref), ref.numel() * 32.0)
            plan = uf.fir4_block_plan(shape[0] * shape[1], *shape[2:], *ref.shape[-2:],
                                      down[0], dtype, *f2d.shape).plan
            label = (f"{'transposed' if transposed else 'forward'} {list(shape)} "
                     f"{str(dtype)[6:]} down={down[0]} pad={list(pad)} -> "
                     f"{ref.shape[-2]}x{ref.shape[-1]} ({plan})")
            result["calls"].append({"call": label, "bound_ms": bound_ms, "conv2d_ms": lib_ms,
                                    **times})
            print(f"{label}: bound {bound_ms:.6f}, conv2d "
                  + (f"{lib_ms:.6f}" if lib_ms else "none") + "; "
                  + "; ".join(f"{n} {t[0]:.6f} / {t[1]:.6f}" for n, t in times.items())
                  + f"  [{card}]", flush=True)
            del xx, ref
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
