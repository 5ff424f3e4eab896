"""K4's 4x4 form (csrc/upfirdn2d.cu: upfirdn2d_fir4_planes_kernel,
upfirdn2d_fir4_kernel and upfirdn2d_fir4_flat_kernel) emulated in plain
torch, thread by thread.

``fir4_emulate`` runs a call the way ops/upfirdn2d.py:fir4_block_plan says
the kernels cover it. "planes": each thread reads its strip's window of one
plane straight from the input, zero outside the image. "rows" and "flat":
each block stages its tile's window as rows of 16-byte chunks of the flat
tensor counted from the boundary ``shift`` elements before x's data (row k
from the chunk holding element (nc, sy + k, sx), so window column j lies at
staged position off_k + j, off_k = (shift + flat(nc, sy + k, sx)) mod V;
with aligned rows, as "rows" takes them, off_k is the tile's sx mod V),
zero outside the image ("rows": widened to f32, chunks wholly inside or
outside a row; "flat": the rows and chunks its valid outputs read, in the
input's dtype by cp.async, its zero fill past a row's end and the left
edge zeroed after the copy: the same staged values). "rows_scalar": each
block stages its whole window element by element, window column j at
staged position j. Each lane then reads its taps at those staged
positions. Every output sums its taps a then b with fmaf from 0 in f32 (an
f32 product is exact in f64, so each fmaf is the f64 sum rounded to f32),
rounded to x's dtype. The emulation asserts
that every output is written exactly once and that every tap a valid
output reads lies in its window: in a thread's strip, or in the rows and
chunks its tile stages.
"""

import importlib

import torch

tup = importlib.import_module("panic3d_tpu_torch.ops.upfirdn2d")

WARPS = tup.F4_THREADS // 32


def fma(a, b, c):
    """fmaf in f32: the product exact in f64, one rounding of the sum."""
    return (a.double() * b.double() + c.double()).float()


def _planes(xf, taps, down, pad, oh, ow, plan):
    nc_n, h, w = xf.shape
    fh, fw = taps.shape
    px0, _, py0, _ = pad
    rows, nr = plan.rows, plan.window[0]
    strips = -(-oh // rows)
    t = torch.arange(nc_n * strips * ow)
    nc, rem = t // (strips * ow), t % (strips * ow)
    s, ox = rem // ow, rem % ow
    oy0 = s * rows
    ix0, iy0 = down * ox - px0, down * oy0 - py0
    out = torch.zeros(nc_n, oh, ow)
    writes = torch.zeros(nc_n * oh * ow, dtype=torch.long)
    for r in range(rows):
        oy = oy0 + r
        acc = torch.zeros(t.shape)
        for a in range(fh):
            assert down * r + a < nr, "a tap outside the thread's window"
            iy = iy0 + down * r + a
            for b in range(fw):
                ix = ix0 + b
                inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                v = torch.where(inside, xf[nc, iy.clamp(0, h - 1), ix.clamp(0, w - 1)], 0.0)
                acc = fma(taps[a, b].expand_as(acc), v, acc)
        keep = oy < oh
        out[nc[keep], oy[keep], ox[keep]] = acc[keep]
        writes.index_add_(0, (nc * oh + oy)[keep] * ow + ox[keep],
                          torch.ones(int(keep.sum()), dtype=torch.long))
    return out, writes


def _tiles(xf, taps, down, pad, oh, ow, plan, esize):
    nc_n, h, w = xf.shape
    fh, fw = taps.shape
    px0, _, py0, _ = pad
    ty, tx = plan.tile
    p_n, wx = plan.lanes
    R, (win_y, win_x), sw = plan.rows, plan.window, plan.stage_w
    V = 16 // esize
    scalar = plan.plan == "rows_scalar"
    flat = xf.reshape(-1)
    tiles_x, tiles_y = -(-ow // tx), -(-oh // ty)
    t = torch.arange(nc_n * tiles_x * tiles_y)
    nc, rem = t // (tiles_x * tiles_y), t % (tiles_x * tiles_y)
    oy0, ox0 = rem // tiles_x * ty, rem % tiles_x * tx
    warp, lane = torch.arange(WARPS), torch.arange(32)
    lx = (warp % wx)[:, None] * 32 + lane[None, :]                  # [warp, lane]
    r0 = ((warp // wx) * R)[:, None].expand(WARPS, 32)
    # [tile, warp, lane, r, p]
    T = lambda v: v[:, None, None, None, None]  # noqa: E731
    L = lambda v: v[None, :, :, None, None]     # noqa: E731
    r = torch.arange(R)[None, None, None, :, None]
    p = torch.arange(p_n)[None, None, None, None, :]
    oy = T(oy0) + L(r0) + r
    ox = T(ox0) + p_n * L(lx) + p
    sy, sx = T(down * oy0 - py0), T(down * ox0 - px0)
    ncb = T(nc)
    shape = torch.broadcast_shapes(oy.shape, ox.shape)
    acc = torch.zeros(shape)
    keep = ((oy < oh) & (ox < ow)).expand(shape)
    # the rows and columns of its tile's window the block stages
    nrows = (down * (torch.clamp(oh - T(oy0), max=ty) - 1) + fh).expand(shape)
    ncols = (down * (torch.clamp(ow - T(ox0), max=tx) - 1) + fw).expand(shape)
    for a in range(fh):
        k = down * (L(r0) + r) + a                                    # window row
        assert int(k.max()) < win_y, "a tap row outside the window"
        assert bool((k.expand(shape) < nrows)[keep].all()), "a tap row the tile does not stage"
        iy = sy + k
        f_k = plan.shift + (ncb * h + iy) * w + sx                    # its chunks' frame
        off = torch.zeros_like(f_k) if scalar else f_k % V
        for b in range(fw):
            pos = off + down * (p_n * L(lx) + p) + b                 # staged position
            j = pos - off                                             # window column
            assert int(j.max()) < win_x, "a tap column outside the window"
            assert int(pos.max()) < sw, "a tap past the staged row"
            # the positions it stages: its whole window, or its chunks
            staged = win_x if scalar else -(-(off + ncols) // V) * V
            assert bool((pos.expand(shape) < staged)[keep].all()), "a tap the tile does not stage"
            col = sx + j
            inside = (iy >= 0) & (iy < h) & (col >= 0) & (col < w)
            g = f_k - plan.shift - off + pos                          # the staged element
            v = torch.where(inside, flat[g.clamp(0, flat.numel() - 1)], 0.0)
            acc = fma(taps[a, b].expand(shape), v.expand(shape), acc)
    oyk, oxk, nck = oy.expand(shape)[keep], ox.expand(shape)[keep], ncb.expand(shape)[keep]
    out = torch.zeros(nc_n, oh, ow)
    out[nck, oyk, oxk] = acc[keep]
    writes = torch.zeros(nc_n * oh * ow, dtype=torch.long)
    writes.index_add_(0, (nck * oh + oyk) * ow + oxk, torch.ones(oyk.numel(), dtype=torch.long))
    return out, writes


def fir4_emulate(x, f2d, down, pad, plan=None, shift=0):
    """The 4x4 form's outputs for upfirdn2d_plain(x, f2d, (1, 1), (down,
    down), pad) under ``plan`` (default: fir4_block_plan of this call; a
    test may pass the plan of the same call at its full channel count,
    which covers each plane alike) -> (outputs in x's dtype, the plan)."""
    n, c, h, w = x.shape
    fh, fw = int(f2d.shape[0]), int(f2d.shape[1])
    oh, ow = tup._out_size(h, w, fh, fw, (1, 1), (down, down), pad)
    if plan is None:
        plan = tup.fir4_block_plan(n * c, h, w, oh, ow, down, x.dtype, fh, fw, shift)
    xf = x.float().reshape(n * c, h, w)
    taps = f2d.float()
    if plan.plan == "planes":
        out, writes = _planes(xf, taps, down, pad, oh, ow, plan)
    else:
        out, writes = _tiles(xf, taps, down, pad, oh, ow, plan, x.element_size())
    assert int(writes.min()) == 1 and int(writes.max()) == 1, \
        f"outputs written {int(writes.min())} to {int(writes.max())} times"
    return out.reshape(n, c, oh, ow).to(x.dtype), plan
