"""The ResNet-block kernel's launch plan (ldm_tpu_torch/ops/resnet_block.py::
plan_resnet) and the order of work it drives, held on the CPU.

The CUDA kernel runs only on a GPU.  What it does with a plan is written out
here in plain PyTorch (``emulate_block``): per output tile of 128 pixels x 64
channels, a chunk's halo tile gathered with the per-pixel zero rule, the
partial sums of each rank's K units, the ranks added in rank order, the
GroupNorm statistics from per-tile partial sums.  That emulation is held
against ``resnet_block_torch``, so a tile that spans several items, a split
that cuts a chunk, and the ragged edges are checked where there is no card.
"""

import numpy as np
import pytest
import torch

from ldm_tpu_torch.ops import resnet_block as rb
from ldm_tpu_torch.perf import probe13

GROUPS = 8
# (name, side, C_in, C_out): the flagship UNet's 11 sites, probe 13's four,
# the 64px site and the ragged cases chip_smoke.py adds
RAGGED = [("ragged-8x8", 8, 40, 24), ("ragged-4x4", 4, 24, 16), ("ragged-2x2", 2, 16, 16)]
SITES = probe13.UNET_SITES + probe13.SITES + [("64px-l0", 64, 64, 64)] + RAGGED
BATCHES = (2, 3, 20, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
GRID = [pytest.param(b, site, dt, id=f"{site[0]}-2B{b}-{str(dt)[6:]}")
        for site in SITES for b in BATCHES for dt in DTYPES]


def plan_of(b, site, dtype):
    _, side, cin, cout = site
    return rb.plan_resnet(b, side, side, cin, cout, dtype, groups=GROUPS)


@pytest.mark.parametrize("b,site,dtype", GRID)
def test_plan_fits_the_card(b, site, dtype):
    _, side, cin, cout = site
    p = plan_of(b, site, dtype)
    assert p == plan_of(b, site, dtype)  # a pure function of its arguments
    assert max(p.smem1, p.smem2) <= 232_448
    assert 1 <= p.split1 <= 8 and 1 <= p.split2 <= 8
    # the tiles cover every pixel and every output channel, the last ones ragged
    m = b * side * side
    assert (p.m_tiles - 1) * rb.TILE_M < m <= p.m_tiles * rb.TILE_M
    assert (p.n_tiles - 1) * rb.TILE_N < cout <= p.n_tiles * rb.TILE_N
    assert p.chunk * dtype.itemsize == 128
    assert (p.chunks1 - 1) * p.chunk < cin <= p.chunks1 * p.chunk
    assert (p.chunks2 - 1) * p.chunk < cout <= p.chunks2 * p.chunk
    assert p.chunks_sc == (p.chunks1 if cin != cout else 0)
    # no split where the tiles alone fill the card's 132 SMs
    if p.m_tiles * p.n_tiles >= 132:
        assert p.split1 == p.split2 == 1
    assert p.ctas(1) == p.m_tiles * p.n_tiles * p.split1
    assert len(p.ints()) == 6 and all(isinstance(v, int) for v in p.ints())


@pytest.mark.parametrize("b,site,dtype", GRID)
def test_split_covers_every_unit_once(b, site, dtype):
    """Over the ranks of a split, every (tap, channel chunk) of a conv, and
    every chunk of the shortcut, exactly once; a rank's units are chunk-major
    and no rank is idle."""
    p = plan_of(b, site, dtype)
    for conv, split, chunks in ((1, p.split1, p.chunks1), (2, p.split2, p.chunks2)):
        units = [u for r in range(split) for u in p.units(conv, r)]
        want = [("conv", c, t) for c in range(chunks) for t in range(9)]
        if conv == 2:
            want += [("shortcut", c, 4) for c in range(p.chunks_sc)]
        assert units == want
        assert len(units) == p.n_units(conv)
        sizes = [len(p.units(conv, r)) for r in range(split)]
        assert min(sizes) >= (rb.MIN_UNITS if split > 1 else 1)
        assert max(sizes) - min(sizes) <= 1


def test_split_grows_as_the_grid_shrinks():
    """The 2x2 bottleneck at 2B=128 has 32 output tiles: four CTAs a tile
    (128 CTAs), at 2B=20 it has 8: eight CTAs a tile; the 32x32 sites have
    1,024 and are not split."""
    mid = rb.plan_resnet(128, 2, 2, 512, 512, torch.bfloat16)
    assert (mid.m_tiles, mid.n_tiles, mid.split1, mid.split2) == (4, 8, 4, 4)
    small_mid = rb.plan_resnet(20, 2, 2, 512, 512, torch.bfloat16)
    assert (small_mid.split1, small_mid.split2) == (8, 8)
    enc3 = rb.plan_resnet(128, 4, 4, 256, 512, torch.bfloat16)  # 128 tiles: two CTAs a tile
    assert (enc3.split1, enc3.split2) == (2, 2)
    enc0 = rb.plan_resnet(128, 32, 32, 64, 64, torch.bfloat16)
    assert (enc0.m_tiles, enc0.n_tiles, enc0.split1, enc0.split2) == (1024, 1, 1, 1)
    # a split never leaves a rank fewer than MIN_UNITS units
    small = rb.plan_resnet(2, 2, 2, 16, 16, torch.bfloat16)
    assert small.n_units(1) == 9 and small.split1 == 4
    with pytest.raises(ValueError):
        small.units(1, 4)


@pytest.mark.parametrize("kw", [
    dict(cin=776, cout=64),                       # wider than the kernel takes
    dict(cin=64, cout=776),
    dict(cin=20, cout=64),                        # not divisible by the groups
    dict(cin=64, cout=36),
    dict(dtype=torch.float16),                    # no fp16 kernel
    dict(b=0),
    dict(cin=64, cout=128, use_shortcut=False),   # identity shortcut needs C_in == C_out
    dict(side=2048),                              # the halo tile outgrows shared memory
], ids=["cin-wide", "cout-wide", "cin-groups", "cout-groups", "fp16", "empty", "identity",
        "smem"])
def test_plan_raises_on_what_no_path_takes(kw):
    a = dict(b=2, side=8, cin=64, cout=64, dtype=torch.float32, use_shortcut=None)
    a.update(kw)
    with pytest.raises(ValueError):
        rb.plan_resnet(a["b"], a["side"], a["side"], a["cin"], a["cout"], a["dtype"],
                       groups=GROUPS, use_shortcut=a["use_shortcut"])


# ---- the kernel's order of work, in plain PyTorch


def tile_partials(v, plan, n, groups, n_tiles, split=1):
    """(m_tiles, n_tiles * split, slots, G, 2): per pixel tile, column tile
    and rank (a rank holds the rows [r, r + 1) * 128 / split of the tile), the
    sums of v and v^2 of each (item slot, group) inside that window
    (tile_group_sums); v is (M, C)."""
    m, c = v.shape
    per = c // groups
    sl = rb._slots(rb.TILE_M, n)
    part = torch.zeros(plan.m_tiles, n_tiles * split, sl, groups, 2)
    for mt in range(plan.m_tiles):
        m0 = mt * rb.TILE_M
        rows = min(rb.TILE_M, m - m0)
        for nt in range(n_tiles):
            c0, c1 = nt * rb.TILE_N, min((nt + 1) * rb.TILE_N, c)
            for rank in range(split):
                lo = m0 + min(rb.TILE_M * rank // split, rows)
                hi = m0 + min(rb.TILE_M * (rank + 1) // split, rows)
                for s in range(sl):
                    item = m0 // n + s
                    ra, rb_ = max(item * n, lo), min((item + 1) * n, hi)
                    for g in range(groups):
                        ca, cb = max(g * per, c0), min((g + 1) * per, c1)
                        if rb_ > ra and cb > ca:
                            blk = v[ra:rb_, ca:cb]
                            part[mt, nt * split + rank, s, g, 0] = blk.sum()
                            part[mt, nt * split + rank, s, g, 1] = (blk * blk).sum()
    return part


def finish_stats(part, item, n, per, eps):
    """(G, 2): mean and 1/sqrt(var + eps) of one item from the partials of
    the tiles that hold its pixels, added in tile order (a conv's prologue)."""
    m_tiles = part.shape[0]
    mt0, mt1 = item * n // rb.TILE_M, min(((item + 1) * n - 1) // rb.TILE_M, m_tiles - 1)
    tot = torch.zeros(part.shape[3], 2)
    for mt in range(mt0, mt1 + 1):
        slot = item - mt * rb.TILE_M // n
        for nt in range(part.shape[1]):
            tot = tot + part[mt, nt, slot]
    mu = tot[:, 0] / (n * per)
    var = (tot[:, 1] / (n * per) - mu * mu).clamp_min(0.0)
    return torch.stack([mu, torch.rsqrt(var + eps)], dim=1)


def emulate_conv(plan, conv, src, part, gs, gb, wgt, h, w, groups, eps, x=None, ws=None):
    """The fp32 sums of one conv over every output tile, as the kernel takes
    them: src (M, Cs) raw, normalised on the way into a chunk's halo tile;
    wgt (9, Cs, Co); for conv2 with a 1x1 shortcut x (M, Cx) and ws (Cx, Co)."""
    m, cs = src.shape
    co = wgt.shape[-1]
    n, ck = h * w, plan.chunk
    per = cs // groups
    split = plan.split1 if conv == 1 else plan.split2
    # the padded weights: rows to whole chunks, columns to whole tiles
    csp, cop = -(-cs // ck) * ck, plan.n_tiles * rb.TILE_N
    wpad = torch.zeros(9, csp, cop)
    wpad[:, :cs, :co] = wgt
    if ws is not None:
        cxp = -(-x.shape[1] // ck) * ck
        wspad = torch.zeros(cxp, cop)
        wspad[:x.shape[1], :co] = ws
    hr = plan.halo_rows
    assert hr == rb.TILE_M + 2 * w + 2
    out = torch.zeros(m, co)
    stats = {}
    for mt in range(plan.m_tiles):
        m0 = mt * rb.TILE_M
        rows = min(rb.TILE_M, m - m0)
        # each output pixel's own (h, w) decides which taps exist
        pix = torch.arange(m0, m0 + rows)
        ph, pw = (pix % n) // w, pix % w

        def halo_tile(kind, chunk):
            """(hr + 1, ck): the chunk's tile; row hr is the row of zeros."""
            tile = torch.zeros(hr + 1, ck)
            for hrow in range(hr):
                p = m0 - (w + 1) + hrow
                if not 0 <= p < m:
                    continue
                if kind == "shortcut":
                    if w + 1 <= hrow < w + 1 + rb.TILE_M:
                        v = x[p, chunk * ck:(chunk + 1) * ck]
                        tile[hrow, :v.numel()] = v
                    continue
                item = p // n
                if item not in stats:
                    stats[item] = finish_stats(part, item, n, per, eps)
                c0, c1 = chunk * ck, min((chunk + 1) * ck, cs)
                ch = torch.arange(c0, c1)
                mu, inv = stats[item][ch // per, 0], stats[item][ch // per, 1]
                sc = inv * gs[c0:c1]
                y = src[p, c0:c1] * sc + (gb[c0:c1] - mu * sc)
                tile[hrow, :c1 - c0] = y * torch.sigmoid(y)
            return tile

        for nt in range(plan.n_tiles):
            n0 = nt * rb.TILE_N
            partial = []
            for rank in range(split):
                acc = torch.zeros(rows, rb.TILE_N)
                have = None
                for kind, chunk, tap in plan.units(conv, rank):
                    if have != (kind, chunk):
                        tile, have = halo_tile(kind, chunk), (kind, chunk)
                    dy, dx = tap // 3 - 1, tap % 3 - 1
                    ok = (ph + dy >= 0) & (ph + dy < h) & (pw + dx >= 0) & (pw + dx < w)
                    shifted = torch.arange(rows) + (w + 1) + dy * w + dx
                    a_rows = tile[torch.where(ok, shifted, torch.full_like(shifted, hr))]
                    wk = (wpad[tap, chunk * ck:(chunk + 1) * ck] if kind == "conv"
                          else wspad[chunk * ck:(chunk + 1) * ck])
                    acc = acc + a_rows @ wk[:, n0:n0 + rb.TILE_N]
                partial.append(acc)
            total = partial[0]
            for acc in partial[1:]:  # rank order
                total = total + acc
            cols = min(rb.TILE_N, co - n0)
            out[m0:m0 + rows, n0:n0 + cols] = total[:, :cols]
    return out


def emulate_block(x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs, *, groups, eps=1e-5,
                  use_shortcut=False):
    """The block in fp32 in the kernel's order of work, driven by its plan."""
    b, h, w, cin = x.shape
    cout = w1.shape[-1]
    plan = rb.plan_resnet(b, h, w, cin, cout, torch.float32, groups=groups,
                          use_shortcut=use_shortcut)
    n = h * w
    xm = x.reshape(b * n, cin)
    part1 = tile_partials(xm, plan, n, groups, -(-cin // rb.TILE_N))
    s1 = emulate_conv(plan, 1, xm, part1, n1s, n1b, w1.reshape(9, cin, cout), h, w, groups, eps)
    h1 = s1 + b1 + temb.repeat_interleave(n, dim=0)
    part2 = tile_partials(h1, plan, n, groups, plan.n_tiles, plan.split1)
    assert part1.numel() + part2.numel() == plan.part_floats
    s2 = emulate_conv(plan, 2, h1, part2, n2s, n2b, w2.reshape(9, cout, cout), h, w, groups,
                      eps, x=xm, ws=ws if use_shortcut else None)
    sc = bs if use_shortcut else xm
    return (s2 + b2 + sc).reshape(b, h, w, cout), plan


def block_args(b, side, cin, cout, seed):
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    use_sc = cin != cout
    args = [r(b, side, side, cin), r(b, cout, scale=0.5), 1 + r(cin, scale=0.1),
            r(cin, scale=0.1), r(3, 3, cin, cout, scale=(9 * cin) ** -0.5), r(cout, scale=0.1),
            1 + r(cout, scale=0.1), r(cout, scale=0.1),
            r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), r(cout, scale=0.1)]
    args += [r(cin, cout, scale=cin**-0.5), r(cout, scale=0.1)] if use_sc else [
        torch.zeros(1, 1), torch.zeros(1, 1)]
    return args, use_sc


# (4x4, 40->72) adds two K chunks, two column tiles, and a group (9 channels)
# that straddles the column tiles
EMULATED = [(2, 16, 16), (4, 24, 16), (8, 16, 24), (4, 40, 72)]


@pytest.mark.parametrize("b", [3, 5])
@pytest.mark.parametrize("side,cin,cout", EMULATED)
def test_emulated_order_of_work_matches_plain(side, cin, cout, b):
    """The kernel's order of work gives the plain version's block: 128-row
    tiles that span up to 20 items at 2x2 and 8x8 items cut by a tile
    boundary, a split of K, ragged last tiles.  fp32, summation order only:
    1e-5."""
    args, use_sc = block_args(b, side, cin, cout, seed=side + cin + cout + b)
    with torch.no_grad():
        got, plan = emulate_block(*args, groups=GROUPS, use_shortcut=use_sc)
        want = rb.resnet_block_torch(*args, groups=GROUPS, use_shortcut=use_sc)
    assert plan.split1 > 1 or plan.split2 > 1  # the split is exercised
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_emulated_items_do_not_leak_into_each_other():
    """One 128-row tile holds all three 2x2 items.  With the items in another
    order every item's output stays its own: no tap read a neighbour."""
    args, use_sc = block_args(3, 2, 16, 16, seed=11)
    x = args[0]
    with torch.no_grad():
        want = rb.resnet_block_torch(*args, groups=GROUPS, use_shortcut=use_sc)
        perm = torch.tensor([2, 0, 1])
        args_p = [x[perm], args[1][perm]] + args[2:]
        got_p, _ = emulate_block(*args_p, groups=GROUPS, use_shortcut=use_sc)
    np.testing.assert_allclose(got_p.numpy(), want[perm].numpy(), atol=1e-5)
