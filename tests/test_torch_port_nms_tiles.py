"""The designs of the device NMS kernels (``tmae_tpu_torch/csrc/iou_nms.cu``)
held on the CPU through plain models of their decompositions, kept here:

* ``NMS_SCAN``'s block-wise walk (one warp a sample; rows decided 64 at a
  time, walking only the rows whose diagonal word removes a later row of
  the block, without the caps; a block walked again from the first row
  that a full class would have kept; the kept rows' words ORed into the
  removed words past the block) equals ``nms_scan_plain`` bit for bit, on
  arbitrary masks and on a real one;
* ``NMS_MASK``'s circle skip (``SKIP_ABS``, ``SKIP_REL``) drops only pairs
  whose plain BEV IoU is exactly 0, on random, crowded, touching and
  corner-to-corner boxes at every heading, and never a touching pair;
* ``NMS_MASK``'s tiling (blocks of 16 rows against 64 columns, zero words
  left of the diagonal, the pairs to clip listed from two ballots a row)
  gives ``nms_mask_plain``'s mask, and the ballot halves give
  ``unpack_mask``'s bit order.

Inputs are made from seeds with numpy. The kernels themselves run on the
card only (``chip_smoke.py`` phase 16a holds them against the plain
versions there)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu_torch.ops import geometry as geo

CU = Path(geo.__file__).resolve().parent.parent / 'csrc' / 'iou_nms.cu'
FULL = (1 << 64) - 1
GROUP_ROWS = 16  # the mask kernel's kGroupRows


def class_index(valid, labels, ncls):
    """0-based class a row, -1 where it takes no part."""
    if labels is None:
        return np.where(valid, 0, -1)
    lab = labels.astype(np.int64) - 1
    return np.where(valid & (lab >= 0) & (lab < ncls), lab, -1)


def pack_mask(bools):
    """bool [B, K, K] → int64 words [B, K, ceil(K / 64)], bit j % 64 of
    word j // 64 is column j."""
    B, K, _ = bools.shape
    W = -(-K // 64)
    pad = np.zeros((B, K, W * 64), bool)
    pad[..., :K] = bools
    by = np.packbits(pad.reshape(B, K, W, 64), axis=-1, bitorder='little')
    return torch.from_numpy(
        np.ascontiguousarray(by).view('<u8')[..., 0].view(np.int64))


def words_of(mask):
    """int64 words → nested lists of Python ints in [0, 2^64)."""
    return mask.numpy().view(np.uint64).tolist()


def after(r):
    """Bits of the rows after row r of a 64-row block."""
    return 0 if r >= 63 else (FULL << (r + 1)) & FULL


def walk_block(diag, cand):
    """The kept rows of a 64-row block from its diagonal words, as the warp
    walks them: only the rows whose word removes a later row of the block
    (two ballots in the kernel), in order; a row still a candidate there
    removes the later rows its word names."""
    d = list(diag) + [0] * (64 - len(diag))
    inf = sum(1 << r for r in range(64) if d[r] & after(r))
    x = cand & inf
    while x:
        r = (x & -x).bit_length() - 1
        cand &= ~(d[r] & after(r))
        x = cand & inf & after(r)
    return cand


def nth_bit(x, n):
    for _ in range(n):
        x &= x - 1
    return (x & -x).bit_length() - 1


def scan_blocks_model(mask, valid, labels, posts):
    """``NMS_SCAN``'s walk: for each block of 64 rows, the rows that take
    part, the class lanes' rows and rooms, the removed word of the block
    from the lane that holds it, the decision without caps, again from the
    first row a full class would keep, the counts, then the OR of the kept
    rows' words into the words past the block."""
    B, K = valid.shape
    W = -(-K // 64)
    ncls = len(posts)
    cls = class_index(valid.numpy(), None if labels is None
                      else labels.numpy(), ncls)
    words = words_of(mask)
    keep = np.zeros((B, K), bool)
    for b in range(B):
        removed = [0] * W
        count = [0] * ncls
        for blk in range(W):
            r0, nrows = blk * 64, min(64, K - blk * 64)
            rc = cls[b, r0:r0 + nrows]
            take = sum(1 << r for r in range(nrows) if rc[r] >= 0)
            mine = [sum(1 << r for r in range(nrows) if rc[r] == c)
                    for c in range(ncls)]
            room = [max(posts[c] - count[c], 0) for c in range(ncls)]
            out = 0
            for c in range(ncls):
                if room[c] == 0:
                    out |= mine[c]
            diag = [words[b][r0 + r][blk] for r in range(nrows)]
            while True:
                kept = walk_block(diag, take & ~removed[blk] & ~out & FULL)
                over = [nth_bit(kept & mine[c], room[c]) for c in range(ncls)
                        if bin(kept & mine[c]).count('1') > room[c]]
                if not over:
                    break
                first = min(over)
                out |= mine[int(rc[first])] & (FULL << first) & FULL
            for c in range(ncls):
                count[c] += bin(kept & mine[c]).count('1')
            for r in range(nrows):
                keep[b, r0 + r] = bool(kept >> r & 1)
            for w in range(blk + 1, W):
                for r in range(nrows):
                    if kept >> r & 1:
                        removed[w] |= words[b][r0 + r][w]
    return torch.from_numpy(keep)


def crowded(rng, K, clusters, spread=0.7):
    """K boxes in clusters of heavy overlap over a t_mae.yaml scene, all
    headings (f32 [K, 7])."""
    centres = (rng.rand(clusters, 2) - 0.5) * 140
    c = rng.randint(0, clusters, K)
    boxes = np.concatenate([
        centres[c] + rng.normal(size=(K, 2)) * spread,
        rng.uniform(-1, 1, (K, 1)), rng.uniform(1, 5, (K, 1)),
        rng.uniform(1, 3, (K, 1)), rng.uniform(1, 3, (K, 1)),
        rng.uniform(-math.pi, math.pi, (K, 1))], 1)
    return torch.from_numpy(boxes.astype(np.float32))


def scan_case(K, multi, seed):
    """Two samples of K rows: an arbitrary mask (bits anywhere, classes
    mixed) in sample 0 and, for K = 500, the plain mask of crowded boxes in
    sample 1; about a tenth of the rows invalid and, with classes, labels
    0, 6 and -1 out of range."""
    rng = np.random.RandomState(seed)
    valid = rng.rand(2, K) > 0.1
    labels = None
    if multi:
        labels = np.where(rng.rand(2, K) < 0.85, rng.randint(1, 6, (2, K)),
                          rng.randint(-1, 7, (2, K))).astype(np.int32)
    p = min(0.3, 6.0 / K) if K > 1 else 0.5
    sup = rng.rand(2, K, K) < p
    if K == 500:
        boxes = crowded(rng, K, 25)
        lab = None if labels is None else torch.from_numpy(labels[1:])
        th = [0.1] * (5 if multi else 1)
        sup[1] = geo.nms_mask_plain(boxes[None], torch.from_numpy(valid[1:]),
                                    lab, th)[0].numpy()
    return (pack_mask(sup), torch.from_numpy(valid),
            None if labels is None else torch.from_numpy(labels))


@pytest.mark.parametrize('K', [1, 63, 64, 65, 500, 2100])
@pytest.mark.parametrize('caps', [[0], [1], [3], [10 ** 6],
                                  [0, 1, 3, 10 ** 6, 3]],
                         ids=['one-0', 'one-1', 'one-3', 'one-large',
                              'five'])
def test_block_scan_equals_plain_scan(K, caps):
    """The block-wise walk keeps what ``nms_scan_plain`` keeps, bit for
    bit: one class with caps 0, 1, 3 and large; five classes with caps
    {0, 1, 3, large, 3}; invalid rows and out-of-range labels."""
    mask, valid, labels = scan_case(K, len(caps) > 1, seed=K + len(caps))
    want = geo.nms_scan_plain(geo.unpack_mask(mask, K), valid, labels, caps)
    got = scan_blocks_model(mask, valid, labels, caps)
    assert torch.equal(got, want)
    if K >= 64 and caps[-1] > 1:
        assert 0 < int(want.sum()) < int(valid.sum())  # suppression acted


def test_block_scan_caps_cut_inside_a_block():
    """A class that fills in the middle of a block: its later rows are not
    kept and remove nothing, so rows they would have removed are kept."""
    K = 64
    sup = np.zeros((1, K, K), bool)
    sup[0, 2, 3] = True   # row 2 (class 1, beyond the cap) would remove 3
    sup[0, 0, 5] = True   # row 0 (kept) removes 5
    labels = np.ones((1, K), np.int32)
    labels[0, 3] = 2
    mask, valid = pack_mask(sup), torch.ones(1, K, dtype=torch.bool)
    lab = torch.from_numpy(labels)
    want = geo.nms_scan_plain(torch.from_numpy(sup), valid, lab, [2, 10])
    got = scan_blocks_model(mask, valid, lab, [2, 10])
    assert torch.equal(got, want)
    assert want[0, :4].tolist() == [True, True, False, True]


def apart(a, b):
    """The mask kernel's circle test in f32, operation for operation: the
    centre distance squared against (r_a + r_b + margin)^2."""
    ra = 0.5 * torch.sqrt(a[:, 3] * a[:, 3] + a[:, 4] * a[:, 4])
    rb = 0.5 * torch.sqrt(b[:, 3] * b[:, 3] + b[:, 4] * b[:, 4])
    dx, dy = a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]
    scale = a[:, 0].abs() + a[:, 1].abs() + b[:, 0].abs() + b[:, 1].abs() \
        + ra + rb
    reach = ra + rb + np.float32(geo.SKIP_ABS) + np.float32(geo.SKIP_REL) \
        * scale
    return dx * dx + dy * dy > reach * reach


def pairs_of(boxes):
    i, j = torch.triu_indices(len(boxes), len(boxes), 1)
    return boxes[i], boxes[j]


def touching(rng, n):
    """Pairs of boxes that share an edge or a corner: box b is box a moved
    by its length, its width or both along its own axes, at any heading
    and anywhere in the scene; b has a's size or a smaller one."""
    a = np.concatenate([
        (rng.rand(n, 2) - 0.5) * 150, rng.uniform(-1, 1, (n, 1)),
        rng.uniform(0.5, 12, (n, 2)), rng.uniform(1, 3, (n, 1)),
        rng.uniform(-math.pi, math.pi, (n, 1))], 1)
    step = np.stack([[1, 0], [0, 1], [1, 1], [-1, 0], [0, -1]])[
        rng.randint(0, 5, n)]
    c, s = np.cos(a[:, 6]), np.sin(a[:, 6])
    lx, ly = step[:, 0] * a[:, 3], step[:, 1] * a[:, 4]
    b = a.copy()
    b[:, 0] += lx * c - ly * s
    b[:, 1] += lx * s + ly * c
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def corner_to_corner(rng, n, outside):
    """Pairs whose corners point at each other along the line of centres,
    centred up to 100 m out: with ``outside``, the circles 1.01 times the
    kernel's largest margin for the pair apart (the closest pairs the test
    drops); else half of ``SKIP_ABS`` apart (inside every margin)."""
    a = np.zeros((n, 7))
    a[:, :2] = (rng.rand(n, 2) - 0.5) * 200
    a[:, 3:5] = rng.uniform(0.5, 12, (n, 2))
    a[:, 5] = 2
    phi = rng.uniform(-math.pi, math.pi, n)  # direction from a to b
    # a's corner (dx/2, dy/2) points along phi
    a[:, 6] = phi - np.arctan2(a[:, 4], a[:, 3])
    b = a.copy()
    b[:, 3:5] = rng.uniform(0.5, 12, (n, 2))
    b[:, 6] = phi + math.pi - np.arctan2(b[:, 4], b[:, 3])
    ra, rb = 0.5 * np.hypot(a[:, 3], a[:, 4]), 0.5 * np.hypot(b[:, 3], b[:, 4])
    # an upper bound of the kernel's coordinate scale for the pair
    scale = 2 * np.abs(a[:, :2]).sum(1) + 4 * (ra + rb) + 10
    dist = ra + rb + (1.01 * (geo.SKIP_ABS + geo.SKIP_REL * scale)
                      if outside else 0.5 * geo.SKIP_ABS)
    b[:, 0] = a[:, 0] + dist * np.cos(phi)
    b[:, 1] = a[:, 1] + dist * np.sin(phi)
    return (torch.from_numpy(a.astype(np.float32)),
            torch.from_numpy(b.astype(np.float32)))


def test_circle_skip_drops_only_pairs_of_iou_zero():
    """Every pair the circle test drops has plain BEV IoU exactly 0 (and
    exactly 0 intersection), on random boxes over the scene, on crowded
    clusters and on corner-to-corner pairs just past the margin; touching
    pairs (an edge or a corner in common) are never dropped."""
    rng = np.random.RandomState(0)
    spread = np.concatenate([
        (rng.rand(400, 2) - 0.5) * 150, rng.uniform(-1, 1, (400, 1)),
        rng.uniform(0.3, 15, (400, 3)),
        rng.uniform(-math.pi, math.pi, (400, 1))], 1).astype(np.float32)
    sets = {'random': pairs_of(torch.from_numpy(spread)),
            'crowded': pairs_of(crowded(rng, 400, 12, spread=2.0)),
            'corner to corner': corner_to_corner(rng, 20000, True)}
    for what, (a, b) in sets.items():
        drop = apart(a, b)
        assert int(drop.sum()) > 0, what
        inter = geo.sh_intersection_area_flat(a[drop], b[drop])
        area_a, area_b = a[drop, 3] * a[drop, 4], b[drop, 3] * b[drop, 4]
        iou = inter / (area_a + area_b - inter).clamp(min=1e-6)
        assert bool((inter == 0).all()) and bool((iou == 0).all()), what
        if what == 'crowded':
            assert int((~drop).sum()) > 1000  # clusters: many pairs clipped
    a, b = touching(rng, 20000)
    assert not bool(apart(a, b).any())
    assert not bool(apart(b, a).any())
    a, b = corner_to_corner(rng, 2000, False)  # inside the margin
    assert not bool(apart(a, b).any())


def test_skip_margin_and_limits_match_the_kernel():
    """``SKIP_ABS``, ``SKIP_REL``, ``SCAN_MAX_K`` and the mask's 16-row
    groups are the kernel's constants."""
    src = CU.read_text()
    const = lambda name: re.search(
        rf'constexpr (?:int|float) {name} = ([^;]+);', src).group(1)
    assert float(const('kSkipAbs').rstrip('f')) == geo.SKIP_ABS
    assert float(const('kSkipRel').rstrip('f')) == geo.SKIP_REL
    assert eval(const('kScanMaxK')) == geo.SCAN_MAX_K
    assert int(const('kGroupRows')) == GROUP_ROWS
    assert int(const('kTile')) == 64


def mask_blocks_model(boxes, valid, labels, threshs):
    """``NMS_MASK``'s grid: for block (column tile ct, group g of row tile
    rt) the zero words left of the diagonal, else the pairs of rows
    64 rt + 16 g + r (warp r // 2) and columns 64 ct + c (lane c % 32,
    ballot c // 32) that need a clip, listed at the positions the ballots
    give (each slot once), clipped with the plain IoU, ORed into the row's
    word. Returns the packed mask and the number of pairs clipped."""
    B, K = valid.shape
    T = -(-K // 64)
    ncls = len(threshs)
    cls = class_index(valid.numpy(), None if labels is None
                      else labels.numpy(), ncls)
    out = np.zeros((B, K, T), np.uint64)
    clipped = 0
    lanes = np.arange(32)
    for b in range(B):
        bx = boxes[b, :, :7]
        # the plain IoU of every pair, as nms_mask_plain computes it (the
        # CPU's cos and sin may differ by an ulp with the element's place)
        iou_all = geo.boxes_iou_bev_plain(bx, bx)
        for rt in range(T):
            for g in range(64 // GROUP_ROWS):
                row0 = rt * 64 + g * GROUP_ROWS
                if row0 >= K:
                    continue
                rows = np.arange(row0, min(row0 + GROUP_ROWS, K))
                for ct in range(rt, T):
                    items = {}
                    at = 0
                    for r, i in enumerate(rows):
                        ci = cls[b, i]
                        need = []
                        for half in range(2):
                            j = ct * 64 + 32 * half + lanes
                            ok = (ci >= 0) & (j > i) & (j < K)
                            jj = np.minimum(j, K - 1)
                            ok &= cls[b, jj] == ci
                            if ci >= 0 and threshs[ci] >= 0:
                                far = apart(bx[torch.full((32,), int(i))],
                                            bx[torch.from_numpy(jj)]).numpy()
                                ok &= ~far
                            need.append(ok)
                        lo, hi = need
                        pos_lo = at + np.cumsum(lo) - lo
                        pos_hi = at + lo.sum() + np.cumsum(hi) - hi
                        for half, pos, ok in ((0, pos_lo, lo),
                                              (1, pos_hi, hi)):
                            for lane in lanes[ok]:
                                assert pos[lane] not in items
                                items[pos[lane]] = (r, 32 * half + lane)
                        at += int(lo.sum() + hi.sum())
                    assert sorted(items) == list(range(at))
                    if not items:
                        continue
                    rr = torch.tensor([rows[r] for r, _ in items.values()])
                    cc = torch.tensor([ct * 64 + c for _, c in items.values()])
                    iou = iou_all[rr, cc]
                    th = torch.tensor(
                        [threshs[cls[b, i]] for i in rr.tolist()],
                        dtype=torch.float32)
                    clipped += len(items)
                    for (i, j), hit in zip(zip(rr.tolist(), cc.tolist()),
                                           (iou > th).tolist()):
                        if hit:
                            out[b, i, ct] |= np.uint64(1) << np.uint64(j % 64)
    return torch.from_numpy(out.view(np.int64)), clipped


@pytest.mark.parametrize('K,multi', [(1, False), (77, False), (77, True),
                                     (130, True)])
def test_mask_tiling_and_ballot_words_equal_plain_mask(K, multi):
    """The tiled, skipping mask equals ``nms_mask_plain`` packed in
    ``unpack_mask``'s order, bit for bit, with fewer pairs clipped than
    the upper triangle holds."""
    rng = np.random.RandomState(K)
    boxes = torch.stack([crowded(rng, K, max(1, K // 12), spread=1.5)
                         for _ in range(2)])
    valid = torch.from_numpy(rng.rand(2, K) > 0.1)
    labels = (torch.from_numpy(rng.randint(0, 7, (2, K)).astype(np.int32))
              if multi else None)
    threshs = [0.1, 0.3, 0.0, 0.5, 0.2] if multi else [0.1]
    got, clipped = mask_blocks_model(boxes, valid, labels, threshs)
    want = geo.nms_mask_plain(boxes, valid, labels, threshs)
    assert torch.equal(geo.unpack_mask(got, K), want)
    assert torch.equal(got, pack_mask(want.numpy()))
    if K > 1:
        assert int(want.sum()) > 0 and clipped < 2 * K * (K - 1) // 2
