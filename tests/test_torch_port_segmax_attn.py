"""The premises of two kernels of the PyTorch port (tmae_tpu_torch), held
on the CPU through their plain versions against the JAX package:

- K5 (``csrc/segment_max.cu``) splits the sorted rows into slices of
  ``SLICE_ROWS`` rows, one warp each, and merges the pillars that span
  slices in a second pass. ``_slices_plain`` models that decomposition in
  torch ops; it must equal the plain version and JAX's
  ``sorted_segment_max`` in interpret mode bit for bit (a max is exact) on
  skewed pillars.
- K16 (the attention-only mode of ``csrc/encoder_layer_tiled.cu``) writes
  ``bo`` on the windows without a key and runs the others on the tiled
  kernel, from four weight panels its launcher packs."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_kernels import _bf16_np, _t
from tests.test_torch_port_sparse_attn import _attn_inputs, _tb
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import pallas_attn as jpa
from tmae_tpu.ops import sorted_segments as jss
from tmae_tpu_torch.ops import encoder_layer as tel
from tmae_tpu_torch.ops import sorted_segments as tss
from tmae_tpu_torch.ops import window_attention as twa

CSRC = Path(tss.__file__).resolve().parent.parent / 'csrc'
R = tss.SLICE_ROWS


def _slices_plain(feat, seg, seg_ends, seg_mask, num_segments: int,
                  rows: int = R):
    """Plain model of K5's decomposition, slice by slice in torch ops:
    pass 1 takes the segmented max of each slice of ``rows`` rows (valid
    rows only: slots below ``num_segments``), stores a segment that begins
    and ends in the slice (if present), and keeps the max of the slice's
    first segment when it began in an earlier slice (head) and of its last
    one when it began here and goes on (tail); pass 2 gives an absent
    pillar 0 and a present one whose rows (``seg_ends``) lie in slices sf <
    sl max(tail[sf], head[sf + 1 .. sl]). An element neither pass writes
    stays NaN, so a gap in the decomposition shows."""
    B, Pn, C = feat.shape
    V = num_segments
    ns = -(-Pn // rows)
    out = feat.new_full((B, V, C), float('nan'))
    part = feat.new_full((B, ns, 2, C), float('nan'))
    for b in range(B):
        sg = [int(v) for v in seg[b]]
        for s in range(ns):
            r0, r1 = s * rows, min(s * rows + rows, Pn)
            n = sum(v < V for v in sg[r0:r1])
            if n == 0:
                continue
            before = sg[r0 - 1] if r0 > 0 else -1
            after = sg[r0 + n] if r0 + n < Pn else V
            i = 0
            while i < n:
                cur = sg[r0 + i]
                j = i
                while j + 1 < n and sg[r0 + j + 1] == cur:
                    j += 1
                m = feat[b, r0 + i:r0 + j + 1].amax(0)
                began_here = i > 0 or cur != before
                ends_here = j + 1 < n or cur != after
                if not began_here:
                    part[b, s, 0] = m
                elif not ends_here:
                    part[b, s, 1] = m
                elif seg_mask[b, cur]:
                    out[b, cur] = m
                i = j + 1
        for v in range(V):
            if not seg_mask[b, v]:
                out[b, v] = 0.0
                continue
            last = int(seg_ends[b, v])
            first = 0 if v == 0 else int(seg_ends[b, v - 1]) + 1
            sf, sl = first // rows, last // rows
            if sf != sl:
                out[b, v] = torch.cat([part[b, sf, 1:2],
                                       part[b, sf + 1:sl + 1, 0]]).amax(0)
    return out

# ---------------------------------------------------------------------------
# K5: row slices and the merge of the pillars that span them
# ---------------------------------------------------------------------------

# pillar sizes in row order, each case with absent slots after the present
# ones and out-of-range rows after the last pillar
K5_LAYOUTS = {
    # a 551-row pillar over nine slices, then a boundary on a slice edge
    # (rows 551 + 41 = 592 ... 640 = 10 slices) and small pillars
    'long pillar': [551, 41, 48, 1, 3, 130, 2, 64, 64, 5],
    # every segment ends on a slice edge; one covers exactly one slice
    'slice edges': [R, 2 * R, R - 1, 1, 3 * R, R // 2, R // 2, 7],
    # the skew of a served frame: median 3, a few of a hundred and more
    'skewed': None,
}


def _k5_case(layout, seed, negative):
    """B = 2 batch rows of P = 2048 sorted rows, V = 320 slots, C = 8:
    ``layout``'s pillars (or random skewed sizes), slot V on the rows after
    them; with ``negative`` every value of batch row 1 is below 0."""
    rng = np.random.RandomState(seed)
    B, Pn, V, C = 2, 2048, 320, 8
    feat = rng.normal(0, 1, (B, Pn, C)).astype(np.float32)
    if negative:
        feat[1] = -np.abs(feat[1]) - 0.5
    seg = np.full((B, Pn), V, np.int32)
    ends = np.zeros((B, V), np.int32)
    mask = np.zeros((B, V), bool)
    for b in range(B):
        sizes = (K5_LAYOUTS[layout] if K5_LAYOUTS[layout] is not None
                 else np.minimum(rng.geometric(0.2, 300), 200))
        sizes = list(sizes)
        if layout == 'skewed':
            sizes[3] = 551
        r, v = 0, 0
        for n in sizes:
            if r + n > Pn - 13 or v == V - 40:   # rows and slots left over
                break
            seg[b, r:r + n] = v
            ends[b, v] = r + n - 1
            mask[b, v] = True
            r, v = r + n, v + 1
    return feat, seg, ends, mask, V


@pytest.mark.parametrize('layout', sorted(K5_LAYOUTS))
@pytest.mark.parametrize('negative', [False, True])
def test_k5_slices_equal_plain_and_jax(layout, negative):
    """The slice decomposition (pass 1 per slice, pass 2 per spanning
    pillar; NaN where neither writes) equals the plain version and JAX's
    ``sorted_segment_max`` in interpret mode (block 1024) bit for bit, at
    B = 2 with absent slots and out-of-range rows; the case holds a pillar
    over three or more slices and a segment that ends on a slice edge."""
    feat, seg, ends, mask, V = _k5_case(layout, 3 + int(negative), negative)
    first = np.concatenate([[0], ends[0, :-1] + 1])
    spans = (ends[0] // R - first // R)[mask[0]]
    assert spans.max() >= 2, 'no pillar over three or more slices'
    assert ((ends[0][mask[0]] + 1) % R == 0).any(), 'no edge on a slice edge'
    assert (~mask).any() and (seg == V).any()
    args = (_t(feat), _t(seg), _t(ends), _t(mask), V)
    got = _slices_plain(*args)
    assert not torch.isnan(got).any(), 'an element neither pass writes'
    want = tss.sorted_segment_max_plain(*args)
    assert torch.equal(got, want)
    try:
        jss.set_interpret(True)
        jwant = np.asarray(jss.sorted_segment_max(
            jnp.asarray(feat), jnp.asarray(seg), jnp.asarray(ends),
            jnp.asarray(mask), V))
    finally:
        jss.set_interpret(False)
    np.testing.assert_array_equal(got.numpy(), jwant)
    if negative:
        assert (got[1][mask[1]] < 0).all()


def test_k5_slice_rows_match_the_kernel():
    """The plain model slices as the kernel does: ``SLICE_ROWS`` is the
    kernel's ``kSlice``, and the wrapper counts one call however many
    launches it makes (one ``CudaKernel``)."""
    src = (CSRC / 'segment_max.cu').read_text()
    k = re.search(r'constexpr int kSlice = (\d+);', src)
    assert k and int(k.group(1)) == R
    assert tss.K5.symbol == 'launch_sorted_segment_max'


# ---------------------------------------------------------------------------
# K16: bo on the windows without a key, the tiles on the others, the panels
# ---------------------------------------------------------------------------


def _key_windows_plain(kmask):
    """Plain version of K16's pre-pass and compaction: the windows with a
    key, in window order, from ``kmask`` [N, 64]."""
    return (kmask > 0).any(-1).nonzero()[:, 0]


def _reference_forward_live(xw, kvw, kmask, pos, wq, bq, wk, bk, wv, bv, wo,
                            bo, tau, nhead, tau_min, cross):
    """K16's split in plain torch ops: ``reference_forward`` on the windows
    with a key alone (the kernel's tiles), ``bo`` in ``xw``'s dtype on
    every token of the others (its writer warp)."""
    live = _key_windows_plain(kmask)
    out = bo.to(xw.dtype).expand(xw.shape).clone()
    pick = lambda t: t[live]
    out[live] = twa.reference_forward(
        pick(xw), pick(kvw) if cross else None, pick(kmask), pos, wq, bq, wk,
        bk, wv, bv, wo, bo, tau, nhead, tau_min, cross)
    return out


def _attn_args(cross, N=8, C=128, seed=60):
    rng = np.random.RandomState(seed + int(cross))
    xw, kvw, kmask, pos, weights = _attn_inputs(rng, N, C)
    kmask[5] = 0.0                  # a second window without a key
    return ([_tb(xw), _tb(kvw), _t(kmask), _tb(pos)]
            + [_t(w) for w in weights], (xw, kvw, kmask, pos, weights))


@pytest.mark.parametrize('cross', [False, True])
def test_k16_jax_gives_bo_without_a_key(cross):
    """JAX's K16 (``_pallas_forward`` in interpret mode, C=128, 8 heads)
    gives exactly bf16(bo) on every token of a window with no key: the
    function the pre-pass writes."""
    _, (xw, kvw, kmask, pos, weights) = _attn_args(cross)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    jargs = [jb(xw), jb(kvw), jnp.asarray(kmask), jb(pos)] + \
        [jnp.asarray(w) for w in weights]
    try:
        jpa.set_interpret(True)
        out = np.asarray(jpa._pallas_forward(*jargs, 8, 0.01, cross),
                         np.float32)
    finally:
        jpa.set_interpret(False)
    keyless = ~(kmask > 0).any(-1)
    assert keyless.sum() == 2
    bo = _bf16_np(weights[7])
    np.testing.assert_array_equal(
        out[keyless], np.broadcast_to(bo, (int(keyless.sum()), 64, 128)))
    assert not (out[~keyless] == bo).all(-1).all(-1).any()


@pytest.mark.parametrize('cross', [False, True])
def test_k16_plain_on_key_windows_equals_all_windows(cross):
    """The plain K16 run on the windows with a key alone, bo on the others
    (the kernel's split), equals the plain K16 on all windows bit for
    bit."""
    targs, _ = _attn_args(cross)
    cfg = (8, 0.01, cross)
    want = twa.reference_forward(*targs, *cfg)
    got = _reference_forward_live(*targs, *cfg)
    assert torch.equal(got, want)
    live = _key_windows_plain(targs[2])
    assert live.tolist() == [i for i in range(8) if i not in (2, 5)]


def _panel_offset(C, m, i, o):
    """Where the pack puts element [i, o] of matrix m (q, k, v, o = 0..3)
    of a JAX-layout weight [C_in, C_out], written out from the tiled
    kernel's panel layout: panels of 128 outputs x 64 inputs (8192 bf16),
    pass by pass along the output, the input's panels within a pass; in a
    panel, 8 x 8 core matrices of 64 values, the outputs' groups of 8
    apart by 8 core matrices, the inputs' by one; in a core matrix, row =
    output, 8 inputs a row."""
    per_pass = C // 64
    panel = m * (C // 128) * per_pass + (o // 128) * per_pass + i // 64
    core = ((o % 128) // 8) * 8 + (i % 64) // 8
    return panel * 8192 + core * 64 + (o % 8) * 8 + i % 8


# (C, matrix, input i, output o) -> flat offset, by hand from the layout
PANEL_OFFSETS = {(128, 0, 0, 0): 0, (128, 0, 1, 0): 1, (128, 0, 0, 1): 8,
                 (128, 0, 8, 0): 64, (128, 0, 0, 8): 512,
                 (128, 0, 64, 0): 8192, (128, 2, 70, 9): 41486,
                 (128, 3, 127, 127): 65535, (256, 1, 200, 130): 122960,
                 (256, 3, 255, 255): 262143}


@pytest.mark.parametrize('C', [128, 256])
def test_k16_panels_are_the_layer_pack(C):
    """The four panels K16's launcher packs, from what its wrapper hands it
    (``_panel_mats``: [in, out] tensors whose transposes, [out, in], are
    contiguous) for JAX-layout weights [C_in, C_out] (copied), for the
    transposed views of Linear weights as DenseWindowAttention passes them
    (no copy) and for a mix of bf16 and f32 (all f32): each element of the
    plain panels at the offset the layout gives (``_panel_offset``, pinned
    by hand-computed offsets), and the first 4 C^2 values of
    ``pack_panels_plain`` for a layer with those weights."""
    for (c, m, i, o), off in PANEL_OFFSETS.items():
        assert _panel_offset(c, m, i, o) == off
    rng = np.random.RandomState(C)
    lin = lambda o, i: torch.tensor(rng.normal(size=(o, i)).astype(
        np.float32))
    vec = lambda n: torch.zeros(n)
    mats = [lin(C, C) for _ in range(4)]       # Linear weights [out, in]
    p = tel.LayerParams(mats[0], vec(C), mats[1], vec(C), mats[2], vec(C),
                        mats[3], vec(C), vec(1), vec(C), vec(C),
                        lin(2 * C, C), vec(2 * C), lin(C, 2 * C), vec(C),
                        vec(C), vec(C))
    jax_layout = [w.t().contiguous() for w in mats]     # [C_in, C_out]
    mixed = [jax_layout[0].to(torch.bfloat16)] + jax_layout[1:]
    want = tel.pack_panels_plain(p)[:4 * C * C]
    i, o = np.meshgrid(np.arange(C), np.arange(C), indexing='ij')
    for ws, f32 in ((jax_layout, True), ([w.t() for w in mats], True),
                    (mixed, True),
                    ([w.to(torch.bfloat16) for w in jax_layout], False)):
        got_mats, got_f32 = twa._panel_mats(*ws)
        assert got_f32 == f32
        for w, g in zip(ws, got_mats):
            assert g.t().is_contiguous()   # the [out, in] rows it reads
            assert g.dtype == (torch.float32 if f32 else torch.bfloat16)
            assert torch.equal(g.to(torch.bfloat16), w.to(torch.bfloat16))
        panels = tel.panels_plain([g.t() for g in got_mats])
        assert torch.equal(panels, want)
        for m, w in enumerate(ws):
            off = torch.tensor(_panel_offset(C, m, i, o))
            assert torch.equal(panels[off], w.to(torch.bfloat16))
