"""The single-frame step's order-fixed sums, on the CPU.

``ops/voxelize.segment_sum`` (behind ``segment_mean``, the device
voxelizer's pillar means in ``DynVFE``) sums each segment's rows one after
another in row order (a stable sort by segment, then
``torch.segment_reduce``), where it was a ``scatter_add_``, whose float
atomics sum in an order that changes from run to run on the card. It is
held against JAX's ``segment_sum`` / ``segment_mean`` at the tolerance the
``scatter_add_`` met, against the ``scatter_add_`` bit for bit on
integer-valued rows (where every order gives the same bits), and against
a numpy loop in row order bit for bit (the order both devices take).

``train.trainer.TrainStep`` runs the step's forward and backward with
cuDNN held to its deterministic algorithms and restores the setting.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)
from tmae_tpu.ops import voxelize as jvox
from tmae_tpu_torch.ops import voxelize as tvox
from tmae_tpu_torch.train.optimization import Schedules
from tmae_tpu_torch.train.trainer import make_train_step

# the scatter_add_ this replaces met JAX's segment sums within this
TOL = 1e-6


def scatter_sum(feat, seg, num_segments):
    """The segment sum as a scatter_add_ (the op segment_sum replaced)."""
    B, P, C = feat.shape
    idx = seg.long().clamp(max=num_segments)[..., None].expand(B, P, C)
    acc = feat.new_zeros(B, num_segments + 1, C).scatter_add_(1, idx, feat)
    return acc[:, :num_segments]


def rows(seed, B=2, P=700, C=4, V=53, integers=False):
    rng = np.random.RandomState(seed)
    feat = (rng.randint(-50, 50, (B, P, C)) if integers
            else rng.randn(B, P, C) * 30).astype(np.float32)
    seg = rng.randint(0, V + 3, (B, P)).astype(np.int32)  # >= V: dropped
    seg[0, :40] = 5  # a long segment
    return feat, seg, V


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_segment_sum_and_mean_match_jax(seed):
    feat, seg, V = rows(seed)
    got = tvox.segment_sum(torch.from_numpy(feat), torch.from_numpy(seg), V)
    want = np.asarray(jvox.segment_sum(jnp.asarray(feat), jnp.asarray(seg),
                                       V))
    old = scatter_sum(torch.from_numpy(feat), torch.from_numpy(seg), V)
    scale = np.abs(want).max()
    assert np.abs(old.numpy() - want).max() <= TOL * scale
    assert np.abs(got.numpy() - want).max() <= TOL * scale
    valid = np.random.RandomState(seed + 10).rand(*seg.shape) > 0.2
    got = tvox.segment_mean(torch.from_numpy(feat), torch.from_numpy(seg), V,
                            valid=torch.from_numpy(valid))
    want = np.asarray(jvox.segment_mean(jnp.asarray(feat), jnp.asarray(seg),
                                        V, valid=jnp.asarray(valid)))
    assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize('seed', [0, 1])
def test_segment_sum_equals_scatter_add_on_integers(seed):
    feat, seg, V = rows(seed, integers=True)
    f, s = torch.from_numpy(feat), torch.from_numpy(seg)
    assert torch.equal(tvox.segment_sum(f, s, V), scatter_sum(f, s, V))


def test_segment_sum_adds_in_row_order():
    """Bit for bit a left-to-right f32 sum of each segment's rows in row
    order: the order the card's segment_reduce takes too."""
    feat, seg, V = rows(3, P=400)
    want = np.zeros((feat.shape[0], V, feat.shape[2]), np.float32)
    for b in range(feat.shape[0]):
        for p in range(feat.shape[1]):
            if seg[b, p] < V:
                want[b, seg[b, p]] = want[b, seg[b, p]] + feat[b, p]
    got = tvox.segment_sum(torch.from_numpy(feat), torch.from_numpy(seg), V)
    np.testing.assert_array_equal(got.numpy(), want)


class _Probe(torch.nn.Module):
    """Records cuDNN's deterministic flag in its forward and backward."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(3))
        self.seen = []

    def forward(self, batch):
        self.seen.append(('forward', torch.backends.cudnn.deterministic))
        y = self.w * batch['x']
        y.register_hook(lambda g: self.seen.append(
            ('backward', torch.backends.cudnn.deterministic)))
        return {'y': y, 'occ_overflow': torch.zeros(1)}


def test_train_step_holds_cudnn_deterministic():
    model = _Probe()
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = Schedules(lr=lambda s: 0.1, beta1=None, grad_clip=0.0)
    step = make_train_step(model, lambda out, b: (out['y'].sum(), {}), opt,
                           sched)
    was = torch.backends.cudnn.deterministic
    step({'x': torch.ones(3)})
    assert model.seen == [('forward', True), ('backward', True)]
    assert torch.backends.cudnn.deterministic == was
